"""Pairwise map joining: the exactly-linear least-squares fusion.

Counterpart of `linearsfm_tpu/core/join.py` (`JoinConfig`,
`_match_features`, `join_stereo`, `join_mono`). Given `end` already
re-expressed in `cur`'s gauge, stack the two information forms and solve
once: ``x* = (I_end + I_cur)^{-1} (I_end x_end + I_cur x_cur)``. Every lane
of the lane-stacked inputs is one independent pair.

Two solves, as in the reference, chosen for both joins by `_solve`: method
"refine" (stereo, and mono with pin "sign") is `schur.solve_full_mixed`,
the f32 Schur factor preconditioning an f64 PCG on the full system; every
other combination ("direct", and mono "refine" with pin "zero") forms the
reduced system in the information dtype (`schur.inv3x3_wy`,
`schur.assemble_schur`) and solves it with `solve.solve_reduced` — a plain
Cholesky, or for "refine" an f32 factor with refinement sweeps — then
back-substitutes the features.
Both assemble grouped or dense as `cfg.max_obs` / `cfg.dense_schur` say.
With `cfg.mesh` (one-lane joins: the root levels) they run with the
feature axis sharded over the mesh, as the reference routes them:
`shard_solve.sharded_full_mixed` for the PCG, `sharded_schur_solve` for
the rest.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import types
from ..ops import schur, segment, solve
from ..ops.rotations import wrap_angle_diff, wrap_angle_pi
from ..ops.segment import put1, seg_sum, take1
from ..parallel import shard_solve
from ..utils import metrics


class JoinConfig(NamedTuple):
    """The reference's join configuration: its fields in its order, with
    its defaults (the exact direct solve, grouped Schur assembly)."""

    # max W entries per feature in the grouped Schur assembly
    # (ops/schur.assemble_schur; the host executor counts it exactly)
    max_obs: int = 8
    # "direct" (Cholesky of the reduced system) | "refine" (stereo, mono
    # pin "sign": the f32-preconditioned f64 PCG)
    method: str = "direct"
    refine_iters: int = 3
    # feature-sharded solve over a `parallel/mesh.Mesh` (single-pair joins:
    # the root levels); None = the single-device solve. mesh_axis names the
    # mesh's axis, as the reference's configuration does.
    mesh: object | None = None
    mesh_axis: str = "fs"
    # Mono scale pin. "sign": condition the solve on the pinned coordinate's
    # value (E -= S[:, fix] * sign), exact constrained fusion. "zero": drop
    # the column as the reference C++ solver does, exact only when the
    # pinned coordinate carries no information coupling.
    pin: str = "sign"
    # assemble the Schur system dense whatever its size (the device tree:
    # it keeps no per-level max_obs)
    dense_schur: bool = False
    # information-path dtype: a torch dtype or its name ("float32",
    # "float64"), None = inherit; the solved state keeps the state dtype
    info_dtype: torch.dtype | str | None = None
    # method="refine" convergence control, see ops/schur.solve_full_mixed:
    # with_res returns (map, res_rel [P]); escalate_iters > 0 runs that many
    # more sweeps on lanes with res_rel > escalate_tol; exit_tol > 0 makes
    # refine_iters a cap with a per-lane early exit.
    with_res: bool = False
    escalate_iters: int = 0
    escalate_tol: float = 1e-8
    exit_tol: float = 0.0


def _match_features(end_ids, end_valid, cur_ids, cur_valid, n1, out_cap):
    """Joint slot of every `cur` feature, per lane.

    Matched features map to the `end` slot holding the same id; new ones are
    appended from slot n1 (the count of valid end features, contiguous at the
    front) in `cur` order; padding maps to `out_cap` (dropped by scatters).
    Returns (joint [P, N2], matched [P, N2]).
    """
    big = torch.iinfo(torch.int32).max
    key = torch.where(end_valid, end_ids, big)
    sorted_ids, order = torch.sort(key, dim=1, stable=True)
    pos = torch.searchsorted(sorted_ids, cur_ids)          # left side
    pos_c = torch.clamp(pos, 0, end_ids.shape[1] - 1)
    hit = (sorted_ids.gather(1, pos_c) == cur_ids) & cur_valid
    end_slot = order.gather(1, pos_c)
    new = cur_valid & ~hit
    new_rank = torch.cumsum(new.to(torch.int64), dim=1) - 1
    joint = torch.where(hit, end_slot,
                        n1[:, None] + torch.where(new, new_rank, 0))
    joint = torch.where(cur_valid, joint, out_cap)
    return joint, hit


def _solve(cfg: JoinConfig, U, Uij, W, Wpf, V, eP, eF, Mo: int, fixed,
           fixc=None, sign=None):
    """(x_p, x_f, res [P]) of the stacked system: both joins' one choice of
    solver for (mesh, method, pin); fixc/sign [P] is the mono scale pin
    (None for stereo, which has none). "refine", unless pinned by "zero",
    is the full-system PCG; the rest solve the reduced system and return a
    NaN residual."""
    pinned = fixc is not None
    if (cfg.method not in ("refine", "direct")
            or pinned and cfg.pin not in ("sign", "zero")):
        raise ValueError(f"no join solve for method={cfg.method!r}"
                         + f", pin={cfg.pin!r}" * pinned)
    P = eP.shape[0]
    if cfg.method == "refine" and not (pinned and cfg.pin == "zero"):
        kw = dict(iters=cfg.refine_iters, escalate_iters=cfg.escalate_iters,
                  escalate_tol=cfg.escalate_tol, exit_tol=cfg.exit_tol,
                  **(dict(fixc=fixc, sign=sign) if pinned else {}))
        if cfg.mesh is None:
            return schur.solve_full_mixed(
                U, Uij, W, Wpf, V, eP, eF, Mo, fixed, max_obs=cfg.max_obs,
                force_dense=cfg.dense_schur, **kw)
        # the production accuracy: the feature-sharded full-system PCG
        return shard_solve.sharded_full_mixed(
            U, Uij, W, Wpf, V, eP, eF, Mo, fixed, mesh=cfg.mesh,
            axis=cfg.mesh_axis, **kw)
    early = pinned and cfg.pin == "sign" and cfg.mesh is None
    if cfg.mesh is not None:
        # as the reference: with gauge-conditioned inputs the pinned
        # coordinate carries no information, so the right-hand side needs
        # no correction; the pin is written back after the
        # back-substitution
        xp, xf = shard_solve.sharded_schur_solve(
            U, Uij, W, Wpf, V, eP, eF, Mo, cfg.max_obs, cfg.mesh,
            axis=cfg.mesh_axis, fixed_mask=fixed, method=cfg.method,
            refine_iters=cfg.refine_iters)
    else:
        # direct, or refine with pin "zero" (the reduced system's f32
        # factor with refinement sweeps, as the reference): the reduced
        # system in the information dtype from one K2 launch (Vinv and
        # Y = W Vinv[wf]) and `schur.assemble_schur`
        Vinv, Yb = schur.inv3x3_wy(V, W, Wpf)
        S, E = schur.assemble_schur(U, Uij, W, Wpf, Yb, eP, eF, Mo,
                                    cfg.max_obs, force_dense=cfg.dense_schur)
        if early:
            E = E - S[torch.arange(P, device=eP.device), :, fixc] * sign[:, None]
        xp = solve.solve_reduced(S, E, fixed_mask=fixed, method=cfg.method,
                                 refine_iters=cfg.refine_iters
                                 ).reshape(P, Mo, 6)
        if early:
            # exact constrained fusion: back-substitute with the pinned
            # coordinate at its value
            xp = schur.pin_coordinate(xp, fixc, sign)
        xf = schur.backsub_features(W, Wpf, Vinv, eF, xp)
    if pinned and not early:
        # pin "zero" (the reference C++ order) and the mesh: back-substituted
        # with the pinned coordinate at 0, set to sign afterwards
        xp = schur.pin_coordinate(xp, fixc, sign)
    return xp, xf, eP.new_full((P,), torch.nan)


def _fuse(end, cur, cfg: JoinConfig, blocks, poses, slot2, place_eP,
          pose_ids2, fixed, n_poses, gauge, fixc=None, sign=None):
    """Both joins' fusion after the datatype's pose mapping: match the
    features, stack the lists and the information vectors, solve
    (`_solve`), build the joint map. blocks: (endU, endW, curU, curW) in the
    information dtype; poses: the (end, cur) states for the information
    vectors; slot2(s) maps cur's pose slots s to joint ones;
    place_eP(eP1, eP2) -> the joint eP; fixed [P, 6Mo] and fixc/sign: the
    solve's gauge mask and mono pin; the rest are the joint map's."""
    P = end.poses.shape[0]
    N1, No, Mo = end.N, end.N + cur.N, end.M + cur.M
    dev = end.poses.device
    endU, endW, curU, curW = blocks
    endV, curV = end.V.to(endU.dtype), cur.V.to(endU.dtype)

    joint2, matched = _match_features(end.feat_ids, end.feat_mask(),
                                      cur.feat_ids, cur.feat_mask(),
                                      end.n_feats, No)
    joint2g = torch.clamp(joint2, 0, No - 1)   # gather-safe (pads hit zero blocks)
    feat_ids = torch.full((P, No + 1), -1, dtype=types.INDEX, device=dev)
    feat_ids[:, :N1] = end.feat_ids
    feat_ids.scatter_(1, joint2, cur.feat_ids)    # slot No is the drop slot

    U = torch.cat([endU, curU], dim=1)
    Uij = torch.cat([end.Uij, slot2(cur.Uij)], dim=1)
    W = torch.cat([endW, curW], dim=1)
    Wpf2 = torch.stack([slot2(cur.Wpf[..., 0]),
                        joint2g.gather(1, cur.Wpf[..., 1])], dim=-1)
    Wpf = torch.cat([end.Wpf, Wpf2], dim=1)
    V = seg_sum(curV, joint2, No)
    V[:, :N1] += endV

    # ---- information vectors e = I x per map -----------------------------
    eP1, eF1 = schur.info_vector(poses[0], end.feats, endU, end.Uij, endW,
                                 end.Wpf, endV)
    eP2, eF2 = schur.info_vector(poses[1], cur.feats, curU, cur.Uij, curW,
                                 cur.Wpf, curV)
    eP = place_eP(eP1, eP2)
    eF = seg_sum(eF2, joint2, No)
    eF[:, :N1] += eF1

    xp, xf, res = _solve(cfg, U, Uij, W, Wpf, V, eP, eF, Mo, fixed, fixc,
                         sign)
    xp = xp.to(end.dtype)
    count = lambda k: torch.full((P,), k, dtype=types.INDEX, device=dev)  # noqa: E731
    out = types.LocalMap(
        pose_ids=torch.cat([end.pose_ids, pose_ids2], dim=1), poses=xp,
        feat_ids=feat_ids[:, :No], feats=xf.to(end.dtype),
        U=U, Uij=Uij, W=W, Wpf=Wpf, V=V, n_poses=n_poses,
        n_feats=end.n_feats + cur.n_feats - matched.sum(dim=1),
        n_U=count(U.shape[1]), n_W=count(W.shape[1]), gauge=gauge)
    return (out, res.to(xp.dtype)) if cfg.with_res else out


@segment.planned()
def join_stereo(end: types.LocalMap, cur: types.LocalMap,
                cfg: JoinConfig = JoinConfig()):
    """Fuse the lanes of two stacked stereo maps sharing the same gauge.
    K3's plans are kept for the join (`segment.planned`): the solve sums
    over the same index lists in every sweep."""
    idt = types.as_dtype(cfg.info_dtype) or end.U.dtype
    pose_valid = torch.cat([end.pose_mask(), cur.pose_mask()], dim=1)
    return _fuse(
        end, cur, cfg,
        (end.U.to(idt), end.W.to(idt), cur.U.to(idt), cur.W.to(idt)),
        (end.poses, cur.poses), lambda s: s + end.M,
        lambda eP1, eP2: torch.cat([eP1, eP2], dim=1), cur.pose_ids,
        ~pose_valid.repeat_interleave(6, dim=1), end.n_poses + cur.n_poses,
        dataclasses.replace(end.gauge, ref=cur.gauge.ref))


@segment.planned()
def join_mono(end: types.LocalMap, cur: types.LocalMap,
              cfg: JoinConfig = JoinConfig()):
    """Fuse the lanes of two stacked mono maps sharing the same (ref, scap,
    fix) gauge (`end` already in `cur`'s gauge).

    cur's ref and scap slots are identified with end's and left as dead
    slots (id -1, zero information, gauge-masked); every block touching the
    zero-information reference pose is zeroed. K3's plans are kept for the
    join, as in `join_stereo`. What the mono gauge adds before the solve
    (the wraparound, the drop, the pose identification and the gauge
    masks) runs in the span `mono_gauge` of the open solve
    (`utils/metrics`).
    """
    P = end.poses.shape[0]
    M1, M2 = end.M, cur.M
    Mo = M1 + M2
    dev = end.poses.device

    pos1, pos2 = end.ref_slot(), end.scap_slot()
    cref, cscap = cur.ref_slot(), cur.scap_slot()

    with metrics.span("mono_gauge"):
        # ---- angle wraparound on the scale-pose blocks ---------------------
        def with_angles(poses, slot, ang):
            return put1(poses, slot,
                        torch.cat([take1(poses, slot)[:, 0:3], ang], dim=-1))
        end_ang = wrap_angle_pi(take1(end.poses, pos2)[:, 3:6])
        end_poses = with_angles(end.poses, pos2, end_ang)
        cur_ang = wrap_angle_diff(
            wrap_angle_pi(take1(cur.poses, cscap)[:, 3:6]), end_ang)
        cur_poses = with_angles(cur.poses, cscap, cur_ang)

        # ---- drop zero-information blocks touching the reference pose -----
        idt = types.as_dtype(cfg.info_dtype) or end.U.dtype

        def drop_ref(lm, ref):
            keep_u = ((lm.Uij[..., 0] != ref[:, None])
                      & (lm.Uij[..., 1] != ref[:, None]))
            keep_w = lm.Wpf[..., 0] != ref[:, None]
            return (torch.where(keep_u[..., None, None], lm.U.to(idt), 0.0),
                    torch.where(keep_w[..., None, None], lm.W.to(idt), 0.0))
        endU, endW = drop_ref(end, pos1)
        curU, curW = drop_ref(cur, cref)

        # ---- pose identification: cur's ref/scap -> end's slots -----------
        ar2 = torch.arange(M2, device=dev)
        is_ref, is_scap = ar2 == cref[:, None], ar2 == cscap[:, None]
        slotmap2 = torch.where(is_ref, pos1[:, None],
                               (ar2 + M1).expand(P, M2))
        slotmap2 = torch.where(is_scap, pos2[:, None], slotmap2)
        dead2 = is_ref | is_scap

        # ---- gauge masks of the solve -------------------------------------
        pose_valid = torch.cat([end.pose_mask(), cur.pose_mask() & ~dead2],
                               dim=1)
        fixed = ~pose_valid.repeat_interleave(6, dim=1)
        coord = torch.arange(6 * Mo, device=dev)
        fixed |= ((coord >= 6 * pos1[:, None])
                  & (coord < 6 * pos1[:, None] + 6))
        fixc = 6 * pos2 + end.gauge.fix
        fixed |= coord == fixc[:, None]               # the pinned scale coord
        sign = end.gauge.sign.to(idt)

    def place_eP(eP1, eP2):
        # cur's ref and scap rows add into end's slots
        eP = seg_sum(eP2, slotmap2, Mo)
        eP[:, :M1] += eP1
        return eP

    return _fuse(
        end, cur, cfg, (endU, endW, curU, curW), (end_poses, cur_poses),
        lambda s: slotmap2.gather(1, s.reshape(P, -1)).reshape(s.shape),
        place_eP, torch.where(dead2, -1, cur.pose_ids), fixed,
        end.n_poses + cur.n_poses - 2,
        # gauge tags from cur, final-frame tags from end
        dataclasses.replace(cur.gauge, fref=end.gauge.fref,
                            fscap=end.gauge.fscap, ffix=end.gauge.ffix),
        fixc, sign)
