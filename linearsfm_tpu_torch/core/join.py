"""Pairwise map joining: the exactly-linear least-squares fusion.

Counterpart of `linearsfm_tpu/core/join.py` (`JoinConfig`,
`_match_features`, `join_stereo`, `join_mono`). Given `end` already
re-expressed in `cur`'s gauge, stack the two information forms and solve
once: ``x* = (I_end + I_cur)^{-1} (I_end x_end + I_cur x_cur)``. Every lane
of the lane-stacked inputs is one independent pair.

Two solves, as in the reference: method "refine" (stereo, and mono with
pin "sign") is `schur.solve_full_mixed`, the f32 Schur factor
preconditioning an f64 PCG on the full system; every other combination
("direct", and mono "refine" with pin "zero") forms the reduced system in
the information dtype (`schur.inv3x3_wy`, `schur.assemble_schur`) and
solves it with `solve.solve_reduced` — a plain Cholesky, or for "refine"
an f32 factor with refinement sweeps — then back-substitutes the features.
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


def _reduced_system(U, Uij, W, Wpf, V, eP, eF, Mo: int, cfg: JoinConfig):
    """(Vinv, S, E): the feature-block inverses and the reduced camera
    system in the information dtype, from one K2 launch (Vinv and
    Y = W Vinv[wf]) and `schur.assemble_schur`."""
    Vinv, Yb = schur.inv3x3_wy(V, W, Wpf)
    S, E = schur.assemble_schur(U, Uij, W, Wpf, Yb, eP, eF, Mo, cfg.max_obs,
                                force_dense=cfg.dense_schur)
    return Vinv, S, E


@segment.planned()
def join_stereo(end: types.LocalMap, cur: types.LocalMap,
                cfg: JoinConfig = JoinConfig()):
    """Fuse the lanes of two stacked stereo maps sharing the same gauge.
    K3's plans are kept for the join (`segment.planned`): the solve sums
    over the same index lists in every sweep."""
    P = end.poses.shape[0]
    M1, N1, N2 = end.M, end.N, cur.N
    Mo, No = M1 + cur.M, N1 + N2
    dev = end.poses.device

    joint2, matched = _match_features(end.feat_ids, end.feat_mask(),
                                      cur.feat_ids, cur.feat_mask(),
                                      end.n_feats, No)
    ncom = matched.sum(dim=1)
    joint2g = torch.clamp(joint2, 0, No - 1)   # gather-safe (pads hit zero blocks)

    # ---- states & ids ------------------------------------------------------
    pose_ids = torch.cat([end.pose_ids, cur.pose_ids], dim=1)
    feat_ids = torch.full((P, No + 1), -1, dtype=types.INDEX, device=dev)
    feat_ids[:, :N1] = end.feat_ids
    feat_ids.scatter_(1, joint2, cur.feat_ids)    # slot No is the drop slot
    feat_ids = feat_ids[:, :No]

    # ---- information blocks ------------------------------------------------
    idt = types.as_dtype(cfg.info_dtype) or end.U.dtype
    endU, endW, endV = end.U.to(idt), end.W.to(idt), end.V.to(idt)
    curU, curW, curV = cur.U.to(idt), cur.W.to(idt), cur.V.to(idt)
    U = torch.cat([endU, curU], dim=1)
    Uij = torch.cat([end.Uij, cur.Uij + M1], dim=1)
    W = torch.cat([endW, curW], dim=1)
    Wpf2 = torch.stack([cur.Wpf[..., 0] + M1,
                        joint2g.gather(1, cur.Wpf[..., 1])], dim=-1)
    Wpf = torch.cat([end.Wpf, Wpf2], dim=1)
    V = seg_sum(curV, joint2, No)
    V[:, :N1] += endV

    # ---- information vectors e = I x per map -----------------------------
    eP1, eF1 = schur.info_vector(end.poses, end.feats, endU, end.Uij, endW,
                                 end.Wpf, endV)
    eP2, eF2 = schur.info_vector(cur.poses, cur.feats, curU, cur.Uij, curW,
                                 cur.Wpf, curV)
    eP = torch.cat([eP1, eP2], dim=1)
    eF = seg_sum(eF2, joint2, No)
    eF[:, :N1] += eF1

    # ---- Schur + solve -----------------------------------------------------
    pose_valid = torch.cat([end.pose_mask(), cur.pose_mask()], dim=1)
    fixed = ~pose_valid.repeat_interleave(6, dim=1)
    nan = torch.full((P,), torch.nan, dtype=eP.dtype, device=dev)
    if cfg.mesh is not None and cfg.method in ("refine", "direct"):
        if cfg.method == "refine":
            # the production accuracy: the feature-sharded full-system PCG
            xp, xf, res = shard_solve.sharded_full_mixed(
                U, Uij, W, Wpf, V, eP, eF, Mo, fixed, mesh=cfg.mesh,
                axis=cfg.mesh_axis, iters=cfg.refine_iters,
                escalate_iters=cfg.escalate_iters,
                escalate_tol=cfg.escalate_tol, exit_tol=cfg.exit_tol)
        else:
            xp, xf = shard_solve.sharded_schur_solve(
                U, Uij, W, Wpf, V, eP, eF, Mo, cfg.max_obs, cfg.mesh,
                axis=cfg.mesh_axis, fixed_mask=fixed, method=cfg.method,
                refine_iters=cfg.refine_iters)
            res = nan
    elif cfg.method == "refine":
        xp, xf, res = schur.solve_full_mixed(
            U, Uij, W, Wpf, V, eP, eF, Mo, fixed, max_obs=cfg.max_obs,
            force_dense=cfg.dense_schur, iters=cfg.refine_iters,
            escalate_iters=cfg.escalate_iters, escalate_tol=cfg.escalate_tol,
            exit_tol=cfg.exit_tol)
    elif cfg.method == "direct":
        Vinv, S, E = _reduced_system(U, Uij, W, Wpf, V, eP, eF, Mo, cfg)
        xp = solve.solve_reduced(S, E, fixed_mask=fixed, method=cfg.method,
                                 refine_iters=cfg.refine_iters
                                 ).reshape(P, Mo, 6)
        xf = schur.backsub_features(W, Wpf, Vinv, eF, xp)
        res = nan
    else:
        raise ValueError(f"unknown join method {cfg.method!r}")
    xp = xp.to(end.dtype)
    xf = xf.to(end.dtype)

    count = lambda k: torch.full((P,), k, dtype=types.INDEX, device=dev)  # noqa: E731
    out = types.LocalMap(
        pose_ids=pose_ids, poses=xp, feat_ids=feat_ids, feats=xf,
        U=U, Uij=Uij, W=W, Wpf=Wpf, V=V,
        n_poses=end.n_poses + cur.n_poses,
        n_feats=end.n_feats + cur.n_feats - ncom,
        n_U=count(U.shape[1]), n_W=count(W.shape[1]),
        gauge=dataclasses.replace(end.gauge, ref=cur.gauge.ref))
    return (out, res.to(xp.dtype)) if cfg.with_res else out


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
    M1, M2, N1, N2 = end.M, cur.M, end.N, cur.N
    Mo, No = M1 + M2, N1 + N2
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
        endV, curV = end.V.to(idt), cur.V.to(idt)

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

    # ---- feature matching --------------------------------------------------
    joint2, matched = _match_features(end.feat_ids, end.feat_mask(),
                                      cur.feat_ids, cur.feat_mask(),
                                      end.n_feats, No)
    ncom = matched.sum(dim=1)
    joint2g = torch.clamp(joint2, 0, No - 1)   # gather-safe

    # ---- ids ---------------------------------------------------------------
    # cur's ref/scap slots become dead
    pose_ids = torch.cat([end.pose_ids, torch.where(dead2, -1, cur.pose_ids)],
                         dim=1)
    feat_ids = torch.full((P, No + 1), -1, dtype=types.INDEX, device=dev)
    feat_ids[:, :N1] = end.feat_ids
    feat_ids.scatter_(1, joint2, cur.feat_ids)    # slot No is the drop slot
    feat_ids = feat_ids[:, :No]

    # ---- information blocks ------------------------------------------------
    U = torch.cat([endU, curU], dim=1)
    Uij2 = slotmap2.gather(1, cur.Uij.reshape(P, -1)).reshape(cur.Uij.shape)
    Uij = torch.cat([end.Uij, Uij2], dim=1)
    W = torch.cat([endW, curW], dim=1)
    Wpf2 = torch.stack([slotmap2.gather(1, cur.Wpf[..., 0]),
                        joint2g.gather(1, cur.Wpf[..., 1])], dim=-1)
    Wpf = torch.cat([end.Wpf, Wpf2], dim=1)
    V = seg_sum(curV, joint2, No)
    V[:, :N1] += endV

    # ---- information vectors (after the drop and the wraparound) ----------
    eP1, eF1 = schur.info_vector(end_poses, end.feats, endU, end.Uij, endW,
                                 end.Wpf, endV)
    eP2, eF2 = schur.info_vector(cur_poses, cur.feats, curU, cur.Uij, curW,
                                 cur.Wpf, curV)
    # cur's ref and scap rows add into end's slots
    eP = seg_sum(eP2, slotmap2, Mo)
    eP[:, :M1] += eP1
    eF = seg_sum(eF2, joint2, No)
    eF[:, :N1] += eF1

    # ---- Schur + gauge-masked solve ----------------------------------------
    nan = torch.full((P,), torch.nan, dtype=eP.dtype, device=dev)

    known = (cfg.method in ("direct", "refine")
             and cfg.pin in ("sign", "zero"))
    if cfg.mesh is not None and known:
        if cfg.method == "refine" and cfg.pin == "sign":
            xp, xf, res = shard_solve.sharded_full_mixed(
                U, Uij, W, Wpf, V, eP, eF, Mo, fixed, mesh=cfg.mesh,
                axis=cfg.mesh_axis, iters=cfg.refine_iters, fixc=fixc,
                sign=sign, escalate_iters=cfg.escalate_iters,
                escalate_tol=cfg.escalate_tol, exit_tol=cfg.exit_tol)
        else:
            # as the reference: with gauge-conditioned inputs the pinned
            # coordinate carries no information, so the right-hand side
            # needs no correction; the pin is written back after the
            # back-substitution
            xp, xf = shard_solve.sharded_schur_solve(
                U, Uij, W, Wpf, V, eP, eF, Mo, cfg.max_obs, cfg.mesh,
                axis=cfg.mesh_axis, fixed_mask=fixed, method=cfg.method,
                refine_iters=cfg.refine_iters)
            xp = schur.pin_coordinate(xp, fixc, sign)
            res = nan
    elif cfg.method == "refine" and cfg.pin == "sign":
        xp, xf, res = schur.solve_full_mixed(
            U, Uij, W, Wpf, V, eP, eF, Mo, fixed, max_obs=cfg.max_obs,
            force_dense=cfg.dense_schur, iters=cfg.refine_iters,
            fixc=fixc, sign=sign, escalate_iters=cfg.escalate_iters,
            escalate_tol=cfg.escalate_tol, exit_tol=cfg.exit_tol)
    elif known:
        # direct, or refine with pin "zero" (the reduced system's f32
        # factor with refinement sweeps, as the reference)
        Vinv, S, E = _reduced_system(U, Uij, W, Wpf, V, eP, eF, Mo, cfg)
        if cfg.pin == "sign":
            E = E - S[torch.arange(P, device=dev), :, fixc] * sign[:, None]
        xp = solve.solve_reduced(S, E, fixed_mask=fixed, method=cfg.method,
                                 refine_iters=cfg.refine_iters
                                 ).reshape(P, Mo, 6)
        if cfg.pin == "sign":
            # exact constrained fusion: back-substitute with the pinned
            # coordinate at its value
            xp = schur.pin_coordinate(xp, fixc, sign)
            xf = schur.backsub_features(W, Wpf, Vinv, eF, xp)
        else:
            # the reference C++ order: back-substitute with the pinned
            # coordinate still at 0, set it to sign afterwards
            xf = schur.backsub_features(W, Wpf, Vinv, eF, xp)
            xp = schur.pin_coordinate(xp, fixc, sign)
        res = nan
    else:
        raise ValueError(f"join_mono: no solve for method={cfg.method!r}, "
                         f"pin={cfg.pin!r}")
    xp = xp.to(end.dtype)
    xf = xf.to(end.dtype)

    count = lambda k: torch.full((P,), k, dtype=types.INDEX, device=dev)  # noqa: E731
    out = types.LocalMap(
        pose_ids=pose_ids, poses=xp, feat_ids=feat_ids, feats=xf,
        U=U, Uij=Uij, W=W, Wpf=Wpf, V=V,
        n_poses=end.n_poses + cur.n_poses - 2,
        n_feats=end.n_feats + cur.n_feats - ncom,
        n_U=count(U.shape[1]), n_W=count(W.shape[1]),
        # gauge tags from cur, final-frame tags from end
        gauge=dataclasses.replace(cur.gauge, fref=end.gauge.fref,
                                  fscap=end.gauge.fscap, ffix=end.gauge.ffix))
    return (out, res.to(xp.dtype)) if cfg.with_res else out
