"""Pairwise map joining: the exactly-linear least-squares fusion (stereo).

Counterpart of `linearsfm_tpu/core/join.py` (`JoinConfig`,
`_match_features`, `join_stereo`). Given `end` already re-expressed in
`cur`'s gauge, stack the two information forms and solve once:
``x* = (I_end + I_cur)^{-1} (I_end x_end + I_cur x_cur)``. Every lane of the
lane-stacked inputs is one independent pair.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import types
from ..ops import schur, solve
from ..ops.segment import seg_sum


class JoinConfig(NamedTuple):
    method: str = "refine"    # "refine" (f32-preconditioned f64 PCG) | "direct"
    refine_iters: int = 3
    # information-path dtype (None = inherit); the solved state keeps the
    # state dtype
    info_dtype: torch.dtype | None = None
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


def join_stereo(end: types.LocalMap, cur: types.LocalMap,
                cfg: JoinConfig = JoinConfig()):
    """Fuse the lanes of two stacked stereo maps sharing the same gauge."""
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
    idt = cfg.info_dtype or end.U.dtype
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
    if cfg.method == "refine":
        xp, xf, res = schur.solve_full_mixed(
            U, Uij, W, Wpf, V, eP, eF, Mo, fixed, iters=cfg.refine_iters,
            escalate_iters=cfg.escalate_iters, escalate_tol=cfg.escalate_tol,
            exit_tol=cfg.exit_tol)
    elif cfg.method == "direct":
        Vinv = schur.inv3x3_sym(V)
        S, E = schur._assemble_schur_dense(U, Uij, W, Wpf, Vinv, eP, eF, Mo)
        S, E = solve.mask_gauge(S, E, fixed)
        xp = solve.cholesky_solve(S, E).reshape(P, Mo, 6)
        xf = schur.backsub_features(W, Wpf, Vinv, eF, xp)
        res = torch.full((P,), torch.nan, dtype=xp.dtype, device=dev)
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
