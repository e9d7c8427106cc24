"""Device-side map compaction into fixed capacities.

Counterpart of `linearsfm_tpu/core/dcompact.py`: gather valid poses/features
to the front, merge duplicate block coordinates, drop exact-zero blocks —
with stable sorts and segment sums, on every lane of a stacked map at once,
so the maps never leave the device between tree levels. Output capacities
are arguments; callers guarantee the valid counts fit (core/plan.py).

Duplicate blocks are merged by `ops/segment.seg_sum`: in list order on the
CPU and, inside `segment.deterministic()`, on the card (kernel K3); else
through atomics there, where the float64 summation order (and so the last
bits) can change from run to run.
"""

from __future__ import annotations

import torch

from .. import types
from ..ops.segment import seg_sum, take


def _valid_first_perm(valid):
    """Stable permutation putting True entries first, per lane.

    Returns (perm [P, M] old slot in new order, inv [P, M] old -> new with
    dead slots mapped to M)."""
    P, M = valid.shape
    perm = torch.sort((~valid).to(torch.int64), dim=1, stable=True).indices
    ar = torch.arange(M, device=valid.device).expand(P, M)
    inv = torch.empty_like(perm).scatter_(1, perm, ar)
    return perm, torch.where(valid, inv, M)


def _gather_front(x, perm, out_cap: int, fill=0):
    """new[p, k] = x[p, perm[p, k]] for k < len(perm), `fill` beyond."""
    P, n = perm.shape
    n_take = min(n, out_cap)
    out = torch.full((P, out_cap) + x.shape[2:], fill, dtype=x.dtype,
                     device=x.device)
    out[:, :n_take] = take(x, perm[:, :n_take])
    return out


def _merge_blocks(blocks, keys, entry_valid, out_cap: int):
    """Sort blocks by key, sum duplicates, compact valid-first, per lane.

    keys [P, K] (< 2^31 - 1 where valid), entry_valid bool [P, K].
    Returns (blocks_out [P, out_cap, ...], keys_out [P, out_cap] (-1
    padding), n_out [P]).
    """
    P = keys.shape[0]
    big = torch.iinfo(torch.int32).max
    key = torch.where(entry_valid, keys, big)
    ks, order = torch.sort(key, dim=1, stable=True)
    bs = take(blocks, order)
    vs = entry_valid.gather(1, order)
    start = torch.ones_like(vs)
    start[:, 1:] = ks[:, 1:] != ks[:, :-1]
    seg = torch.cumsum(start.to(torch.int64), dim=1) - 1
    vmask = vs.view(vs.shape + (1,) * (bs.dim() - 2))
    out = seg_sum(torch.where(vmask, bs, bs.new_zeros(())),
                  torch.where(vs, seg, out_cap), out_cap)
    first = vs & start
    kout = torch.full((P, out_cap + 1), -1, dtype=keys.dtype,
                      device=keys.device)
    kout.scatter_(1, torch.where(first, torch.clamp(seg, max=out_cap), out_cap),
                  ks)
    return out, kout[:, :out_cap], first.sum(dim=1)


def compact_device(lm: types.LocalMap, Mo: int, No: int, KUo: int,
                   KWo: int) -> tuple[types.LocalMap, torch.Tensor]:
    """Compact each lane of `lm` into capacities (Mo, No, KUo, KWo).

    Returns (compacted map, max_obs [P]): max_obs is the largest number of
    distinct observing poses of any feature.
    """
    M, N = lm.M, lm.N
    pvalid = lm.pose_mask()
    fvalid = lm.feat_mask()
    pperm, pinv = _valid_first_perm(pvalid)
    fperm, finv = _valid_first_perm(fvalid)

    pose_ids = _gather_front(lm.pose_ids, pperm, Mo, -1)
    poses = _gather_front(lm.poses, pperm, Mo, 0.0)
    feat_ids = _gather_front(lm.feat_ids, fperm, No, -1)
    feats = _gather_front(lm.feats, fperm, No, 0.0)
    V = _gather_front(lm.V, fperm, No, 0.0)

    # ---- U: canonical upper (i <= j), merged ---------------------------------
    ui = take(pinv, torch.clamp(lm.Uij[..., 0], 0, M - 1))
    uj = take(pinv, torch.clamp(lm.Uij[..., 1], 0, M - 1))
    u_ok = ((lm.U != 0).any(dim=(-1, -2)) & (ui < Mo) & (uj < Mo)
            & (ui < M) & (uj < M))
    lower = ui > uj
    i2 = torch.where(lower, uj, ui)
    j2 = torch.where(lower, ui, uj)
    Ub = torch.where(lower[..., None, None], lm.U.transpose(-1, -2), lm.U)
    Um, ukey, nU = _merge_blocks(Ub, i2 * Mo + j2, u_ok, KUo)
    has = ukey >= 0
    Uij = torch.stack([torch.where(has, ukey // Mo, 0),
                       torch.where(has, ukey % Mo, 0)], dim=-1)

    # ---- W ------------------------------------------------------------------
    wp = take(pinv, torch.clamp(lm.Wpf[..., 0], 0, M - 1))
    wf = take(finv, torch.clamp(lm.Wpf[..., 1], 0, N - 1))
    w_ok = ((lm.W != 0).any(dim=(-1, -2)) & (wp < Mo) & (wf < No)
            & (wp < M) & (wf < N))
    Wm, wkey, nW = _merge_blocks(lm.W, wp * No + wf, w_ok, KWo)
    has = wkey >= 0
    Wpf = torch.stack([torch.where(has, wkey // No, 0),
                       torch.where(has, wkey % No, 0)], dim=-1)

    # ---- per-feature observation counts (post-merge) -----------------------
    # an integer sum, exact in any order: `index_add_` even in the fixed-order
    # scope
    obs = seg_sum(torch.ones_like(Wpf[..., 1]), torch.where(has, Wpf[..., 1], No),
                  No)
    out = types.LocalMap(
        pose_ids=pose_ids, poses=poses, feat_ids=feat_ids, feats=feats,
        U=Um, Uij=Uij, W=Wm, Wpf=Wpf, V=V,
        n_poses=pvalid.sum(dim=1), n_feats=fvalid.sum(dim=1),
        n_U=nU, n_W=nW, gauge=lm.gauge)
    return out, obs.max(dim=1).values
