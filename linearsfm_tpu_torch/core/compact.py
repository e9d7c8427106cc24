"""Host ingest: compact and stack a list of local maps (numpy).

Counterpart of `linearsfm_tpu/core/compact.py:compact_stack`: gather valid
poses/features to the front, drop zero and dead blocks, merge duplicate
block coordinates (canonical upper storage for U), and re-pad every map to
shared bucketed capacities — one vectorized pass over globally-offset keys
for the whole batch.
"""

from __future__ import annotations

import numpy as np

from .. import types


def compact_stack(lms: list, bucket: int = 16,
                  u_bucket: int = 64) -> types.LocalMap:
    """Return a host-form [B, ...caps] stacked LocalMap of `lms` (any objects
    `types.host_fields` accepts), compacted."""
    B = len(lms)
    lms = [types.host_fields(lm) for lm in lms]
    M = max(lm.M for lm in lms)
    N = max(lm.N for lm in lms)
    KU = max(lm.KU for lm in lms)
    KW = max(lm.KW for lm in lms)

    def fill(get, shape, fill_value, dt):
        out = np.full((B,) + shape, fill_value, dt)
        for b, lm in enumerate(lms):
            a = np.asarray(get(lm))
            out[b, : a.shape[0]] = a
        return out

    dtype = np.dtype(lms[0].dtype)
    pose_ids = fill(lambda x: x.pose_ids, (M,), -1, np.int32)
    poses = fill(lambda x: x.poses, (M, 6), 0, dtype)
    feat_ids = fill(lambda x: x.feat_ids, (N,), -1, np.int32)
    feats = fill(lambda x: x.feats, (N, 3), 0, dtype)
    U = fill(lambda x: x.U, (KU, 6, 6), 0, dtype)
    Uij = fill(lambda x: x.Uij, (KU, 2), 0, np.int32)
    W = fill(lambda x: x.W, (KW, 6, 3), 0, dtype)
    Wpf = fill(lambda x: x.Wpf, (KW, 2), 0, np.int32)
    V = fill(lambda x: x.V, (N, 3, 3), 0, dtype)
    n_U = np.array([int(lm.n_U) for lm in lms])
    n_W = np.array([int(lm.n_W) for lm in lms])

    # ---- poses/features: gather valid slots to the front (stable) ---------
    pvalid = pose_ids >= 0
    fvalid = feat_ids >= 0
    m = pvalid.sum(1)
    n = fvalid.sum(1)
    Mo = types.bucket(int(m.max()), bucket)
    No = types.bucket(int(n.max()), bucket)
    porder = np.argsort(~pvalid, axis=1, kind="stable")
    forder = np.argsort(~fvalid, axis=1, kind="stable")
    pmap = np.full((B, M), -1, np.int64)
    np.put_along_axis(pmap, porder, np.arange(M)[None, :].repeat(B, 0), 1)
    pmap[~pvalid] = -1
    fmap = np.full((B, N), -1, np.int64)
    np.put_along_axis(fmap, forder, np.arange(N)[None, :].repeat(B, 0), 1)
    fmap[~fvalid] = -1

    def fit(a, k, fill=0):
        """Pad or truncate axis 1 to k (truncation only drops dead slots)."""
        if a.shape[1] >= k:
            return a[:, :k]
        return np.pad(a, [(0, 0), (0, k - a.shape[1])]
                      + [(0, 0)] * (a.ndim - 2), constant_values=fill)

    rows = np.arange(B)[:, None]
    pose_ids_c = fit(np.where(np.arange(M)[None] < m[:, None],
                              np.take_along_axis(pose_ids, porder, 1), -1),
                     Mo, -1)
    poses_c = fit(np.take_along_axis(poses, porder[..., None], 1), Mo)
    feat_ids_c = fit(np.where(np.arange(N)[None] < n[:, None],
                              np.take_along_axis(feat_ids, forder, 1), -1),
                     No, -1)
    feats_c = fit(np.take_along_axis(feats, forder[..., None], 1), No)
    V_c = fit(np.take_along_axis(V, forder[..., None, None], 1), No)

    def dedup(blocks, keys, valid, shape):
        """Global merge of duplicate (map, key) pairs; returns per-map padded
        block/key arrays and per-map counts."""
        span = int(keys.max(initial=0)) + 1
        gkey = np.where(valid, rows * span + keys, -1).ravel()
        blk = blocks.reshape((-1,) + shape)
        sel = gkey >= 0
        gkey, blk = gkey[sel], blk[sel]
        uniq, inv = np.unique(gkey, return_inverse=True)
        acc = np.zeros((len(uniq),) + shape, blocks.dtype)
        np.add.at(acc, inv, blk)
        urow = uniq // span
        ukey = uniq % span
        cnt = np.bincount(urow, minlength=B)
        K = types.bucket(int(cnt.max(initial=0)), u_bucket)
        slot = np.arange(len(uniq)) - np.concatenate([[0], np.cumsum(cnt)])[urow]
        out = np.zeros((B, K) + shape, blocks.dtype)
        okey = np.zeros((B, K), np.int64)
        out[urow, slot] = acc
        okey[urow, slot] = ukey
        return out, okey, cnt

    # ---- U: remap, canonical upper, drop zero/dead, merge dups ------------
    nzU = (np.any(U != 0, axis=(2, 3))
           & (np.arange(KU)[None] < n_U[:, None]))
    ui = np.take_along_axis(pmap, Uij[:, :, 0], 1)
    uj = np.take_along_axis(pmap, Uij[:, :, 1], 1)
    nzU &= (ui >= 0) & (uj >= 0)
    lower = ui > uj
    i2 = np.where(lower, uj, ui)
    j2 = np.where(lower, ui, uj)
    Ub = np.where(lower[..., None, None], np.swapaxes(U, 2, 3), U)
    Uc, ukey, nU_c = dedup(Ub, i2 * Mo + j2, nzU, (6, 6))
    Uij_c = np.stack([ukey // Mo, ukey % Mo], axis=2).astype(np.int32)

    # ---- W: remap, drop zero/dead, merge dups ------------------------------
    nzW = (np.any(W != 0, axis=(2, 3))
           & (np.arange(KW)[None] < n_W[:, None]))
    wp = np.take_along_axis(pmap, Wpf[:, :, 0], 1)
    wf = np.take_along_axis(fmap, Wpf[:, :, 1], 1)
    nzW &= (wp >= 0) & (wf >= 0)
    wp = np.where(nzW, wp, 0)
    wf = np.where(nzW, wf, 0)
    Wc, wkey, nW_c = dedup(W, wp * No + wf, nzW, (6, 3))
    Wpf_c = np.stack([wkey // No, wkey % No], axis=2).astype(np.int32)

    gauge = types.Gauge(*(np.array([getattr(lm.gauge, f) for lm in lms],
                                   np.int32) for f in types.GAUGE_FIELDS))
    return types.LocalMap(
        pose_ids=pose_ids_c.astype(np.int32), poses=poses_c.astype(dtype),
        feat_ids=feat_ids_c.astype(np.int32), feats=feats_c.astype(dtype),
        U=Uc.astype(dtype), Uij=Uij_c, W=Wc.astype(dtype), Wpf=Wpf_c,
        V=V_c.astype(dtype),
        n_poses=m.astype(np.int32), n_feats=n.astype(np.int32),
        n_U=nU_c.astype(np.int32), n_W=nW_c.astype(np.int32),
        gauge=gauge,
    )
