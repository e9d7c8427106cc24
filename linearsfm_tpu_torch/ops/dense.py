"""Dense-blocked map algebra: gauge congruence and fusion solve.

Counterpart of `linearsfm_tpu/ops/dense.py`, the data plane of the planned
executor (core/dense_tree.py). A map's information matrix is carried as

    A[M,6,M,6]   full symmetric pose-pose matrix (both triangles),
    Wd[M,N,6,3]  pose-feature blocks,
    V[N,3,3]     feature-feature block diagonal,

so the congruence ``I' = J^T I J`` (lmj_Transform_PF3DStereo,
LinearSFMImp.cpp:349-1924; lmj_Transform_PF3DMono :3173-6509) is a handful
of einsums, and the Schur complement (lmj_solveLinearSFMStereo
:2119-2378) is dense matmuls. Every tensor carries a leading lane dimension
P, one lane per pair of a tree level (the reference vmaps a one-lane
function); the slots (reference slots, gauge slots) arrive as host-planned
per-lane index tensors [P] (core/layout.py), so nothing here searches ids.
The reference's f64 broadcast-multiply-reduce loops exist because its TPU
demotes f64 dot products; here every contraction is an einsum or matmul in
either dtype.

Zero padding is inert everywhere: padded pose/feature slots carry zero rows
and columns of A/Wd/V, so they contribute nothing to products or solves.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import congruence, schur, solve
from . import gauge as G
from .schur import bmv, bmv_t


class DenseMap(NamedTuple):
    """Value-only dense maps, one per lane (ids live on the host planner)."""
    poses: torch.Tensor   # [P, M, 6]
    feats: torch.Tensor   # [P, N, 3]
    A: torch.Tensor       # [P, M, 6, M, 6]  full symmetric
    Wd: torch.Tensor      # [P, M, N, 6, 3]
    V: torch.Tensor       # [P, N, 3, 3]
    sign: torch.Tensor    # [P] mono scale sign (+1 stereo)

    @property
    def M(self) -> int:
        return self.poses.shape[1]

    @property
    def N(self) -> int:
        return self.feats.shape[1]

    def lanes(self, idx) -> "DenseMap":
        """The lanes `idx` (a slice, or a sequence of lane numbers)."""
        if not isinstance(idx, slice):
            idx = torch.as_tensor(idx, dtype=torch.int64,
                                  device=self.poses.device)
        return DenseMap(*(t[idx] for t in self))

    @staticmethod
    def cat(maps: list["DenseMap"]) -> "DenseMap":
        if len(maps) == 1:
            return maps[0]
        return DenseMap(*(torch.cat(ts) for ts in zip(*maps)))

    @staticmethod
    def from_numpy(fields, device) -> "DenseMap":
        """A dense map from numpy arrays (a mapping or an object with the six
        field names, e.g. the JAX package's `DenseMap` after
        `jax.device_get`), on `device`. One map (poses [M, 6]) becomes one
        lane; dtypes are kept."""
        get = (fields.__getitem__ if isinstance(fields, dict)
               else lambda f: getattr(fields, f))
        arrs = [np.asarray(get(f)) for f in DenseMap._fields]
        if arrs[0].ndim == 2:
            arrs = [a[None] for a in arrs]
        return DenseMap(*(torch.tensor(a, device=device) for a in arrs))


def _flat_w(Wd: torch.Tensor) -> torch.Tensor:
    """Wd [P, M, N, 6, 3] as the dense matrix [P, 6M, 3N] (a copy)."""
    P, M, N = Wd.shape[:3]
    return Wd.permute(0, 1, 3, 2, 4).reshape(P, 6 * M, 3 * N)


# ---------------------------------------------------------------------------
# Congruence
# ---------------------------------------------------------------------------

def _congruence_dense(A, Wd, V, Dp, Df, Cp, Cf, rs, C2p=None, C2f=None,
                      ss=None):
    """Dense ``I' = J^T I J`` with J = blockdiag(Dp,Df) + C e_rs^T (+ C2 e_ss^T).

    Same algebra as ops/congruence.congruence_emit, expressed densely. The
    coupling columns land in pose column `rs` [P] (and `ss` for mono); both
    triangles are written (A is carried full-symmetric). Callers have
    applied the fold rule (Cp[rs] = 0, and for mono C2p[ss] = 0).
    """
    if A.dtype == torch.float32:
        schur.require_full_f32(A.device)
    ein = torch.einsum
    lane = torch.arange(A.shape[0], device=A.device)
    A1 = ein("lpiqb,lqbj->lpiqj", ein("lpai,lpaqb->lpiqb", Dp, A),
             Dp).contiguous()
    W1 = ein("lpnib,lnbj->lpnij", ein("lpai,lpnab->lpnib", Dp, Wd),
             Df).contiguous()
    V1 = Df.mT @ V @ Df

    def cross(Ca_p, Ca_f, Cb_p, Cb_f):
        """Ca^T I Cb over the full (both-triangle) matrix -> [P, 6, 6]."""
        t = ein("lpix,lpiy->lxy", Ca_p, ein("lpiqj,lqjb->lpib", A, Cb_p))
        t += ein("lpix,lpiy->lxy", Ca_p, ein("lpnij,lnjb->lpib", Wd, Cb_f))
        t += ein("lnjx,lnjy->lxy", Ca_f, ein("lpnij,lpib->lnjb", Wd, Cb_p))
        t += ein("lnix,lniy->lxy", Ca_f, V @ Cb_f)
        return t

    def add_column(Cp_, Cf_, slot):
        # Mr[p] = sum_q A[p,q] C_q + sum_n Wd[p,n] Cf_n  -> [P,M,6,6]
        mr = ein("lpaqb,lqbj->lpaj", A, Cp_) + ein("lpnab,lnbj->lpaj", Wd, Cf_)
        # Qr[n] = sum_p Cp_p^T Wd[p,n] + Cf_n^T V_n      -> [P,N,6,3]
        q = ein("lpai,lpnaf->lnif", Cp_, Wd) + Cf_.mT @ V
        col = Dp.mT @ mr                       # block (p, slot): [P, M, 6, 6]
        A1[lane, :, :, slot] += col
        # symmetric completion: A1[slot, a, p, b] += col[p, b, a]
        A1[lane, slot] += col.permute(0, 3, 1, 2)
        W1[lane, slot] += q @ Df               # blocks (slot, n)

    add_column(Cp, Cf, rs)
    A1[lane, rs, :, rs] += cross(Cp, Cf, Cp, Cf)
    if C2p is not None:
        add_column(C2p, C2f, ss)
        A1[lane, ss, :, ss] += cross(C2p, C2f, C2p, C2f)
        rs_ = cross(Cp, Cf, C2p, C2f)
        A1[lane, rs, :, ss] += rs_
        A1[lane, ss, :, rs] += rs_.mT
    return A1, W1, V1


# ---------------------------------------------------------------------------
# Full map transforms (host-planned slots; no id searches)
# ---------------------------------------------------------------------------

def transform_dense_stereo(dm: DenseMap, rs: torch.Tensor,
                           info_dtype=None) -> DenseMap:
    """Re-express each lane in the frame of the pose at slot `rs` [P] and
    propagate the information (lmj_Transform_PF3DStereo,
    LinearSFMImp.cpp:349-1924).

    `rs` is the host-planned slot of the NEW reference pose; after the
    transform that slot holds the OLD reference (:416-417) — a host-side
    re-tag (core/layout.py), invisible here.
    """
    new_poses, new_feats = G.stereo_state_at(dm.poses, dm.feats, rs)
    Dp, Cp, Df, Cf = congruence.stereo_jacobians(new_poses, new_feats, rs)
    idt = info_dtype or dm.A.dtype
    A1, W1, V1 = _congruence_dense(*(t.to(idt) for t in (
        dm.A, dm.Wd, dm.V, Dp, Df, Cp, Cf)), rs)
    return DenseMap(new_poses, new_feats, A1, W1, V1, dm.sign)


def transform_dense_mono(dm: DenseMap, rs, ss, p1, p2, old_fix, new_fix,
                         info_dtype=None) -> DenseMap:
    """Mono gauge+scale transform (lmj_Transform_PF3DMono,
    LinearSFMImp.cpp:3173-6509) with host-planned slots, [P] each:

      rs, ss: slots of the OLD reference / scale pose (coupling columns),
      p1, p2: slots of the NEW reference / scale pose (gauge conditioning),
      old_fix/new_fix: pinned coordinate before/after.
    """
    new_poses, new_feats, sign = G.mono_state_at(dm.poses, dm.feats, p1, p2,
                                                 new_fix)
    Dp, Cp, C2p, Df, Cf, C2f = congruence.mono_jacobians(
        new_poses, new_feats, rs, ss, p1, p2, old_fix, new_fix)
    idt = info_dtype or dm.A.dtype
    c = [t.to(idt) for t in (dm.A, dm.Wd, dm.V, Dp, Df, Cp, Cf, C2p, C2f)]
    A1, W1, V1 = _congruence_dense(*c[:7], rs, C2p=c[7], C2f=c[8], ss=ss)
    return DenseMap(new_poses, new_feats, A1, W1, V1,
                    sign.to(dm.poses.dtype))


# ---------------------------------------------------------------------------
# Fusion solve on the dense representation
# ---------------------------------------------------------------------------

def _matvecs(A2, Wf, V, xp, xf):
    """(A xp + W xf, W^T xp + V xf) from A [P, 6M, 6M] and the flat W
    [P, 6M, 3N] (`_flat_w`): ([P, M, 6], [P, N, 3])."""
    P, M, N = xp.shape[0], xp.shape[1], xf.shape[1]
    xp2, xf2 = xp.reshape(P, -1), xf.reshape(P, -1)
    eP = bmv(A2, xp2) + bmv(Wf, xf2)
    eF = bmv(V, xf) + bmv_t(Wf, xp2).view(P, N, 3)
    return eP.view(P, M, 6), eF


def info_vector_dense(dm: DenseMap, idt):
    """e = I x per lane as dense matvecs (cf. ops/schur.info_vector)."""
    P, M = dm.poses.shape[:2]
    A2 = dm.A.to(idt).reshape(P, 6 * M, 6 * M)
    return _matvecs(A2, _flat_w(dm.Wd.to(idt)), dm.V.to(idt),
                    dm.poses.to(idt), dm.feats.to(idt))


def entry_pairs(P: int, M: int, N: int, device) -> torch.Tensor:
    """The int64 pair list [P, M*N, 2] of a dense W [P, M, N, 6, 3] viewed
    as a block list: entry m*N + n holds (m, n). K2 reads its feature
    column."""
    m = torch.arange(M, device=device).repeat_interleave(N)
    n = torch.arange(N, device=device).repeat(M)
    return torch.stack([m, n], dim=-1).expand(P, M * N, 2).contiguous()


def solve_dense(A, Wd, V, eP, eF, fixed_mask, *, method="refine",
                refine_iters: int = 3, fixc=None, sign=None, pairs=None):
    """Fuse-and-solve on the dense rep, per lane: feature-Schur + Cholesky.

    ``S = A - Wd Vinv Wd^T``, ``E = eP - Wd Vinv eF`` (lmj_solveLinearSFMStereo,
    LinearSFMImp.cpp:2244-2332); gauge rows masked to identity
    (`solve.mask_gauge`; mono 7-row deletion :6981-7021 via fixed_mask
    [P, 6M] and the pin of flat coordinate fixc [P] to sign [P]).

    Vinv and Yd = Wd Vinv come from one launch of kernel K2
    (`schur.inv3x3_wy`), Wd read as the block list [P, M*N, 6, 3] with the
    pair list `pairs` (`entry_pairs(P, M, N)`, built here when None).

    method="direct": everything in the input dtype.
    method="refine": f32 assembly and factorisation, full-precision
    recovery by `refine_iters` sweeps of iterative refinement with residuals
    from the input-dtype (f64) dense blocks — the dense analogue of
    ops/schur.solve_full_mixed.

    Returns (x_p [P,M,6], x_f [P,N,3]) in the input dtype.
    """
    dt, dev = A.dtype, A.device
    P, M, N = eP.shape[0], eP.shape[1], eF.shape[1]
    f32 = torch.float32
    wdt = f32 if method == "refine" else dt
    if wdt == f32:
        schur.require_full_f32(dev)
    lane = torch.arange(P, device=dev)

    Ww = Wd.to(wdt).contiguous()
    if pairs is None:
        pairs = entry_pairs(P, M, N, dev)
    Vinv, Y = schur.inv3x3_wy(V.to(wdt), Ww.view(P, M * N, 6, 3), pairs)
    Wf, Yf = _flat_w(Ww), _flat_w(Y.view(P, M, N, 6, 3))
    del Ww, Y
    S = torch.baddbmm(A.to(wdt).reshape(P, 6 * M, 6 * M), Yf, Wf.mT,
                      alpha=-1.0)
    E = eP.to(wdt).reshape(P, -1) - bmv(Yf, eF.to(wdt).reshape(P, -1))
    if fixc is not None:
        E = E - S[lane, :, fixc] * sign.to(wdt)[:, None]
    S, E = solve.mask_gauge(S, E, fixed_mask)
    Lf = solve.factor(S)
    del S

    def pin(xp):
        return xp if fixc is None else schur.pin_coordinate(xp, fixc, sign)

    def back(rF, xp):
        """Vinv (rF - W^T xp) in the working dtype."""
        return bmv(Vinv, rF - bmv_t(Wf, xp.reshape(P, -1)).view(P, N, 3))

    xp = pin(solve.solve_factored(Lf, E).view(P, M, 6).to(dt))
    xf = back(eF.to(wdt), xp.to(wdt)).to(dt)
    if method != "refine":
        return xp, xf

    freeP = (~fixed_mask).view(P, M, 6)
    A2, W64 = A.reshape(P, 6 * M, 6 * M), _flat_w(Wd)
    for _ in range(refine_iters):
        iP, iF = _matvecs(A2, W64, V, xp, xf)
        rP = (eP - iP).to(f32)
        rF = (eF - iF).to(f32)
        red = rP.reshape(P, -1) - bmv(Yf, rF.reshape(P, -1))
        red = torch.where(freeP.reshape(P, -1), red, red.new_zeros(()))
        dxp = solve.solve_factored(Lf, red).view(P, M, 6)
        dxf = back(rF, dxp)
        xp, xf = xp + dxp.to(dt), xf + dxf.to(dt)
    return pin(xp), xf

