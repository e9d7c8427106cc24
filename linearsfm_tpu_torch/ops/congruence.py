"""Information-matrix congruence ``I' = J^T I J`` of a gauge transform.

Counterpart of `linearsfm_tpu/ops/congruence.py`. J is block-sparse: a
diagonal block ``D_i`` per state block plus a coupling column ``C_i`` to the
old-reference pose slot ``r`` and, for mono, ``C2_i`` to the old scale-pose
slot ``s``; the congruence becomes batched block products and segment sums
over the block lists, which emit new lists with scatter-add semantics:

    stereo: U' = [transformed U | (i, r) | (r, r)]
            W' = [transformed W | (r, f)]
    mono:   U' = [transformed U | (i, r) | (i, s) | (r, r) | (s, s) | (r, s)]
            W' = [transformed W | (r, f) | (s, f)]

The reference's block products are broadcast-multiply-sums because f64 dot
products demote on its TPU; here they are float64 matmuls (exact on a GPU).
Every operand carries the leading lane dimension P.

`transform_map_stereo` / `transform_map_mono` run kernel K5
(`kernels.gauge_congruence`) on a CUDA map, a few launches a call; the
plain versions `transform_map_stereo_ref` / `transform_map_mono_ref` below
run on a CPU map.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import types
from . import gauge as G
from . import kernels, segment
from .segment import put1, seg_sum, take, take1


def _congr(d_i, blk, d_j):
    """d_i^T blk d_j over leading batch dims."""
    return d_i.transpose(-1, -2) @ blk @ d_j


@segment.planned()
def congruence_emit(U, Uij, W, Wpf, V, Dp, Df, Cp, Cf, r_slot,
                    C2p=None, C2f=None, s_slot=None):
    """Apply the congruence and return the transformed and appended blocks.

    U [P,KU,6,6], Uij [P,KU,2], W [P,KW,6,3], Wpf [P,KW,2], V [P,N,3,3]:
    information blocks. Dp [P,M,6,6], Df [P,N,3,3]: diagonal Jacobian blocks
    (folded at row r). Cp [P,M,6,6], Cf [P,N,3,6]: couplings to the old-ref
    column (zero at row r). r_slot [P]: the coupling column's slot.
    C2p/C2f/s_slot (mono): the couplings to the old scale-pose column (zero
    at row s) and its slot; they add newU_s, newW_s, ss and rs. Mono's
    two emissions sum over the same four lists: K3 sorts each once
    (`segment.planned`).
    """
    M, N = Dp.shape[1], Df.shape[1]
    ui, uj = Uij[..., 0], Uij[..., 1]
    wp, wf = Wpf[..., 0], Wpf[..., 1]
    offdiag = (ui != uj)[..., None, None]
    zero = U.new_zeros(())
    Ut, Wt = U.transpose(-1, -2), W.transpose(-1, -2)
    ar_m = torch.arange(M, device=U.device)

    U_t = _congr(take(Dp, ui), U, take(Dp, uj))
    W_t = _congr(take(Dp, wp), W, take(Df, wf))
    V_t = _congr(Df, V, Df)

    def emit(Cp_, Cf_, slot):
        """The appended column blocks at (i, slot) and (slot, f)."""
        # M[i] = sum_j I_ij C_j (pose rows); Q[f] = sum_i C_i^T I_if (features)
        m = seg_sum(U @ take(Cp_, uj), ui, M)
        m += seg_sum(torch.where(offdiag, Ut @ take(Cp_, ui), zero), uj, M)
        m += seg_sum(W @ take(Cf_, wf), wp, M)
        q = seg_sum(take(Cp_, wp).transpose(-1, -2) @ W, wf, N)   # [P,N,6,3]
        q += Cf_.transpose(-1, -2) @ V
        newU = Dp.transpose(-1, -2) @ m               # D_i^T M[i] at (i, slot)
        # the (slot, slot) emission is diagonal: symmetrise it explicitly
        at = (ar_m == slot[:, None])[..., None, None]
        newU = torch.where(at, newU + newU.transpose(-1, -2), newU)
        return newU, q @ Df                           # W at (slot, f)

    def cross(Ca_p, Ca_f, Cb_p, Cb_f):
        """Sum over all blocks (both orientations of off-diagonal U) of
        Ca_i^T I_ij Cb_j: the (r, r), (s, s) and (r, s) accumulators."""
        t = _congr(take(Ca_p, ui), U, take(Cb_p, uj)).sum(1)
        t += _congr(torch.where(offdiag, take(Ca_p, uj), zero), Ut,
                    take(Cb_p, ui)).sum(1)
        t += _congr(take(Ca_p, wp), W, take(Cb_f, wf)).sum(1)
        t += _congr(take(Ca_f, wf), Wt, take(Cb_p, wp)).sum(1)
        t += _congr(Ca_f, V, Cb_f).sum(1)
        return t

    newU_r, newW_r = emit(Cp, Cf, r_slot)
    out = dict(U_t=U_t, W_t=W_t, V_t=V_t, newU_r=newU_r, newW_r=newW_r,
               rr=cross(Cp, Cf, Cp, Cf))
    if C2p is not None:
        newU_s, newW_s = emit(C2p, C2f, s_slot)
        out.update(newU_s=newU_s, newW_s=newW_s, ss=cross(C2p, C2f, C2p, C2f),
                   rs=cross(Cp, Cf, C2p, C2f))
    return out


def _jacs_stereo(new_poses, new_feats, q):
    """All stereo Jacobian families from ONE forward-mode jacfwd.

    A uniform seed e added to every block (and every lane) gives
    d f_i / d e = d block_i / d own block, since each output block depends on
    no other block: 15 tangents (e[6], ef[3], dq[6]) yield Dp/Df/Cp/Cf/Dinv
    for a whole tree level at once.
    """
    z6 = new_poses.new_zeros(6)
    z3 = new_poses.new_zeros(3)

    def f(e, ef, dq):
        return G.stereo_batched(new_poses + e, new_feats + ef, q + dq)

    (Dp, _, Cp), (_, Df, Cf), (_, _, Dinv) = torch.func.jacfwd(
        f, argnums=(0, 1, 2))(z6, z3, z6)
    return Dp, Cp, Df, Cf, Dinv


def stereo_jacobians(new_poses, new_feats, r_slot):
    """The J blocks (Dp, Cp, Df, Cf) of a stereo transform whose old
    reference pose sits at `r_slot` [P] of the transformed state: the
    reference row is x_old[r] = invpose(q), so Dp[r] = d invpose/dq and
    Cp[r] = 0."""
    q = take1(new_poses, r_slot)
    Dp, Cp, Df, Cf, Dinv = _jacs_stereo(new_poses, new_feats, q)
    return put1(Dp, r_slot, Dinv), put1(Cp, r_slot, 0.0), Df, Cf


def transform_map_stereo(lm: types.LocalMap, new_ref_id: torch.Tensor,
                         info_dtype: torch.dtype | str | None = None
                         ) -> types.LocalMap:
    """Re-express each lane of `lm` in the frame of pose `new_ref_id[p]` and
    propagate its information matrix.

    info_dtype: dtype of the congruence products (the information path), a
    torch dtype or its name; the state and its Jacobians stay in the state
    dtype. Kernel K5 (`kernels.gauge_congruence`) on a CUDA map,
    `transform_map_stereo_ref` on a CPU one.
    """
    if lm.poses.device.type == "cpu":
        return transform_map_stereo_ref(lm, new_ref_id, info_dtype)
    return kernels.gauge_congruence(lm, False, (new_ref_id,), info_dtype)


def transform_map_stereo_ref(lm: types.LocalMap, new_ref_id: torch.Tensor,
                             info_dtype: torch.dtype | str | None = None
                             ) -> types.LocalMap:
    """Plain version of `transform_map_stereo` (and of K5's stereo form):
    the state map, the Jacobian blocks from one jacfwd, the congruence's
    block products and segment sums, the lists concatenated."""
    P, M, N = lm.poses.shape[0], lm.M, lm.N
    dev = lm.poses.device
    old_ref_id = lm.gauge.ref
    new_ids, new_poses, new_feats = G.transform_state_stereo(
        lm.pose_ids, lm.poses, lm.feats, new_ref_id, old_ref_id)

    # the slot that held new_ref now holds the old reference pose
    r_slot = types.first_true(new_ids == old_ref_id[:, None])
    Dp, Cp, Df, Cf = stereo_jacobians(new_poses, new_feats, r_slot)

    idt = types.as_dtype(info_dtype) or lm.U.dtype
    em = congruence_emit(lm.U.to(idt), lm.Uij, lm.W.to(idt), lm.Wpf,
                         lm.V.to(idt), Dp.to(idt), Df.to(idt), Cp.to(idt),
                         Cf.to(idt), r_slot)

    ar_m = torch.arange(M, device=dev).expand(P, M)
    ar_n = torch.arange(N, device=dev).expand(P, N)
    U = torch.cat([em["U_t"], em["newU_r"], em["rr"][:, None]], dim=1)
    Uij = torch.cat([
        lm.Uij,
        torch.stack([ar_m, r_slot[:, None].expand(P, M)], dim=-1),
        torch.stack([r_slot, r_slot], dim=-1)[:, None],
    ], dim=1)
    W = torch.cat([em["W_t"], em["newW_r"]], dim=1)
    Wpf = torch.cat([
        lm.Wpf, torch.stack([r_slot[:, None].expand(P, N), ar_n], dim=-1)],
        dim=1)
    count = lambda k: torch.full((P,), k, dtype=types.INDEX, device=dev)  # noqa: E731
    return dataclasses.replace(
        lm, pose_ids=new_ids, poses=new_poses, feats=new_feats,
        U=U, Uij=Uij, W=W, Wpf=Wpf, V=em["V_t"],
        n_U=count(U.shape[1]), n_W=count(W.shape[1]),
        gauge=dataclasses.replace(lm.gauge, ref=new_ref_id))


def _jacs_mono(new_poses, new_feats, q, s, fix):
    """Mono Jacobian families (Dp/Df, Cp/Cf, C2p/C2f) from ONE jacfwd over
    18 tangents (e[6], ef[3], dq[6], ds[3]); see _jacs_stereo for the
    uniform seed. The d/ds families are 3 wide (translation only)."""
    z6 = new_poses.new_zeros(6)
    z3 = new_poses.new_zeros(3)

    def f(e, ef, dq, ds):
        npz, nfz, _ = G.mono_batched(new_poses + e, new_feats + ef, q + dq,
                                     s + ds, fix)
        return npz, nfz

    ((Dp, _, Cp, C2p3), (_, Df, Cf, C2f3)) = torch.func.jacfwd(
        f, argnums=(0, 1, 2, 3))(z6, z3, z6, z3)
    return Dp, Cp, C2p3, Df, Cf, C2f3


def mono_jacobians(new_poses, new_feats, r_slot, s_slot, p1, p2, old_fix,
                   new_fix):
    """The J blocks (Dp, Cp, C2p, Df, Cf, C2f) of a mono transform, per
    lane: r_slot/s_slot [P] hold the old reference/scale pose, p1/p2 [P]
    the new ones, in the transformed state; old_fix/new_fix [P] the pinned
    coordinates. The couplings are folded at the old gauge rows and the
    new gauge coordinates projected out."""
    dev = new_poses.device
    q = take1(new_poses, r_slot)
    s = take1(new_poses, s_slot)[:, 0:3]
    Dp, Cp, C2p3, Df, Cf, C2f3 = _jacs_mono(new_poses, new_feats, q, s,
                                            old_fix)
    # embed d/ds (3 columns) into 6-wide coupling blocks
    C2p = torch.nn.functional.pad(C2p3, (0, 3))
    C2f = torch.nn.functional.pad(C2f3, (0, 3))

    # folds at the old gauge rows: D[r] += C[r], C[r] = 0; same for s
    Dp = put1(Dp, r_slot, take1(Dp, r_slot) + take1(Cp, r_slot))
    Cp = put1(Cp, r_slot, 0.0)
    Dp = put1(Dp, s_slot, take1(Dp, s_slot) + take1(C2p, s_slot))
    C2p = put1(C2p, s_slot, 0.0)

    # Gauge-conditioning projection: zero every J column of a NEW gauge
    # coordinate (the new ref block, the new scap's pinned coordinate), so
    # the transformed information has exactly zero rows/cols there and the
    # solver's 7-row deletion is exact. The slot conditions hold per lane.
    colfix = torch.arange(6, device=dev) == new_fix[:, None]      # [P, 6]
    Dp = put1(Dp, p1, 0.0)
    Dp = put1(Dp, p2, torch.where(colfix[:, None, :], 0.0, take1(Dp, p2)))

    def kill(C, lane_cond, fix_col_only):
        mask = lane_cond[:, None, None, None]
        if fix_col_only:
            mask = mask & colfix[:, None, None, :]
        return torch.where(mask, 0.0, C)

    Cp = kill(kill(Cp, r_slot == p2, True), r_slot == p1, False)
    Cf = kill(kill(Cf, r_slot == p2, True), r_slot == p1, False)
    C2p = kill(kill(C2p, s_slot == p2, True), s_slot == p1, False)
    C2f = kill(kill(C2f, s_slot == p2, True), s_slot == p1, False)
    return Dp, Cp, C2p, Df, Cf, C2f


def transform_map_mono(lm: types.LocalMap, new_ref_id: torch.Tensor,
                       new_scap_id: torch.Tensor, new_fix: torch.Tensor,
                       info_dtype: torch.dtype | str | None = None
                       ) -> types.LocalMap:
    """Re-express each lane of `lm` in the mono gauge (`new_ref_id[p]`,
    `new_scap_id[p]`, `new_fix[p]`) and propagate its information matrix.

    info_dtype: see transform_map_stereo. Kernel K5
    (`kernels.gauge_congruence`) on a CUDA map, `transform_map_mono_ref` on
    a CPU one.
    """
    if lm.poses.device.type == "cpu":
        return transform_map_mono_ref(lm, new_ref_id, new_scap_id, new_fix,
                                      info_dtype)
    return kernels.gauge_congruence(lm, True, (new_ref_id, new_scap_id,
                                               new_fix), info_dtype)


def transform_map_mono_ref(lm: types.LocalMap, new_ref_id: torch.Tensor,
                           new_scap_id: torch.Tensor, new_fix: torch.Tensor,
                           info_dtype: torch.dtype | str | None = None
                           ) -> types.LocalMap:
    """Plain version of `transform_map_mono` (and of K5's mono form); see
    `transform_map_stereo_ref`."""
    P, M, N = lm.poses.shape[0], lm.M, lm.N
    dev = lm.poses.device
    old = lm.gauge
    new_poses, new_feats, sign = G.transform_state_mono(
        lm.pose_ids, lm.poses, lm.feats, new_ref_id, new_scap_id, new_fix)

    # the old gauge blocks, in the same slots (mono keeps every pose id)
    r_slot, s_slot = lm.ref_slot(), lm.scap_slot()
    p1 = types.first_true(lm.pose_ids == new_ref_id[:, None])
    p2 = types.first_true(lm.pose_ids == new_scap_id[:, None])
    Dp, Cp, C2p, Df, Cf, C2f = mono_jacobians(new_poses, new_feats, r_slot,
                                              s_slot, p1, p2, old.fix,
                                              new_fix)

    idt = types.as_dtype(info_dtype) or lm.U.dtype
    em = congruence_emit(lm.U.to(idt), lm.Uij, lm.W.to(idt), lm.Wpf,
                         lm.V.to(idt), Dp.to(idt), Df.to(idt), Cp.to(idt),
                         Cf.to(idt), r_slot, C2p=C2p.to(idt),
                         C2f=C2f.to(idt), s_slot=s_slot)

    ar_m = torch.arange(M, device=dev).expand(P, M)
    ar_n = torch.arange(N, device=dev).expand(P, N)

    def pair(a, b):
        return torch.stack([a, b], dim=-1)[:, None]

    U = torch.cat([em["U_t"], em["newU_r"], em["newU_s"], em["rr"][:, None],
                   em["ss"][:, None], em["rs"][:, None]], dim=1)
    Uij = torch.cat([
        lm.Uij,
        torch.stack([ar_m, r_slot[:, None].expand(P, M)], dim=-1),
        torch.stack([ar_m, s_slot[:, None].expand(P, M)], dim=-1),
        pair(r_slot, r_slot), pair(s_slot, s_slot), pair(r_slot, s_slot),
    ], dim=1)
    W = torch.cat([em["W_t"], em["newW_r"], em["newW_s"]], dim=1)
    Wpf = torch.cat([
        lm.Wpf,
        torch.stack([r_slot[:, None].expand(P, N), ar_n], dim=-1),
        torch.stack([s_slot[:, None].expand(P, N), ar_n], dim=-1),
    ], dim=1)
    count = lambda k: torch.full((P,), k, dtype=types.INDEX, device=dev)  # noqa: E731
    return dataclasses.replace(
        lm, poses=new_poses, feats=new_feats,
        U=U, Uij=Uij, W=W, Wpf=Wpf, V=em["V_t"],
        n_U=count(U.shape[1]), n_W=count(W.shape[1]),
        gauge=dataclasses.replace(
            lm.gauge, ref=new_ref_id, scap=new_scap_id, fix=new_fix,
            sign=sign.to(types.INDEX)))
