"""Information-matrix congruence ``I' = J^T I J`` of a stereo gauge transform.

Counterpart of `linearsfm_tpu/ops/congruence.py` (stereo). J is
block-sparse: a diagonal block ``D_i`` per state block plus a coupling column
``C_i`` to the old-reference pose slot ``r``; the congruence becomes batched
block products and segment sums over the block lists, which emit new lists
with scatter-add semantics:

    U' = [transformed U | per-pose (i, r) couplings | (r, r)]
    W' = [transformed W | per-feature (r, f) couplings]

The reference's block products are broadcast-multiply-sums because f64 dot
products demote on its TPU; here they are float64 matmuls (exact on a GPU).
Every operand carries the leading lane dimension P.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import types
from . import gauge as G
from .segment import put1, seg_sum, take, take1


def _congr(d_i, blk, d_j):
    """d_i^T blk d_j over leading batch dims."""
    return d_i.transpose(-1, -2) @ blk @ d_j


def congruence_emit(U, Uij, W, Wpf, V, Dp, Df, Cp, Cf, r_slot):
    """Apply the congruence and return the transformed and appended blocks.

    U [P,KU,6,6], Uij [P,KU,2], W [P,KW,6,3], Wpf [P,KW,2], V [P,N,3,3]:
    information blocks. Dp [P,M,6,6], Df [P,N,3,3]: diagonal Jacobian blocks
    (folded at row r). Cp [P,M,6,6], Cf [P,N,3,6]: couplings to the old-ref
    column (zero at row r). r_slot [P]: the coupling column's slot.
    """
    M, N = Dp.shape[1], Df.shape[1]
    ui, uj = Uij[..., 0], Uij[..., 1]
    wp, wf = Wpf[..., 0], Wpf[..., 1]
    offdiag = (ui != uj)[..., None, None]
    zero = U.new_zeros(())
    Ut, Wt = U.transpose(-1, -2), W.transpose(-1, -2)

    U_t = _congr(take(Dp, ui), U, take(Dp, uj))
    W_t = _congr(take(Dp, wp), W, take(Df, wf))
    V_t = _congr(Df, V, Df)

    # M_r[i] = sum_j I_ij C_j (pose rows); Q_r[f] = sum_i C_i^T I_if (features)
    mr = seg_sum(U @ take(Cp, uj), ui, M)
    mr += seg_sum(torch.where(offdiag, Ut @ take(Cp, ui), zero), uj, M)
    mr += seg_sum(W @ take(Cf, wf), wp, M)
    qr = seg_sum(take(Cp, wp).transpose(-1, -2) @ W, wf, N)   # [P,N,6,3]
    qr += Cf.transpose(-1, -2) @ V

    # (r, r): sum over all blocks (both orientations of off-diagonal U) of
    # C_i^T I_ij C_j.
    rr = _congr(take(Cp, ui), U, take(Cp, uj)).sum(1)
    rr += _congr(torch.where(offdiag, take(Cp, uj), zero), Ut,
                 take(Cp, ui)).sum(1)
    rr += _congr(take(Cp, wp), W, take(Cf, wf)).sum(1)
    rr += _congr(take(Cf, wf), Wt, take(Cp, wp)).sum(1)
    rr += _congr(Cf, V, Cf).sum(1)

    newU_r = Dp.transpose(-1, -2) @ mr                # D_i^T M_r[i] at (i, r)
    # the (r, r) emission is diagonal: symmetrise it explicitly
    at_r = (torch.arange(M, device=U.device) == r_slot[:, None])[..., None, None]
    newU_r = torch.where(at_r, newU_r + newU_r.transpose(-1, -2), newU_r)
    newW_r = qr @ Df                                  # at (r, f)
    return dict(U_t=U_t, W_t=W_t, V_t=V_t, newU_r=newU_r, newW_r=newW_r,
                rr=rr)


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


def transform_map_stereo(lm: types.LocalMap, new_ref_id: torch.Tensor,
                         info_dtype: torch.dtype | None = None
                         ) -> types.LocalMap:
    """Re-express each lane of `lm` in the frame of pose `new_ref_id[p]` and
    propagate its information matrix.

    info_dtype: dtype of the congruence products (the information path); the
    state and its Jacobians stay in the state dtype.
    """
    P, M, N = lm.poses.shape[0], lm.M, lm.N
    dev = lm.poses.device
    old_ref_id = lm.gauge.ref
    new_ids, new_poses, new_feats = G.transform_state_stereo(
        lm.pose_ids, lm.poses, lm.feats, new_ref_id, old_ref_id)

    # the slot that held new_ref now holds the old reference pose
    r_slot = types.first_true(new_ids == old_ref_id[:, None])
    q = take1(new_poses, r_slot)

    Dp, Cp, Df, Cf, Dinv = _jacs_stereo(new_poses, new_feats, q)
    # reference row: x_old[r] = invpose(q), own-block derivative d invpose/dq
    Dp = put1(Dp, r_slot, Dinv)
    Cp = put1(Cp, r_slot, 0.0)

    idt = info_dtype or lm.U.dtype
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
