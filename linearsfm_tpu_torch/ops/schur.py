"""Information-form fusion solve: dense feature-Schur complement.

Counterpart of `linearsfm_tpu/ops/schur.py`, the subset the device tree
runs: the dense assembly (`_assemble_schur_dense`, feature-chunked above a
byte budget), the mixed-precision solve `solve_full_mixed` (f32 Schur
Cholesky preconditioning an f64 PCG on the full information system), and the
feature back-substitution. The grouped (per-feature) assembly of the host
executor is not ported.

Every operand carries the leading lane dimension P: one call solves every
pair of a tree level. Block lists are zero-padded; padding contributes
nothing.
"""

from __future__ import annotations

import os

import torch

from . import kernels, solve
from .segment import lane_where, seg_sum, take


def dense_w_bytes() -> int:
    """Byte budget of one dense [6M, 3N] W/Y layout; above it the f32
    assembly runs feature-chunked. Read at call time (env
    LINEARSFM_DENSE_W_BYTES), default 512 MB as in the reference."""
    return int(os.environ.get("LINEARSFM_DENSE_W_BYTES", 1 << 29))


def _bmv(a, v):
    """[..., i, k] @ [..., k] -> [..., i]."""
    return (a @ v[..., None])[..., 0]


def _bmv_t(a, v):
    """a^T v: [..., k, i] x [..., k] -> [..., i]."""
    return (a.transpose(-1, -2) @ v[..., None])[..., 0]


def inv3x3_sym(V: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of symmetric 3x3 blocks; exactly-singular
    blocks (zero padding) return zero."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 1], V[..., 1, 2], V[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    det = a * A + b * B + c * C
    zero = det == 0
    inv_det = torch.where(zero, torch.zeros_like(det),
                          1.0 / torch.where(zero, torch.ones_like(det), det))
    row0 = torch.stack([A, B, C], dim=-1)
    row1 = torch.stack([B, D, E], dim=-1)
    row2 = torch.stack([C, E, F], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) * inv_det[..., None, None]


def info_vector(poses, feats, U, Uij, W, Wpf, V):
    """(eP [P,M,6], eF [P,N,3]) = I @ x, accumulated blockwise in the
    information dtype (the states are cast to it)."""
    poses = poses.to(U.dtype)
    feats = feats.to(U.dtype)
    M, N = poses.shape[1], feats.shape[1]
    ui, uj = Uij[..., 0], Uij[..., 1]
    wp, wf = Wpf[..., 0], Wpf[..., 1]
    offd = (ui != uj)[..., None]
    eP = seg_sum(_bmv(U, take(poses, uj)), ui, M)
    eP += seg_sum(torch.where(offd, _bmv_t(U, take(poses, ui)),
                              U.new_zeros(())), uj, M)
    eP += seg_sum(_bmv(W, take(feats, wf)), wp, M)
    eF = _bmv(V, feats)
    eF += seg_sum(_bmv_t(W, take(poses, wp)), wf, N)
    return eP, eF


# Dense [P, R*M, C*N] from lane-stacked block-COO lists (scatter-add, rows < 0
# skipped): kernel K1 on a CUDA tensor, its plain version on the CPU. Unlike
# the reference, whose TPU kernel is float32-only, float64 lists use it too.
densify_blocks = kernels.blockcoo_to_dense


def _require_full_f32(device: torch.device):
    """The f32 Schur products must not run in TF32 on the GPU (the
    counterpart of the reference's highest matmul precision)."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 must be "
                           "False: the Schur preconditioner needs full f32")


def _assemble_schur_dense(U, Uij, W, Wpf, Vinv, eP, eF, M: int):
    """S [P, 6M, 6M] = A - (W Vinv) W^T and E [P, 6M] = eP - (W Vinv) eF,
    through dense [6M, 3N] layouts of W and Y = W Vinv.

    float32 (the preconditioner side): zero-valued entries are routed to
    row -1, and A's symmetric completion is D + D^T with the double-counted
    diagonal blocks taken off (`sym_complete`). Above `dense_w_bytes()` per
    lane the feature axis is cut into stripes: S and E accumulate stripe by
    stripe, bounding the live set by two stripes. float64 (the plain-Cholesky
    levels) densifies A's transposed blocks directly, as the reference does.
    """
    P, N = Vinv.shape[0], Vinv.shape[1]
    dtype, dev = U.dtype, U.device
    ui, uj = Uij[..., 0], Uij[..., 1]
    wp, wf = Wpf[..., 0], Wpf[..., 1]
    Yb = W @ take(Vinv, wf)

    if dtype != torch.float32:
        A = densify_blocks(ui, uj, U, M, M)
        Uo = torch.where((ui != uj)[..., None, None], U, U.new_zeros(()))
        A += densify_blocks(uj, ui, Uo.transpose(-1, -2).contiguous(), M, M)
        Wd = densify_blocks(wp, wf, W, M, N)
        Yd = densify_blocks(wp, wf, Yb, M, N)
        S = A - Yd @ Wd.transpose(-1, -2)
        E = eP.reshape(P, -1) - _bmv(Yd, eF.reshape(P, -1))
        return S, E

    _require_full_f32(dev)

    def sym_complete(D, urow):
        """A = D + D^T minus the double-counted diagonal blocks, which are
        accumulated as a [P, M, 6, 6] segment sum, symmetrised, and taken
        off the block diagonal."""
        dmask = (ui == uj) & (urow >= 0)
        diag = seg_sum(torch.where(dmask[..., None, None], U, U.new_zeros(())),
                       torch.where(dmask, ui, M), M)
        corr = 0.5 * (diag + diag.transpose(-1, -2))
        A = D + D.transpose(-1, -2)
        i6 = torch.arange(M, device=dev)[:, None, None] * 6
        r6 = torch.arange(6, device=dev)
        rows = (i6 + r6[None, :, None]).expand(M, 6, 6)
        cols = (i6 + r6[None, None, :]).expand(M, 6, 6)
        A[:, rows, cols] -= corr
        return A

    # zero-valued entries (list padding, dropped couplings) go to row -1
    urow = torch.where((U != 0).any(dim=(-1, -2)), ui, -1)
    S = sym_complete(densify_blocks(urow, uj, U, M, M), urow)
    wvalid = (W != 0).any(dim=(-1, -2))
    E = eP.reshape(P, -1).to(dtype)
    budget = dense_w_bytes()
    if 6 * M * 3 * N * 4 <= budget:
        wrow = torch.where(wvalid, wp, -1)
        Wd = densify_blocks(wrow, wf, W, M, N)
        Yd = densify_blocks(wrow, wf, Yb, M, N)
        # in place: S is [12288, 12288] f32 (0.6 GB) at the 2,048-map root
        S.baddbmm_(Yd, Wd.transpose(-1, -2), alpha=-1.0)
        return S, E - _bmv(Yd, eF.reshape(P, -1))

    nch = -(-(6 * M * 3 * N * 4) // budget)
    Nc = -(-N // nch)
    nch = -(-N // Nc)
    eFp = torch.nn.functional.pad(eF, (0, 0, 0, Nc * nch - N))
    for c in range(nch):
        lo = c * Nc
        own = wvalid & (wf >= lo) & (wf < lo + Nc)
        wrow = torch.where(own, wp, -1)
        wcol = torch.clamp(wf - lo, 0, Nc - 1)
        Wd = densify_blocks(wrow, wcol, W, M, Nc)
        Yd = densify_blocks(wrow, wcol, Yb, M, Nc)
        S.baddbmm_(Yd, Wd.transpose(-1, -2), alpha=-1.0)
        E = E - _bmv(Yd, eFp[:, lo:lo + Nc].reshape(P, -1))
        del Wd, Yd
    return S, E


def solve_full_mixed(U, Uij, W, Wpf, V, eP, eF, M: int, fixed_mask, *,
                     iters: int = 3, fixc=None, sign=None,
                     escalate_iters: int = 0, escalate_tol: float = 1e-8,
                     exit_tol: float = 0.0):
    """Mixed-precision fusion solve of every lane: f32 Schur factor + f64 PCG.

    matvec:   r = I x through the f64 block lists;
    M^{-1} r: dx_p = S32^{-1}(r_P - W V^{-1} r_F),
              dx_f = V32^{-1}(r_F - W^T dx_p)   (all f32).

    The f32 factor is of the equilibrated S (unit diagonal) plus a 4 eps_f32
    jitter, which keeps it positive definite when S is numerically
    indefinite in f32; a lane whose factorisation still fails turns NaN (its
    residual shows it) instead of aborting the level.

    Args (P lanes): U..eF the block lists and information vectors in the
      accumulation dtype; fixed_mask bool [P, 6M] (True = gauge-fixed);
      fixc/sign [P]: mono scale pin (flat coordinate and its +-1 value).
      iters: PCG sweeps (a cap when exit_tol > 0). exit_tol > 0 stops each
      lane as soon as its squared residual is <= (exit_tol ||e||)^2; a lane
      that has stopped is frozen while others continue, as the reference's
      vmapped while_loop does. escalate_iters > 0 runs that many more sweeps
      on the lanes whose relative residual is > escalate_tol (a per-lane
      select, as the vmapped lax.cond).

    Returns (x_p [P,M,6], x_f [P,N,3], res_rel [P]) in the input dtype;
    res_rel is the final full-system relative residual ||e - I x|| / ||e||.
    """
    dt = U.dtype
    f32 = torch.float32
    P, N = V.shape[0], V.shape[1]
    dev = U.device
    wp, wf = Wpf[..., 0], Wpf[..., 1]
    lane = torch.arange(P, device=dev)

    U32, W32, V32 = U.to(f32), W.to(f32), V.to(f32)
    Vinv32 = inv3x3_sym(V32)
    S32, E32 = _assemble_schur_dense(U32, Uij, W32, Wpf, Vinv32, eP.to(f32),
                                     eF.to(f32), M)
    if fixc is not None:
        E32 = E32 - S32[lane, :, fixc] * sign.to(f32)[:, None]
    S32, E32 = solve.mask_gauge(S32, E32, fixed_mask)
    # equilibrate + jitter: Ss = D S D with D = diag(S)^{-1/2}
    d32 = S32.diagonal(dim1=-2, dim2=-1)
    dsc = torch.where(d32 > 0, torch.rsqrt(torch.clamp_min(d32, 1e-30)),
                      torch.ones_like(d32))
    Ss = S32.mul_(dsc[:, :, None]).mul_(dsc[:, None, :])   # S32 not used again
    Ss.diagonal(dim1=-2, dim2=-1).add_(4 * torch.finfo(f32).eps)
    L, info = torch.linalg.cholesky_ex(Ss)
    del Ss, S32
    L = torch.where((info != 0)[:, None, None], torch.nan, L)

    def sch32(rhs32):
        # both triangular solves on the one factor L
        return dsc * torch.cholesky_solve((rhs32 * dsc)[..., None], L)[..., 0]

    freeP = ~fixed_mask.reshape(P, M, 6)
    if fixc is not None:
        freeP = freeP.reshape(P, -1).clone()
        freeP[lane, fixc] = False
        freeP = freeP.reshape(P, M, 6)

    def pin(xp):
        if fixc is None:
            return xp
        flat = xp.reshape(P, -1).clone()
        flat[lane, fixc] = sign.to(xp.dtype)
        return flat.reshape(P, M, 6)

    zero = U.new_zeros(())
    xp0 = pin(sch32(E32).reshape(P, M, 6).to(dt))
    xf0 = backsub_features(W32, Wpf, Vinv32, eF.to(f32), xp0.to(f32)).to(dt)
    Y32 = W32 @ take(Vinv32, wf)

    def precond(rP, rF):
        """M^{-1} r with the f32 Schur factor; zero at fixed coordinates."""
        rF32 = rF.to(f32)
        red = rP.to(f32) - seg_sum(_bmv(Y32, take(rF32, wf)), wp, M)
        red = torch.where(freeP, red, red.new_zeros(()))
        dxp = sch32(red.reshape(P, -1)).reshape(P, M, 6)
        dxp = torch.where(freeP, dxp, dxp.new_zeros(()))
        wtx = seg_sum(_bmv_t(W32, take(dxp, wp)), wf, N)
        dxf = _bmv(Vinv32, rF32 - wtx)
        return dxp.to(dt), dxf.to(dt)

    def matvec(xp, xf):
        iP, iF = info_vector(xp, xf, U, Uij, W, Wpf, V)
        return torch.where(freeP, iP, zero), iF

    def dot(aP, aF, bP, bF):
        return (aP * bP).sum(dim=(1, 2)) + (aF * bF).sum(dim=(1, 2))

    # initial residual of the full system at (xp0, xf0), fixed coords pinned
    iP, iF = info_vector(xp0, xf0, U, Uij, W, Wpf, V)
    rP = torch.where(freeP, eP - iP, zero)
    rF = eF - iF
    zP, zF = precond(rP, rF)
    rz0 = dot(rP, rF, zP, zF)
    tiny = torch.finfo(dt).tiny
    eP_free = torch.where(freeP, eP, zero)
    enorm = torch.clamp_min(torch.sqrt(dot(eP_free, eF, eP_free, eF)), tiny)

    def body(c):
        xp, xf, rP, rF, pP, pF, rz, _res2, i = c
        qP, qF = matvec(pP, pF)
        pq = dot(pP, pF, qP, qF)
        alpha = torch.where(pq > 0, rz / torch.clamp_min(pq, tiny), zero)
        a3 = alpha[:, None, None]
        xp, xf = xp + a3 * pP, xf + a3 * pF
        rP, rF = rP - a3 * qP, rF - a3 * qF
        zP, zF = precond(rP, rF)
        rz_new = dot(rP, rF, zP, zF)
        beta = torch.where(rz > 0, rz_new / torch.clamp_min(rz, tiny), zero)
        b3 = beta[:, None, None]
        return (xp, xf, rP, rF, zP + b3 * pP, zF + b3 * pF, rz_new,
                dot(rP, rF, rP, rF), i + 1)

    def select(mask, new, old):
        return tuple(lane_where(mask, n, o) for n, o in zip(new, old))

    carry = (xp0, xf0, rP, rF, zP, zF, rz0, dot(rP, rF, rP, rF),
             torch.zeros(P, dtype=torch.int64, device=dev))
    if exit_tol:
        tol2 = (exit_tol * enorm) ** 2
        while True:
            active = (carry[8] < iters) & (carry[7] > tol2)
            if not bool(active.any()):
                break
            carry = select(active, body(carry), carry)
    else:
        for _ in range(iters):
            carry = body(carry)

    def res(c):
        return torch.sqrt(c[7]) / enorm

    if escalate_iters:
        # NaN > tol is False: a lane whose residual is NaN is not escalated
        # (more sweeps cannot repair a failed factor); the NaN stays in the
        # returned residual, which the tree executor reports unmasked.
        esc = res(carry) > escalate_tol
        if bool(esc.any()):
            more = carry
            for _ in range(escalate_iters):
                more = body(more)
            carry = select(esc, more, carry)
    return pin(carry[0]), carry[1], res(carry)


def backsub_features(W, Wpf, Vinv, eF, x_poses):
    """x_f = Vinv_f (eF_f - sum W^T x_p)."""
    x_poses = x_poses.to(W.dtype)
    N = Vinv.shape[1]
    wp, wf = Wpf[..., 0], Wpf[..., 1]
    wtx = seg_sum(_bmv_t(W, take(x_poses, wp)), wf, N)
    return _bmv(Vinv, eF - wtx)
