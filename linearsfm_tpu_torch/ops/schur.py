"""Information-form fusion solve: the feature-Schur complement.

Counterpart of `linearsfm_tpu/ops/schur.py`: the feature-block inverses
fused with Y = W Vinv[wf] (`inv3x3_wy`, kernel K2), the reduced camera
system `assemble_schur` — grouped per feature (`group_by_feature`) below
`_DENSE_SCHUR_DIM` unless dense is forced, else the dense assembly
(`_assemble_schur_dense`: A through kernel K1, and in float32 the Schur
product from the W block list, kernel K4) — the mixed-precision solve
`solve_full_mixed` (f32 Schur Cholesky preconditioning an f64 PCG on the
full information system), and the feature back-substitution. The device
tree always assembles dense; the host executor's joins choose by size, as
the reference does.

Every operand carries the leading lane dimension P: one call solves every
pair of a tree level. Block lists are zero-padded; padding contributes
nothing.
"""

from __future__ import annotations

import torch

from ..utils import metrics
from . import kernels, solve
from .segment import index_add, lane_ids, lane_where, seg_sum, take

# From this scalar dimension of the reduced system up, `assemble_schur`
# assembles dense (the reference's threshold).
_DENSE_SCHUR_DIM = 1024

# Feature-chunking budget of the grouped assembly: the pairwise products of
# one chunk, [P, chunk, O, O, 6, 6], hold at most this many 6x6 blocks over
# all lanes (288 MB in float64). The reference counts 2**16 blocks per lane
# (a 6x6 block fills a whole TPU tile there); here a block is 36 values.
_SCHUR_CHUNK_BLOCKS = 1 << 20


def bmv(a, v):
    """[..., i, k] @ [..., k] -> [..., i]."""
    return (a @ v[..., None])[..., 0]


def bmv_t(a, v):
    """a^T v: [..., k, i] x [..., k] -> [..., i]."""
    return (a.transpose(-1, -2) @ v[..., None])[..., 0]


def inv3x3_wy(V, W, Wpf):
    """(Vinv, Y): the closed-form inverses Vinv [P, N, 3, 3] of the
    symmetric feature blocks (exactly-singular padding blocks give zero) and
    the blocks Y = W @ Vinv[wf] [P, K, 6, 3] of every W entry, from one
    launch of kernel K2 on a CUDA tensor (its plain version on the CPU).
    Vinv serves the preconditioner and the back-substitution, Y the dense
    assembly and the preconditioner. Unlike the reference, which runs the
    jnp inverse (its `inv3x3_sym`) in production and gathers Vinv[wf] for a
    batched product, every join on the GPU goes through the kernel."""
    return kernels.inv3x3_wy(V.contiguous(), W.contiguous(),
                             Wpf.contiguous())


def info_vector(poses, feats, U, Uij, W, Wpf, V):
    """(eP [P,M,6], eF [P,N,3]) = I @ x, accumulated blockwise in the
    information dtype (the states are cast to it). V None leaves out the
    feature blocks' term (a shard's part of the product, whose V term is
    added once after the sum)."""
    poses = poses.to(U.dtype)
    feats = feats.to(U.dtype)
    M, N = poses.shape[1], feats.shape[1]
    ui, uj = Uij[..., 0], Uij[..., 1]
    wp, wf = Wpf[..., 0], Wpf[..., 1]
    offd = (ui != uj)[..., None]
    eP = seg_sum(bmv(U, take(poses, uj)), ui, M)
    eP += seg_sum(torch.where(offd, bmv_t(U, take(poses, ui)),
                              U.new_zeros(())), uj, M)
    eP += seg_sum(bmv(W, take(feats, wf)), wp, M)
    eF = bmv(V, feats) if V is not None else torch.zeros_like(feats)
    eF += seg_sum(bmv_t(W, take(poses, wp)), wf, N)
    return eP, eF


# Dense [P, R*M, C*N] from lane-stacked block-COO lists (scatter-add, rows < 0
# skipped): kernel K1 on a CUDA tensor, its plain version on the CPU. Unlike
# the reference, whose TPU kernel is float32-only, float64 lists use it too.
# densify_planned is K1 on a list sorted once (kernels.coo_plan), for lists
# that are densified more than once.
densify_blocks = kernels.blockcoo_to_dense
densify_planned = kernels.blockcoo_to_dense_planned


def require_full_f32(device: torch.device):
    """The f32 Schur products must not run in TF32 on the GPU (the
    counterpart of the reference's highest matmul precision)."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 must be "
                           "False: the Schur preconditioner needs full f32")


def dense_a32(U, Uij, M: int):
    """The pose block A [P, 6M, 6M] of float32 U lists, through kernel K1:
    zero-valued entries (list padding, dropped couplings) go to row -1, and
    the symmetric completion is D + D^T with the double-counted diagonal
    blocks, accumulated as a [P, M, 6, 6] segment sum and symmetrised,
    taken off the block diagonal."""
    ui, uj = Uij[..., 0], Uij[..., 1]
    dev = U.device
    urow = torch.where((U != 0).any(dim=(-1, -2)), ui, -1)
    D = densify_blocks(urow, uj, U, M, M)
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


def _assemble_schur_dense(U, Uij, W, Wpf, Yb, eP, eF, M: int):
    """S [P, 6M, 6M] = A - (W Vinv) W^T and E [P, 6M] = eP - (W Vinv) eF.

    Yb: the blocks W @ Vinv[wf] of the W list (`inv3x3_wy`), where the
    reference takes Vinv and forms them here. float32 (the preconditioner
    side): A from `dense_a32`, then kernel K4 (`kernels.schur_pairs`) sums,
    in a fixed order, Y_(p,f) W_(q,f)^T over the pairs of W entries that
    share a feature into block (p, q) and subtracts the sum from A (E the
    same with Y_(p,f) eF_f), over the list's plan (`w_plan`): the nonzero
    products alone, where the reference multiplies dense [6M, 3N] layouts
    of W and Y that are almost all zeros. float64 (the plain-Cholesky levels) densifies A's
    transposed blocks, W and Y through K1 (one sort of the W list,
    `kernels.coo_plan`) and multiplies them, as the reference does.
    """
    P, N = eF.shape[0], eF.shape[1]
    dtype, dev = U.dtype, U.device
    ui, uj = Uij[..., 0], Uij[..., 1]
    wp, wf = Wpf[..., 0], Wpf[..., 1]

    if dtype != torch.float32:
        # a span with the device's time (`utils/metrics.device_span`) and
        # the shapes that the assembly's least bytes are counted from
        with metrics.device_span("schur_f64", dev, P=P, M=M, N=N,
                                 KU=U.shape[1], KW=W.shape[1]):
            A = densify_blocks(ui, uj, U, M, M)
            Uo = torch.where((ui != uj)[..., None, None], U, U.new_zeros(()))
            A += densify_blocks(uj, ui, Uo.transpose(-1, -2).contiguous(), M,
                                M)
            wplan = kernels.coo_plan(wp, wf, M, N)
            Wd = densify_planned(wplan, W)
            Yd = densify_planned(wplan, Yb)
            S = A - Yd @ Wd.transpose(-1, -2)
            E = eP.reshape(P, -1) - bmv(Yd, eF.reshape(P, -1))
        return S, E

    require_full_f32(dev)
    S = dense_a32(U, Uij, M)
    E = eP.reshape(P, -1).to(dtype, copy=True).contiguous()
    return kernels.schur_pairs(S, E, W.contiguous(), Yb.contiguous(),
                               eF.contiguous(), w_plan(W, Wpf, M, N))


def w_plan(W, Wpf, M: int, N: int) -> kernels.CooPlan:
    """K1's plan of a float32 W list, zero-valued entries to row -1 (they
    leave the plan): K4 walks it."""
    wp, wf = Wpf[..., 0], Wpf[..., 1]
    return kernels.coo_plan(torch.where((W != 0).any(dim=(-1, -2)), wp, -1),
                            wf, M, N)


def group_by_feature(Wpf, N: int, max_obs: int, entry_valid=None):
    """Static-shape grouping of each lane's W entries by feature.

    Returns (entry [P, N, max_obs], valid [P, N, max_obs], overflowed [P]):
    entry selects the W entries of each feature (in list order, padded with
    0), valid marks the real ones. `entry_valid` [P, KW] masks padding
    entries (they would otherwise crowd the bucket of feature 0). A valid
    entry beyond `max_obs` for its feature sets its lane's `overflowed`, and
    `assemble_schur` then poisons that lane with NaN: callers size max_obs
    from the lists (the host executor's `_max_obs_per_feature` is exact),
    and an undersized bound shows as NaN, never as a quietly wrong sum.
    """
    P, KW = Wpf.shape[:2]
    dev = Wpf.device
    f = Wpf[..., 1]
    if entry_valid is not None:
        f = torch.where(entry_valid, f, N)     # padding to a dummy bucket
    # rank within a feature = position in the stable sort - first position
    fs, order = torch.sort(f, dim=1, stable=True)
    pos = torch.arange(KW, device=dev).expand(P, KW)
    rank = pos - torch.searchsorted(fs, fs)
    real = (fs >= 0) & (fs < N)
    ok = real & (rank < max_obs)
    overflowed = (real & (rank >= max_obs)).any(dim=1)
    # the rest go to slot (N, 0), sliced off
    slot = (torch.where(ok, fs, N) * max_obs + torch.where(ok, rank, 0)
            + lane_ids(P, dev) * ((N + 1) * max_obs))
    entry = torch.zeros(P * (N + 1) * max_obs, dtype=order.dtype, device=dev)
    entry.scatter_(0, slot.reshape(-1), torch.where(ok, order, 0).reshape(-1))
    valid = torch.zeros(P * (N + 1) * max_obs, dtype=torch.bool, device=dev)
    valid.scatter_(0, slot.reshape(-1), ok.reshape(-1))
    shape = (P, N + 1, max_obs)
    return (entry.view(shape)[:, :N], valid.view(shape)[:, :N], overflowed)


def assemble_schur(U, Uij, W, Wpf, Yb, eP, eF, M: int, max_obs: int,
                   force_dense: bool = False):
    """Reduced camera system of every lane: S [P, 6M, 6M], E [P, 6M].

    S = scatter(U) - sum_f W_f Vinv_f W_f^T, E = eP - (W Vinv) eF, from the
    blocks Yb = W Vinv[wf] of the W list (`inv3x3_wy`). Below
    `_DENSE_SCHUR_DIM` (and unless `force_dense`) S is summed per feature
    over the pairs of its observations, grouped with a static bound
    `max_obs` (the reference's per-feature double loop,
    LinearSFMImp.cpp:2244-2332); above it, or forced (the device tree, which
    keeps no per-level max_obs), the dense assembly runs.
    """
    if force_dense or 6 * M >= _DENSE_SCHUR_DIM:
        return _assemble_schur_dense(U, Uij, W, Wpf, Yb, eP, eF, M)
    P, N = eF.shape[0], eF.shape[1]
    wp, wf = Wpf[..., 0], Wpf[..., 1]
    S = u_blocks(U, Uij, M)
    Wg, pg, flat, scale = group_w(W, Wpf, M, N, max_obs)
    Yg = take(Yb, flat).view(P, N, max_obs, 6, 3) * scale[..., None, None]
    S = subtract_pairs(S, Yg, Wg, pg, M)
    E = eP - seg_sum(bmv(Yb, take(eF, wf)), wp, M)
    return S, E.reshape(P, 6 * M)


def u_blocks(U, Uij, M: int):
    """The U lists as [P, M*M, 6, 6] blocks (row-block i, column-block j
    at i*M + j), off-diagonal blocks completed by their transposes."""
    ui, uj = Uij[..., 0], Uij[..., 1]
    inside = (ui >= 0) & (ui < M) & (uj >= 0) & (uj < M)
    S = seg_sum(U, torch.where(inside, ui * M + uj, -1), M * M)
    S += seg_sum(torch.where((ui != uj)[..., None, None], U.transpose(-1, -2),
                             U.new_zeros(())),
                 torch.where(inside, uj * M + ui, -1), M * M)
    return S


def group_w(W, Wpf, M: int, N: int, max_obs: int):
    """Each lane's W entries grouped by feature (`group_by_feature`; entries
    with an exactly-zero block, padding and dropped couplings, are left out
    so that they crowd no feature bucket). Returns (Wg [P, N, O, 6, 3], pg
    [P, N, O] their poses, flat [P, N*O] their list indices, scale [P, N,
    O]): empty slots scale to zero, and an undersized max_obs, which would
    drop Schur terms, poisons its lane with NaN."""
    P = Wpf.shape[0]
    entry, valid, overflowed = group_by_feature(
        Wpf, N, max_obs, entry_valid=(W != 0).any(dim=(-1, -2)))
    poison = torch.where(overflowed, torch.nan, 1.0).to(W.dtype)
    scale = valid.to(W.dtype) * poison[:, None, None]            # [P, N, O]
    flat = entry.reshape(P, -1)
    Wg = take(W, flat).view(P, N, max_obs, 6, 3) * scale[..., None, None]
    pg = torch.clamp(take(Wpf[..., 0], flat).view(P, N, max_obs), 0, M - 1)
    return Wg, pg, flat, scale


def subtract_pairs(S, Yg, Wg, pg, M: int):
    """S [P, M*M, 6, 6] (overwritten) minus the pairwise products
    Y_o W_q^T of each feature's observations o, q at block (p_o, p_q),
    accumulated in feature chunks (the [P, N, O, O, 6, 6] tensor is too
    large to hold whole at the upper levels); returns S as [P, 6M, 6M]."""
    P, N, O = pg.shape
    S = S.reshape(P * M * M, 6, 6)
    base = lane_ids(P, S.device)[:, :, None, None] * (M * M)
    chunk = max(1, min(N, _SCHUR_CHUNK_BLOCKS // max(1, P * O ** 2)))
    for lo in range(0, N, chunk):
        Yc, Wc, pc = Yg[:, lo:lo + chunk], Wg[:, lo:lo + chunk], pg[:, lo:lo + chunk]
        C = Yc[:, :, :, None] @ Wc[:, :, None].transpose(-1, -2)
        key = base + pc[..., :, None] * M + pc[..., None, :]
        index_add(S, key.reshape(-1), C.reshape(-1, 6, 6), alpha=-1)
    return S.view(P, M, M, 6, 6).permute(0, 1, 3, 2, 4).reshape(P, 6 * M,
                                                                 6 * M)


def solve_full_mixed(U, Uij, W, Wpf, V, eP, eF, M: int, fixed_mask, *,
                     max_obs: int = 1, force_dense: bool = False,
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
      max_obs, force_dense: how the f32 Schur matrix is assembled
      (`assemble_schur`: grouped below `_DENSE_SCHUR_DIM` by default, as
      the reference; the device tree's joins pass force_dense=True);
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
    wp, wf = Wpf[..., 0], Wpf[..., 1]

    U32, W32, V32 = U.to(f32), W.to(f32), V.to(f32)
    # one K2 launch: Y32 = W Vinv32[wf] is the assembly's Yb and the PCG's Y
    Vinv32, Y32 = inv3x3_wy(V32, W32, Wpf)
    # the caller keeps no reference to S32: the factor's masked copy
    # replaces it (0.6 GB at the 2,048-map root)
    sch32, E32 = precond_factor(
        *assemble_schur(U32, Uij, W32, Wpf, Y32, eP.to(f32), eF.to(f32), M,
                        max_obs, force_dense=force_dense),
        fixed_mask, fixc, sign)
    freeP = free_poses(fixed_mask, M, fixc)

    def pin(xp):
        return xp if fixc is None else pin_coordinate(xp, fixc, sign)

    zero = U.new_zeros(())
    xp0 = pin(sch32(E32).reshape(P, M, 6).to(dt))
    xf0 = backsub_features(W32, Wpf, Vinv32, eF.to(f32), xp0.to(f32)).to(dt)

    def precond(rP, rF):
        """M^{-1} r with the f32 Schur factor; zero at fixed coordinates."""
        rF32 = rF.to(f32)
        red = rP.to(f32) - seg_sum(bmv(Y32, take(rF32, wf)), wp, M)
        red = torch.where(freeP, red, red.new_zeros(()))
        dxp = sch32(red.reshape(P, -1)).reshape(P, M, 6)
        dxp = torch.where(freeP, dxp, dxp.new_zeros(()))
        wtx = seg_sum(bmv_t(W32, take(dxp, wp)), wf, N)
        dxf = bmv(Vinv32, rF32 - wtx)
        return dxp.to(dt), dxf.to(dt)

    def matvec(xp, xf):
        iP, iF = info_vector(xp, xf, U, Uij, W, Wpf, V)
        return torch.where(freeP, iP, zero), iF

    xp, xf, res = pcg(matvec, precond, xp0, xf0, eP, eF, freeP, iters=iters,
                      exit_tol=exit_tol, escalate_iters=escalate_iters,
                      escalate_tol=escalate_tol)
    return pin(xp), xf, res


def precond_factor(S32, E32, fixed_mask, fixc=None, sign=None):
    """(sch32, E32) for the PCG's preconditioner, from the f32 reduced
    system S32 [P, d, d] (overwritten) and E32 [P, d]: the mono pin moves
    the pinned column to the right-hand side (E32 -= S32[:, fixc] sign),
    the gauge is masked (`solve.mask_gauge`), and S is equilibrated, Ss =
    D S D with D = diag(S)^{-1/2}, plus a 4 eps_f32 jitter on the diagonal,
    which keeps it positive definite when S is numerically indefinite in
    f32; a lane whose factorisation still fails turns NaN. sch32(rhs32)
    applies S^{-1} through the one f32 Cholesky factor."""
    f32 = torch.float32
    P = S32.shape[0]
    if fixc is not None:
        lane = torch.arange(P, device=S32.device)
        E32 = E32 - S32[lane, :, fixc] * sign.to(f32)[:, None]
    S32, E32 = solve.mask_gauge(S32, E32, fixed_mask)
    d32 = S32.diagonal(dim1=-2, dim2=-1)
    dsc = torch.where(d32 > 0, torch.rsqrt(torch.clamp_min(d32, 1e-30)),
                      torch.ones_like(d32))
    Ss = S32.mul_(dsc[:, :, None]).mul_(dsc[:, None, :])   # S32 not used again
    Ss.diagonal(dim1=-2, dim2=-1).add_(4 * torch.finfo(f32).eps)
    L, info = torch.linalg.cholesky_ex(Ss)
    del Ss, S32
    L = torch.where((info != 0)[:, None, None], torch.nan, L)

    def sch32(rhs32):
        # both triangular solves on the one factor L; not
        # torch.cholesky_solve, which fails on the H100 for the batch of two
        # 12,288-wide factors of the 3,499-map stereo tree's level 11
        return dsc * solve.solve_factored(L, rhs32 * dsc)
    return sch32, E32


def free_poses(fixed_mask, M: int, fixc=None):
    """[P, M, 6] True at the pose coordinates the solve moves: not
    gauge-fixed, and not the mono pin's coordinate fixc [P]."""
    P = fixed_mask.shape[0]
    freeP = ~fixed_mask.reshape(P, M, 6)
    if fixc is not None:
        freeP = freeP.reshape(P, -1).clone()
        freeP[torch.arange(P, device=fixed_mask.device), fixc] = False
        freeP = freeP.reshape(P, M, 6)
    return freeP


def pcg(matvec, precond, xp0, xf0, eP, eF, freeP, *, iters: int,
        exit_tol: float = 0.0, escalate_iters: int = 0,
        escalate_tol: float = 1e-8):
    """The f64 PCG of `solve_full_mixed` on every lane, from (xp0, xf0).

    matvec(xp, xf) -> (I x)_P masked to freeP, (I x)_F; precond(rP, rF) ->
    M^{-1} r. iters sweeps, or with exit_tol > 0 at most iters, each lane
    stopping (frozen while others go on) once its squared residual is <=
    (exit_tol ||e||)^2; then escalate_iters more sweeps on the lanes whose
    relative residual is > escalate_tol. Returns (x_p, x_f, res_rel [P]).
    Counts each sweep (`pcg_sweeps`) and each escalation
    (`pcg_escalations`), and spans each read of a flag from the device
    (`sync`), in the open solve's recorder (`utils/metrics`)."""
    dt, dev, P = eP.dtype, eP.device, eP.shape[0]
    zero = eP.new_zeros(())

    def dot(aP, aF, bP, bF):
        return (aP * bP).sum(dim=(1, 2)) + (aF * bF).sum(dim=(1, 2))

    # initial residual of the full system at (xp0, xf0), fixed coords pinned
    iP, iF = matvec(xp0, xf0)
    rP = torch.where(freeP, eP - iP, zero)
    rF = eF - iF
    zP, zF = precond(rP, rF)
    rz0 = dot(rP, rF, zP, zF)
    tiny = torch.finfo(dt).tiny
    eP_free = torch.where(freeP, eP, zero)
    enorm = torch.clamp_min(torch.sqrt(dot(eP_free, eF, eP_free, eF)), tiny)

    def body(c):
        metrics.count("pcg_sweeps")
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
            with metrics.span("sync"):
                go = bool(active.any())
            if not go:
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
        with metrics.span("sync"):
            go = bool(esc.any())
        if go:
            metrics.count("pcg_escalations")
            more = carry
            for _ in range(escalate_iters):
                more = body(more)
            carry = select(esc, more, carry)
    return carry[0], carry[1], res(carry)


def pin_coordinate(xp: torch.Tensor, fixc: torch.Tensor,
                   sign: torch.Tensor) -> torch.Tensor:
    """Copy of the poses xp [P, M, 6] with flat coordinate fixc[p] set to
    sign[p] exactly (the mono scale pin)."""
    P = xp.shape[0]
    flat = xp.reshape(P, -1).clone()
    flat[torch.arange(P, device=xp.device), fixc] = sign.to(xp.dtype)
    return flat.reshape(xp.shape)


def backsub_features(W, Wpf, Vinv, eF, x_poses):
    """x_f = Vinv_f (eF_f - sum W^T x_p)."""
    x_poses = x_poses.to(W.dtype)
    N = Vinv.shape[1]
    wp, wf = Wpf[..., 0], Wpf[..., 1]
    wtx = seg_sum(bmv_t(W, take(x_poses, wp)), wf, N)
    return bmv(Vinv, eF - wtx)
