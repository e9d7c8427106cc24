"""Feature-sharded Schur assembly and solve: the root joins over a mesh.

Counterpart of `linearsfm_tpu/parallel/shard_solve.py`. The root joins'
Schur contributions ``sum_f W_f Vinv_f W_f^T`` dominate their assembly, so
the feature axis is cut over the shards of a `parallel/mesh.Mesh`: shard d
computes the partial reduced camera system of the features it owns, the
partials are summed (`Mesh.psum`), the solve runs once on ``devices[0]``
(the reference's replicated factor), and the feature terms are sharded
again.

* `sharded_schur_solve`: the grouped (max_obs) assembly with a direct or
  refined Cholesky solve; each shard inverts its own feature blocks (kernel
  K2 with no W entries).
* `sharded_full_mixed`: the production root solve, the f32 Schur factor
  preconditioning the f64 PCG on the full information system, as
  `ops/schur.solve_full_mixed`. Each shard launches K2 once over its W
  entries (V^-1 and Y = W V^-1[wf]) and assembles its part of the f32
  Schur matrix as the joins do (`schur.assemble_schur`, dense: K1 for A,
  K4 on its own plan of the W entries it owns); every PCG sweep sums the
  shards' parts of the matvec and of the preconditioner.

Ownership, as the reference's: W entries belong to the shard that owns
their feature (features [d Nl, d Nl + Nl), Nl = ceil(N / nd)); U entries
are dealt round-robin by list index (`sharded_schur_solve`: all on shard
0); the V term is added once, after the sum. Both take the one lane of a
single-pair join ([1, ...] operands, as the port's joins pass them) and
raise on more.
"""

from __future__ import annotations

import torch

from ..ops import kernels, schur, solve
from ..ops.segment import seg_sum, take
from .mesh import Mesh, feature_window


def _one_lane(name: str, V: torch.Tensor):
    if V.shape[0] != 1:
        raise ValueError(f"{name}: one pair per call (the feature-sharded "
                         f"solve is for single-pair joins), got "
                         f"{V.shape[0]} lanes")


def sharded_schur_solve(U, Uij, W, Wpf, V, eP, eF, M: int, max_obs: int,
                        mesh: Mesh, axis: str = "fs", fixed_mask=None,
                        method: str = "direct", refine_iters: int = 3):
    """Assemble S and E with the feature axis sharded over `mesh`, solve
    (`solve.solve_reduced`: "direct" or "refine"), and back-substitute the
    features shard by shard. Operands as `schur.assemble_schur`'s, one lane.
    Returns (x_poses [1, M, 6], x_feats [1, N, 3]). `axis` names the mesh
    axis, as the reference's signature does; the mesh has one."""
    _one_lane("sharded_schur_solve", V)
    N = V.shape[1]
    Nl = feature_window(N, mesh.size)
    d0 = mesh.devices[0]
    Wg, pg, _, _ = schur.group_w(W, Wpf, M, N, max_obs)

    shards = []   # (lo, hi, Wg_s, pg_s, Vinv_s, eF_s) on the shard's device

    def s_parts():
        for d, dev in enumerate(mesh.devices):
            lo, hi = min(d * Nl, N), min(d * Nl + Nl, N)
            with mesh.on(d):
                Wg_s, pg_s = Wg[:, lo:hi].to(dev), pg[:, lo:hi].to(dev)
                eF_s = eF[:, lo:hi].to(dev)
                # U on shard 0 only: the sum would count it nd times
                S = (schur.u_blocks(U.to(dev), Uij.to(dev), M) if d == 0
                     else U.new_zeros((1, M * M, 6, 6), device=dev))
                Vinv_s = kernels.inv3x3_sym(V[:, lo:hi].contiguous().to(dev))
                Yg_s = Wg_s @ Vinv_s[:, :, None]
                S = schur.subtract_pairs(S, Yg_s, Wg_s, pg_s, M)
                ye = (Yg_s @ eF_s[:, :, None, :, None])[..., 0]
                e_parts.append(seg_sum(ye.reshape(1, -1, 6),
                                       pg_s.reshape(1, -1), M))
            shards.append((lo, hi, Wg_s, pg_s, Vinv_s, eF_s))
            yield S

    e_parts = []
    S = mesh.psum(s_parts())
    E = (eP.to(d0) - mesh.psum(e_parts)).reshape(1, 6 * M)
    x = solve.solve_reduced(S, E, fixed_mask=fixed_mask.to(d0)
                            if fixed_mask is not None else None,
                            method=method, refine_iters=refine_iters)
    del S
    xp = x.reshape(1, M, 6)
    xf = []
    for d, (lo, hi, Wg_s, pg_s, Vinv_s, eF_s) in enumerate(shards):
        xg = take(xp.to(Wg_s.device), pg_s.reshape(1, -1))
        wtx = (Wg_s.transpose(-1, -2)
               @ xg.view(1, hi - lo, -1, 6, 1))[..., 0].sum(dim=2)
        xf.append((Vinv_s @ (eF_s - wtx)[..., None])[..., 0].to(d0))
    return xp, torch.cat(xf, dim=1)


def sharded_full_mixed(U, Uij, W, Wpf, V, eP, eF, M: int, fixed_mask,
                       mesh: Mesh, axis: str = "fs", *, iters: int = 16,
                       fixc=None, sign=None, escalate_iters: int = 0,
                       escalate_tol: float = 1e-8, exit_tol: float = 0.0):
    """Feature-sharded mixed-precision fusion solve of one lane: the same
    preconditioner, iteration and pin as `schur.solve_full_mixed` (whose
    arguments it takes; fixc/sign [1] the mono pin), with every O(N) and
    O(K) term computed on the shard that owns it and summed.

    Returns (x_p [1, M, 6], x_f [1, N, 3], res_rel [1]) in the input dtype,
    on ``devices[0]``."""
    _one_lane("sharded_full_mixed", V)
    dt, f32 = U.dtype, torch.float32
    N, KU = V.shape[1], U.shape[1]
    nd, d0 = mesh.size, mesh.devices[0]
    Nl = feature_window(N, nd)
    wf = Wpf[..., 1]
    if fixc is not None:
        fixc, sign = fixc.to(d0), sign.to(d0)
    V32, W32 = V.to(f32), W.to(f32)

    shards = []   # each shard's masked lists, on its device
    e_parts = []

    def s_parts():
        for d, dev in enumerate(mesh.devices):
            lo = d * Nl
            with mesh.on(d):
                sh = dict(Uij=Uij.to(dev), Wpf=Wpf.to(dev))
                own_w = ((wf >= lo) & (wf < lo + Nl)).to(dev)[..., None, None]
                own_u = (torch.arange(KU, device=dev) % nd == d)[None, :,
                                                                  None, None]
                W32o = torch.where(own_w, W32.to(dev), 0.0)
                # one K2 launch over the shard's W entries: V^-1 (all
                # features) and Y = W V^-1[wf] (the shard's entries)
                sh["Vinv32"], sh["Y32"] = schur.inv3x3_wy(V32.to(dev), W32o,
                                                          sh["Wpf"])
                sh["W32"] = W32o
                sh["U64"] = torch.where(own_u, U.to(dev), 0.0)
                sh["W64"] = torch.where(own_w, W.to(dev), 0.0)
                # the joins' dense f32 assembly of the shard's lists: A of
                # its U entries less Y W^T over its W entries (K4 on their
                # own plan, which the zeroed entries leave); from eP = 0,
                # E = -(Y eF), summed
                S, neg = schur.assemble_schur(
                    torch.where(own_u, U.to(dev).to(f32), 0.0), sh["Uij"],
                    W32o, sh["Wpf"], sh["Y32"], W32o.new_zeros((1, M, 6)),
                    eF.to(dev).to(f32), M, 1, force_dense=True)
                e_parts.append(-neg)
            shards.append(sh)
            yield S

    S32 = mesh.psum(s_parts())
    E32 = eP.to(d0).to(f32).reshape(1, -1) - mesh.psum(e_parts)
    sch32, E32 = schur.precond_factor(S32, E32, fixed_mask.to(d0),
                                      fixc, sign)
    del S32
    Vinv32 = shards[0]["Vinv32"]
    V, eP, eF = V.to(d0), eP.to(d0), eF.to(d0)
    freeP = schur.free_poses(fixed_mask.to(d0), M, fixc)

    def pin(xp):
        return xp if fixc is None else schur.pin_coordinate(xp, fixc, sign)

    def wt_x(x32):
        """sum over the shards of W^T x at each feature (f32)."""
        return mesh.psum(seg_sum(schur.bmv_t(sh["W32"],
                                              take(x32.to(sh["W32"].device),
                                                   sh["Wpf"][..., 0])),
                                 sh["Wpf"][..., 1], N) for sh in shards)

    def precond(rP, rF):
        rF32 = rF.to(f32)
        red = rP.to(f32) - mesh.psum(
            seg_sum(schur.bmv(sh["Y32"], take(rF32.to(sh["Y32"].device),
                                               sh["Wpf"][..., 1])),
                    sh["Wpf"][..., 0], M) for sh in shards)
        red = torch.where(freeP, red, red.new_zeros(()))
        dxp = sch32(red.reshape(1, -1)).reshape(1, M, 6)
        dxp = torch.where(freeP, dxp, dxp.new_zeros(()))
        dxf = schur.bmv(Vinv32, rF32 - wt_x(dxp))
        return dxp.to(dt), dxf.to(dt)

    def matvec(xp, xf):
        parts = [schur.info_vector(xp.to(sh["U64"].device),
                                   xf.to(sh["U64"].device), sh["U64"],
                                   sh["Uij"], sh["W64"], sh["Wpf"], None)
                 for sh in shards]
        iP = mesh.psum(p[0] for p in parts)
        iF = mesh.psum(p[1] for p in parts) + schur.bmv(V, xf)
        return torch.where(freeP, iP, iP.new_zeros(())), iF

    xp0 = pin(sch32(E32).reshape(1, M, 6).to(dt))
    # feature start: Vinv32 (eF - W^T xp0), sharded like the matvec
    xf0 = schur.bmv(Vinv32, eF.to(f32) - wt_x(xp0.to(f32))).to(dt)
    xp, xf, res = schur.pcg(matvec, precond, xp0, xf0, eP, eF, freeP,
                            iters=iters, exit_tol=exit_tol,
                            escalate_iters=escalate_iters,
                            escalate_tol=escalate_tol)
    return pin(xp), xf, res
