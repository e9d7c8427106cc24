"""Dense symmetric solves with gauge masking.

Counterpart of `linearsfm_tpu/ops/solve.py`: `mask_gauge`, the plain
Cholesky solve of the "direct" method, the f32-factor refinement of the
"refine" method and `solve_reduced`, which masks and dispatches. Operands
carry the leading lane dimension P; a lane whose factorisation fails turns
NaN instead of raising (the reference's NaN factor).
"""

from __future__ import annotations

import torch


def factor(S: torch.Tensor) -> torch.Tensor:
    """Cholesky factors of every lane of S [P, d, d]; NaN on a lane whose
    matrix is not positive definite."""
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where((info != 0)[:, None, None], torch.nan, L)


def solve_factored(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """x [P, d] with L L^T x = rhs, as two triangular solves.
    `torch.cholesky_solve` is not used here: on the H100 it fails with
    "CUDA error: invalid argument" on a float64 batch of two 6,144-wide
    factors (torch 2.11.0+cu128), the direct executor's level 10 at 2,048
    maps, and on a float32 batch of two 12,288-wide factors, the refine
    preconditioner's (`schur.precond_factor`) level 11 at 3,499 maps."""
    y = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mH, y, upper=True)[..., 0]


def mask_gauge(S: torch.Tensor, E: torch.Tensor, fixed_mask: torch.Tensor):
    """Replace fixed rows/cols by identity and zero the RHS there.

    S [P, d, d], E [P, d], fixed_mask bool [P, d] (True = gauge-fixed)."""
    free = ~fixed_mask
    fo = free[:, :, None] & free[:, None, :]
    S = S.masked_fill(~fo, 0.0)
    S.diagonal(dim1=-2, dim2=-1).add_(fixed_mask.to(S.dtype))
    return S, E.masked_fill(fixed_mask, 0.0)


def cholesky_solve(S: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """Dense Cholesky solve in the input dtype; a lane whose matrix is not
    positive definite returns NaN (the reference's NaN factor) instead of
    raising."""
    return solve_factored(factor(S), E)


def cholesky_solve_refine(S: torch.Tensor, E: torch.Tensor,
                          iters: int = 3) -> torch.Tensor:
    """f32 factorisation + iterative refinement in S's dtype, per lane.

    The factorisation and the triangular solves run in float32; each sweep
    adds the f32 solve of the residual ``r = E - S x``, computed against the
    (float64) operands, and multiplies the error by about cond(S) eps_f32.
    """
    L = factor(S.to(torch.float32))

    def solve32(rhs):
        return solve_factored(L, rhs.to(torch.float32)).to(S.dtype)

    x = solve32(E)
    for _ in range(iters):
        x = x + solve32(E - (S @ x[..., None])[..., 0])
    return x


def solve_reduced(S: torch.Tensor, E: torch.Tensor, fixed_mask=None,
                  method: str = "direct", refine_iters: int = 3
                  ) -> torch.Tensor:
    """Solve S x = E per lane, gauge-masked when `fixed_mask` [P, d] is
    given (x is 0 at fixed coordinates). method "refine":
    `cholesky_solve_refine`; anything else the plain Cholesky solve."""
    if fixed_mask is not None:
        S, E = mask_gauge(S, E, fixed_mask)
    if method == "refine":
        return cholesky_solve_refine(S, E, refine_iters)
    return cholesky_solve(S, E)
