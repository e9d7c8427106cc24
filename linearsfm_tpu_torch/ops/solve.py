"""Dense symmetric solves with gauge masking.

Counterpart of `linearsfm_tpu/ops/solve.py` (`mask_gauge` and the plain
Cholesky solve of the "direct" method). Operands carry the leading lane
dimension P.
"""

from __future__ import annotations

import torch


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
    L, info = torch.linalg.cholesky_ex(S)
    L = torch.where((info != 0)[:, None, None], torch.nan, L)
    return torch.cholesky_solve(E[..., None], L)[..., 0]
