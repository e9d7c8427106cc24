"""Euler (YPR) <-> rotation matrix in the reference convention.

Counterpart of `linearsfm_tpu/ops/rotations.py`: a pose is
``(t, alpha, beta, gamma)`` with ``R = Rx(gamma) @ Ry(beta) @ Rz(alpha)``.
Written for forward-mode autodiff (`torch.func.jacfwd` in
`ops/congruence.py`); every function broadcasts over leading dims.
"""

from __future__ import annotations

import math

import torch

# The reference uses PI = 3.1415926 for angle wraparound only.
REF_PI = 3.1415926


def euler_to_r(abg: torch.Tensor) -> torch.Tensor:
    """[..., 3] (alpha, beta, gamma) -> [..., 3, 3] rotation matrix."""
    sa, sb, sg = torch.sin(abg).unbind(-1)
    ca, cb, cg = torch.cos(abg).unbind(-1)
    r0 = torch.stack([cb * ca, cb * sa, -sb], dim=-1)
    r1 = torch.stack([sg * sb * ca - cg * sa, sg * sb * sa + cg * ca, sg * cb],
                     dim=-1)
    r2 = torch.stack([cg * sb * ca + sg * sa, cg * sb * sa - sg * ca, cg * cb],
                     dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def _euler_from_entries(r01, r00, r02, r12, r22, r11):
    """beta = atan2(-R02, sqrt(R00^2 + R01^2)), alpha = atan2(R01, R00),
    gamma = atan2(R12, R22).

    Singular branch (cos beta == 0, tested on R00^2 + R01^2 as the
    reference tests the square root): alpha = 0, beta = pi/2 whatever the
    sign (bug-compatible with the reference), gamma = atan2(R01, R11). The
    masked operands keep the derivatives of both branches finite.
    """
    cb2 = r00 * r00 + r01 * r01
    singular = cb2 < 1e-60
    one = torch.ones_like(r00)
    cb = torch.sqrt(torch.where(singular, one, cb2))
    beta = torch.atan2(-r02, cb)
    alpha = torch.atan2(r01, torch.where(singular, one, r00))
    gamma = torch.atan2(r12, torch.where(singular, one, r22))
    gamma_s = torch.atan2(r01, torch.where(singular, r11, one))
    alpha = torch.where(singular, torch.zeros_like(r00), alpha)
    beta = torch.where(singular, torch.full_like(r00, math.pi / 2), beta)
    gamma = torch.where(singular, gamma_s, gamma)
    return torch.stack([alpha, beta, gamma], dim=-1)


def r_to_euler(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3]; inverse of euler_to_r."""
    return _euler_from_entries(R[..., 0, 1], R[..., 0, 0], R[..., 0, 2],
                               R[..., 1, 2], R[..., 2, 2], R[..., 1, 1])


def r_to_euler_t(R: torch.Tensor) -> torch.Tensor:
    """Euler angles of R^T given R."""
    return r_to_euler(R.transpose(-1, -2))


def mat3_vec(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3] -> [..., 3]."""
    return (R @ v[..., None])[..., 0]


def compose_rrt(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """R1 @ R2^T (lmj_TimesRRT, LinearSFMImp.cpp:336-347)."""
    return R1 @ R2.transpose(-1, -2)


def wrap_angle_pi(x: torch.Tensor) -> torch.Tensor:
    """Wrap into (-REF_PI, REF_PI] by the reference's truncation-based
    single step: exact for |x| < 2 pi."""
    two_pi = 2.0 * REF_PI
    k = torch.trunc(x / two_pi)
    zero = torch.zeros_like(x)
    return x - torch.where(x > REF_PI, (k + 1) * two_pi,
                           torch.where(x < -REF_PI, (k - 1) * two_pi, zero))


def wrap_angle_diff(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Shift x by +-2 REF_PI so that x - ref lies in [-pi, pi]."""
    d = x - ref
    zero = torch.zeros_like(x)
    return x + torch.where(d > REF_PI, zero - 2.0 * REF_PI,
                           torch.where(d < -REF_PI, zero + 2.0 * REF_PI, zero))
