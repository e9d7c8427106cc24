"""The least bytes of the float64 Schur assembly (the reduced camera
system S = A - Y W^T and E = eP - Y eF of a direct join, which the
program forms in `ops/schur._assemble_schur_dense`), counted from the
shapes the program's `schur_f64` spans record.

Whatever forms S, one lane must read its U list (36 float64 values and
two int32 indices an entry), its W and Y lists (18 float64 values each an
entry, and W's two int32 indices), eP and eF once, and write S and E once.
The count is the same for the dense product the program runs today and for
any sparse one, so a sparser assembly reads as a gain against it. The
shapes are the spans' capacities (M, N, KU, KW), not the lanes' live
counts, so padding counts as bytes too.
"""

from __future__ import annotations

F64, I32 = 8, 4
U_ENTRY = 36 * F64 + 2 * I32          # 296
W_ENTRY = 2 * 18 * F64 + 2 * I32      # 296: W and Y, W's indices


def least_bytes(ku: int, kw: int, m: int, n: int, m2: int) -> int:
    """Least bytes of assemblies whose lanes' U list entries, W list
    entries, poses, landmarks and poses squared sum to ku, kw, m, n and
    m2: the lists, eP read and E written (6 coordinates a pose), eF read
    (3 a landmark) and S written ((6M)^2 entries a lane)."""
    return (ku * U_ENTRY + kw * W_ENTRY + 6 * m * 2 * F64 + 3 * n * F64
            + 36 * m2 * F64)


def timing_bytes(timing: dict) -> int | None:
    """least_bytes of a solve's `_last_timing` sums (schur_f64_ku, _kw,
    _m, _n, _m2); None where the solver does not record them."""
    keys = ("schur_f64_ku", "schur_f64_kw", "schur_f64_m", "schur_f64_n",
            "schur_f64_m2")
    if not all(k in timing for k in keys):
        return None
    return least_bytes(*(timing[k] for k in keys))
