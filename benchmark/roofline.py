"""The yardstick of the kernel metrics: the card's peak and the least bytes
each kernel launch must move.

A launch's least time is its bytes over the HBM rate; its roofline share is
the sum of those least times over the device time the profiler gives its
kernels. Both kernels measured here are bound by memory: they do a few
additions per byte (K1 none, K3 one per value read).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s (at the card's
# full 700 W power limit; the harness logs the limit beside each run)
HBM_BYTES_PER_S = 3.35e12


def k1_bytes(kept: int, rows: int, R: int, C: int, width: int,
             esz: int) -> int:
    """K1 (`blockcoo_to_dense`, one launch on a column window of a sorted
    block list): each of the `kept` entries in the window read once (its
    R*C values and its two int32 sort indices: position and block column),
    the rows + 1 int32 row offsets read once, and the dense output of
    `rows` block rows by `width` block columns written once."""
    return (kept * (R * C * esz + 8) + (rows + 1) * 4
            + rows * R * width * C * esz)


def k3_bytes(kept: int, P: int, num: int, T: int, esz: int,
             into: bool = False) -> int:
    """K3 (`seg_sum_fixed`, one launch): the `kept` entries' T values and
    their int32 positions read once, the plan's P*(num + 1) + 1 offsets read
    once, the P*num output rows of T values written once (and read once in
    the accumulate-into form). A frozen copy of the port's own count
    (`ops/kernels.seg_sum_bytes`)."""
    rows = P * num
    return (kept * (T * esz + 4) + (P * (num + 1) + 1) * 4
            + rows * T * esz * (2 if into else 1))
