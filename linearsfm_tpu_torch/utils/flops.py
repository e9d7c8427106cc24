"""Host-side FLOP / memory-byte model of the device merge tree.

Counterpart of `linearsfm_tpu/utils/flops.py`, with the same cost model and
per-block constants (not yet calibrated on the GPU). The reference's only
performance instrumentation is one wall-clock printf
(LinearSFMImp.cpp:2068-2072); this module prices every level of a TreePlan
from its capacity plan (core/plan.py), so a run can report achieved FLOP/s,
its share of the card's peak, and a memory-traffic estimate.

Cost structure of one pair lane at a level with input caps (M, N, KU, KW):

* gauge transform (f64, ops/congruence.py): congruence products
  ``J^T I J`` over the block lists + coupling/cross terms; ~2.5 kFLOP per U
  block, ~1.2 kFLOP per W block, ~0.6 kFLOP per V block.
* merged system (capacity concat, emission growth as in core/plan.py):
  stereo  M2=2M, N2=2N, KU2=2KU+M+1, KW2=2KW+N;
  mono    M2=2M, N2=2N, KU2=2KU+2M+3, KW2=2KW+2N.
* dense Schur assembly (f32, ops/schur._assemble_schur_dense):
  ``S = A - Yd Wd^T``: 2*(6*M2)^2*(3*N2); Y = W Vinv: 324*KW2.
* Cholesky factor of S (f32): (6*M2)^3 / 3.
* PCG sweeps (ops/schur.solve_full_mixed): per iteration one preconditioner
  application (two triangular solves, 2*2*(6*M2)^2, f32) and one
  full-system block matvec (f64): 144*KU2 + 72*KW2 + 18*N2.
* re-gauge lanes pay a second transform at merged sizes.

Memory bytes per lane: one read+write of the lane's maps (f64) plus the
dense f32 stripes (Wd, Yd streamed once each, S read ~3x during factor and
solves).

Peak: the f32 terms are measured against the NVIDIA H100 SXM's f32
non-tensor peak, 67e12 FLOP/s (data sheet, 700 W): the port keeps its f32
products out of TF32 (`ops/schur.require_full_f32`). The f64 terms are
reported separately.
"""

from __future__ import annotations

PEAK_F32 = 67e12   # NVIDIA H100 SXM, f32 without tensor cores, FLOP/s


def _merged(caps, datatype):
    M, N, KU, KW = caps
    if datatype == "stereo":
        return 2 * M, 2 * N, 2 * KU + M + 1, 2 * KW + N
    return 2 * M, 2 * N, 2 * KU + 2 * M + 3, 2 * KW + 2 * N


def _transform_f64(M, N, KU, KW):
    return 2500 * KU + 1200 * KW + 600 * N + 4000 * M


def level_cost(lp, datatype, iters: int) -> dict:
    """FLOP/byte model of one tree level (all lanes): f32 FLOPs (`f32`),
    f64 FLOPs (`f64`) and memory bytes (`bytes`)."""
    npair = lp.count // 2
    M, N, KU, KW = lp.caps_in
    M2, N2, KU2, KW2 = _merged(lp.caps_in, datatype)
    d = 6 * M2

    f64 = _transform_f64(M, N, KU, KW)                  # pre-join transform
    nrg = sum(1 for f in (lp.regauge or ()) if f)
    f32 = 2.0 * d * d * (3 * N2) + d ** 3 / 3.0         # assembly + factor
    f32 += iters * 4.0 * d * d                          # preconditioner
    f64 += iters * (144.0 * KU2 + 72.0 * KW2 + 18.0 * N2)   # PCG matvecs
    f64_total = npair * f64 + nrg * _transform_f64(M2, N2, KU2, KW2)
    f32_total = npair * f32

    lane_bytes = 8 * 2 * (36 * KU2 + 18 * KW2 + 9 * N2 + 6 * M2 + 3 * N2)
    dense_bytes = 4 * (2 * d * 3 * N2 + 3 * d * d)
    return dict(f32=f32_total, f64=f64_total,
                bytes=npair * (lane_bytes + dense_bytes))


def tree_cost(tp, datatype, iters_fn) -> dict:
    """Whole-tree totals + per-level breakdown.

    iters_fn(join_m) -> PCG sweep count for that level (the solver's
    precision band, core/device_tree.DeviceTreeSolver._cfg).
    """
    levels = []
    tot = dict(f32=0.0, f64=0.0, bytes=0.0)
    for lp in tp.levels:
        it = iters_fn(lp.join_m if lp.join_m is not None
                      else 2 * lp.caps_in[0])
        c = level_cost(lp, datatype, it)
        levels.append(c)
        for k in tot:
            tot[k] += c[k]
    return dict(levels=levels, **tot)


def mfu(tp, datatype, iters_fn, wall_s: float) -> dict:
    """Achieved f32 FLOP/s and its share of the card's f32 peak."""
    c = tree_cost(tp, datatype, iters_fn)
    ach = c["f32"] / wall_s
    return dict(f32_flops=c["f32"], f64_flops=c["f64"],
                gbytes=c["bytes"] / 1e9,
                achieved_f32_tflops=ach / 1e12,
                mfu_f32=ach / PEAK_F32,
                gbytes_per_s=c["bytes"] / 1e9 / wall_s,
                levels=c["levels"])
