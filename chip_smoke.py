#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`linearsfm_tpu_torch`) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi); no CUDA device -> exit 2;
2. build the port's CUDA kernels from `linearsfm_tpu_torch/csrc` (one nvcc
   per source, all at once, linked into one library);
3. kernel K1 (`blockcoo_to_dense`) against its plain PyTorch version on the
   card: K = 0, padding rows, duplicates, unsorted rows, lane-folded
   batches, float64, and the level-1 and root shapes of the main path,
   including a feature stripe as a list of its own and, as the Schur
   assembly runs them, column windows of one plan (`coo_plan`): the root
   stripe and stereo level 10's two stripes. Exact where no two entries
   share a coordinate, else rtol 1e-6 (plus 1e-6 of the largest
   magnitude); each line says whether the result was exact. At the
   main-path shapes, CUDA-event times over loops of calls: the kernel alone on a
   prebuilt plan, the wrapper (plan + launch), the plain version and the
   library yardstick (torch.zeros + one index_put_ with accumulate=True on
   element indices built beforehand), beside the bound: the output's bytes
   written once plus the entries' read once, over 3.35 TB/s;
4. kernel K2 (`inv3x3_sym`) against its plain version, exactly
   (`torch.equal`, NaN where the plain version has NaN), in float32 and
   float64: zero, NaN and near-singular blocks, the mono plan's level-1 lane
   stack [1024, 64, 3, 3] and its root join's [1, 11648, 3, 3]. Median
   CUDA-event times (loops of calls) of the kernel, the plain version and
   torch.linalg.inv (the non-singular cases), beside the bound;
5. small trees solved on the GPU and on the CPU, by "refine" and by
   "direct" (K1 and K2 in float64): 13 stereo maps and 11 mono maps; poses
   agree to atol 1e-9;
6. the stereo main path: the 2,048-map stereo loop-closure set (seed 7,
   noise 0.005, covis radius 6, at most 6 co-visible features per map)
   through `DeviceTreeSolver("stereo", method="refine", device="cuda")`, one
   warm run and one timed run. Fails unless every pose id 1..2,048 is there
   and finite, the ATE is within 1e-6 of the oracle's 0.009758730, every
   level's PCG residual is <= 1e-10 and K1 and K2 launched;
7. the mono main path: the same set in mono (pose 0 is an explicit block:
   ids 0..2,049) through `DeviceTreeSolver("mono", ...)`, checked the same
   way against the oracle's 0.014352172.

The kernel launch counts are set to 0 just before each main path's timed
run and read just after it. The line before the last is the kernel record
(per kernel: launches, max error, kernel, plain, bound and library times at
the root shape); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# oracle ATEs of the 2,048-map covis sets, seed 7 (ate_2048_covis*.json)
ORACLE_ATE_2048 = {"stereo": 0.009758730, "mono": 0.014352172}


def _loop_ms(fn, reps):
    """Device time per call: CUDA events around `reps` calls queued back to
    back (after two warm-up calls), so the host's launch work overlaps the
    device's; no result is kept alive between calls."""
    import torch
    for _ in range(2):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# H100 SXM HBM rate and non-tensor f32/f64 peaks (NVIDIA data sheet,
# 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12


def _coo_case(g, P, K, M, N, C, *, pad_every=0, sort_rows=False,
              zero_frac=0.0, col_window=None, dtype=None):
    """Random lane-stacked block-COO list on the card (R = 6)."""
    import torch
    dev = "cuda"
    rows = torch.randint(0, M, (P, K), generator=g, device=dev)
    if sort_rows:   # two concatenated row-sorted runs, as a join emits them
        h = K // 2
        rows[:, :h] = rows[:, :h].sort(dim=1).values
        rows[:, h:] = rows[:, h:].sort(dim=1).values
    cols = torch.randint(0, N, (P, K), generator=g, device=dev)
    vals = torch.randn((P, K, 6, C), generator=g, device=dev, dtype=dtype)
    if pad_every:
        rows[:, ::pad_every] = -1
    if zero_frac:
        z = torch.rand((P, K), generator=g, device=dev) < zero_frac
        rows = torch.where(z, -1, rows)
    if col_window is not None:   # a feature stripe: entries outside skip
        lo, width = col_window
        return (*_masked_stripe(rows, cols, lo, width), vals, M, width)
    return rows, cols, vals, M, N


def _masked_stripe(rows, cols, lo, width):
    """A stripe as a list of its own: rows outside [lo, lo + width) masked
    to -1, columns shifted and clamped (the plain version's input)."""
    import torch
    own = (cols >= lo) & (cols < lo + width)
    return torch.where(own, rows, -1), torch.clamp(cols - lo, 0, width - 1)


def _has_duplicates(rows, cols, M, N):
    import torch
    ok = (rows >= 0) & (rows < M) & (cols >= 0) & (cols < N)
    lane = torch.arange(rows.shape[0], device=rows.device)[:, None]
    key = ((lane * M + rows) * N + cols)[ok]
    return key.numel() != torch.unique(key).numel()


def _library_inputs(rows, cols, vals, M, N):
    """Element indices and values of the valid entries, in list order, for
    the yardstick torch.zeros + index_put_(accumulate=True)."""
    import torch
    P, K, R, C = vals.shape
    ok = (rows >= 0) & (rows < M) & (cols >= 0) & (cols < N)
    lane = torch.arange(P, device=rows.device)[:, None]
    frow = (rows + lane * M)[ok]
    rr = frow[:, None, None] * R + torch.arange(R, device=rows.device)[:, None]
    cc = cols[ok][:, None, None] * C + torch.arange(C, device=rows.device)
    rr, cc = torch.broadcast_tensors(rr, cc)
    return ((P * M * R, C * N), (rr.reshape(-1), cc.reshape(-1)),
            vals[ok].reshape(-1))


def _k1_bound_ms(P, M, N, R, C, esz, nnz):
    """Least time of one K1 launch: its output written once plus its
    entries (values, permutation and column, 4 bytes each) and row offsets
    read once, over the HBM rate."""
    out = P * R * M * C * N * esz
    entries = nnz * (R * C * esz + 8) + (P * M + 1) * 4
    return (out + entries) / HBM_BYTES_PER_S * 1e3


def phase_kernels():
    import torch
    from linearsfm_tpu_torch.ops import kernels

    g = torch.Generator(device="cuda").manual_seed(41)
    cases = {
        "K=0": (torch.zeros((1, 0), dtype=torch.int64, device="cuda"),
                torch.zeros((1, 0), dtype=torch.int64, device="cuda"),
                torch.zeros((1, 0, 6, 3), device="cuda"), 5, 7),
        "padding+duplicates+unsorted 6x3": _coo_case(g, 1, 700, 37, 53, 3,
                                                     pad_every=13),
        "sorted 6x6": _coo_case(g, 1, 500, 29, 29, 6, sort_rows=True),
        "lane-folded 8 lanes 6x3": _coo_case(g, 8, 300, 20, 40, 3,
                                             pad_every=7),
        "float64 lane-folded 4 lanes 6x6": _coo_case(
            g, 4, 400, 24, 24, 6, pad_every=11, dtype=torch.float64),
        # level 1 of the 2,048-map tree: 1,024 pair lanes, Mo = No = 32
        "level1 A 6x6": _coo_case(g, 1024, 145, 32, 32, 6, sort_rows=True,
                                  zero_frac=0.1),
        "level1 W 6x3": _coo_case(g, 1024, 144, 32, 32, 3, sort_rows=True,
                                  zero_frac=0.05),
        # root join: Mo = 2048, No = 11712 -> 4 stripes of 2928 features
        "root A 6x6": _coo_case(g, 1, 19585, 2048, 2048, 6, sort_rows=True,
                                zero_frac=0.05),
        "root W stripe 6x3": _coo_case(g, 1, 196320, 2048, 11712, 3,
                                       sort_rows=True, zero_frac=0.03,
                                       col_window=(2928, 2928)),
    }
    # stripes densified as the Schur assembly does: one plan of the whole
    # W list, one launch per window (name: list, windows)
    windowed = {
        "root W stripe 6x3 (plan)": (
            _coo_case(g, 1, 196320, 2048, 11712, 3, sort_rows=True,
                      zero_frac=0.03), [(2928, 2928)]),
        # stereo level 10: 2 pair lanes, Mo = 1024, No = 7712 in 2 stripes
        # of 3,856, 2 x 44,800 W blocks per lane
        "level10 W stripes 6x3 (plan)": (
            _coo_case(g, 2, 89600, 1024, 7712, 3, sort_rows=True,
                      zero_frac=0.03), [(0, 3856), (3856, 3856)]),
    }
    timed = ("level1 A 6x6", "level1 W 6x3", "root A 6x6",
             "root W stripe 6x3 (plan)", "level10 W stripes 6x3 (plan)")
    max_err = 0.0
    times = {}

    def check(name, got, ref, dup):
        nonlocal max_err
        err = float((got - ref).abs().max()) if ref.numel() else 0.0
        max_err = max(max_err, err)
        exact = torch.equal(got, ref)
        if dup:
            scale = float(ref.abs().max())
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6 * scale)
        elif not exact:
            raise AssertionError(f"K1 {name}: not exact, max err {err}")
        print(f"k1 {name}: out {list(got.shape)} max_abs_err={err:.3e} "
              f"duplicates={'yes' if dup else 'no'} "
              f"{'exact' if exact else 'within rtol 1e-6'} ok", flush=True)

    def timing(name, kernel, wrapper, plain, library, bound):
        # alternate plain, kernel, kernel, plain (wrapper and yardstick
        # between the two kernel rounds)
        reps = 10
        p1 = _loop_ms(plain, reps)
        k1 = _loop_ms(kernel, reps)
        w = _loop_ms(wrapper, reps)
        lib = _loop_ms(library, reps)
        k2 = _loop_ms(kernel, reps)
        p2 = _loop_ms(plain, reps)
        ms, plain_ms = min(k1, k2), min(p1, p2)
        times[name] = dict(ms=ms, plain_ms=plain_ms, wrapper_ms=w,
                           library_ms=lib, bound_ms=bound)
        print(f"k1 time {name}: kernel {k1:.4f}/{k2:.4f} ms on a prebuilt "
              f"plan, wrapper {w:.4f} ms, bound {bound:.4f} ms (bytes) = "
              f"{bound / ms:.1%} of the kernel's time, "
              f"{bound / w:.1%} of the wrapper's; library (zeros + "
              f"index_put_) {lib:.4f} ms; plain {p1:.3f}/{p2:.3f} ms "
              f"(loops of {reps})", flush=True)

    for name, (rows, cols, vals, M, N) in cases.items():
        got = kernels.blockcoo_to_dense(rows, cols, vals, M, N)
        ref = kernels.blockcoo_to_dense_ref(rows, cols, vals, M, N)
        torch.cuda.synchronize()
        check(name, got, ref, _has_duplicates(rows, cols, M, N))
        del got, ref
        if name not in timed:
            continue
        plan = kernels.coo_plan(rows, cols, M, N)
        shape, idx, v = _library_inputs(rows, cols, vals, M, N)
        P, _, R, C = vals.shape
        timing(name,
               lambda: kernels.blockcoo_to_dense_planned(plan, vals),
               lambda: kernels.blockcoo_to_dense(rows, cols, vals, M, N),
               lambda: kernels.blockcoo_to_dense_ref(rows, cols, vals, M, N),
               lambda: torch.zeros(shape, device="cuda",
                                   dtype=vals.dtype).index_put_(
                   idx, v, accumulate=True),
               _k1_bound_ms(P, M, N, R, C, vals.element_size(),
                            int(idx[0].numel()) // (R * C)))
        del plan, idx, v

    for name, ((rows, cols, vals, M, N), wins) in windowed.items():
        plan = kernels.coo_plan(rows, cols, M, N)
        for lo, width in wins:
            srows, scols = _masked_stripe(rows, cols, lo, width)
            got = kernels.blockcoo_to_dense_planned(plan, vals, lo, width)
            ref = kernels.blockcoo_to_dense_ref(srows, scols, vals, M, width)
            torch.cuda.synchronize()
            check(f"{name} window [{lo}, {lo + width})", got, ref,
                  _has_duplicates(srows, scols, M, width))
            del got, ref
        lo, width = wins[0]
        srows, scols = _masked_stripe(rows, cols, lo, width)
        shape, idx, v = _library_inputs(srows, scols, vals, M, width)
        P, _, R, C = vals.shape
        # the wrapper: a plan of the stripe's own list and one launch
        timing(name,
               lambda: kernels.blockcoo_to_dense_planned(plan, vals, lo,
                                                         width),
               lambda: kernels.blockcoo_to_dense(srows, scols, vals, M, width),
               lambda: kernels.blockcoo_to_dense_ref(srows, scols, vals, M,
                                                     width),
               lambda: torch.zeros(shape, device="cuda",
                                   dtype=vals.dtype).index_put_(
                   idx, v, accumulate=True),
               _k1_bound_ms(P, M, width, R, C, vals.element_size(),
                            int(idx[0].numel()) // (R * C)))
        del plan, idx, v
    return max_err, times


def _inv3x3_cases(dtype):
    """K2 inputs on the card: random SPD blocks with a zero, a NaN and two
    near-singular blocks; the mono plan's level-1 lane stack (1,024 pairs of
    feature capacity 32) and its root join (two lanes of capacity 5,824)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(43)

    def spd(*lead):
        A = torch.randn(lead + (3, 3), generator=g, device="cuda", dtype=dtype)
        return A @ A.transpose(-1, -2) + 0.1 * torch.eye(3, device="cuda",
                                                         dtype=dtype)
    V = spd(300)
    V[7] = 0.0
    V[11, 1, 2] = V[11, 2, 1] = float("nan")
    v = torch.randn(3, generator=g, device="cuda", dtype=dtype)
    V[13] = torch.outer(v, v)                           # rank 1
    V[17] = torch.outer(v, v) + 1e-5 * torch.eye(3, device="cuda", dtype=dtype)
    return {"special": V, "level1 [1024, 64]": spd(1024, 64),
            "root [1, 11648]": spd(1, 11648)}


def phase_k2():
    import torch
    from linearsfm_tpu_torch.ops import kernels

    max_err = 0.0
    times = {}
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        for name, V in _inv3x3_cases(dtype).items():
            got = kernels.inv3x3_sym(V)
            ref = kernels.inv3x3_sym_ref(V)
            torch.cuda.synchronize()
            nan_same = torch.equal(torch.isnan(got), torch.isnan(ref))
            if not (nan_same and torch.equal(torch.nan_to_num(got),
                                             torch.nan_to_num(ref))):
                raise AssertionError(f"K2 {name} {dn}: kernel != plain")
            fin = torch.isfinite(ref)
            err = float((got[fin] - ref[fin]).abs().max())
            max_err = max(max_err, err)
            print(f"k2 {name} {dn}: {list(V.shape)} max_abs_err={err:.3e} "
                  f"nan blocks {int(torch.isnan(got).any(-1).any(-1).sum())} "
                  f"(torch.equal) ok", flush=True)
            if name == "special":
                continue
            # least time: the upper triangle read and the 9 values written
            # once (bytes) or 33 operations a block at the card's
            # non-tensor peak, whichever is larger
            n, esz = V.numel() // 9, V.element_size()
            peak = F32_FLOP_PER_S if dtype == torch.float32 else F64_FLOP_PER_S
            by_bytes = n * 15 * esz / HBM_BYTES_PER_S * 1e3
            by_ops = n * 33 / peak * 1e3
            bound = max(by_bytes, by_ops)
            reps = 20
            p1 = _loop_ms(lambda: kernels.inv3x3_sym_ref(V), reps)
            k1 = _loop_ms(lambda: kernels.inv3x3_sym(V), reps)
            lib = _loop_ms(lambda: torch.linalg.inv(V), reps)
            k2 = _loop_ms(lambda: kernels.inv3x3_sym(V), reps)
            p2 = _loop_ms(lambda: kernels.inv3x3_sym_ref(V), reps)
            times[(name, dn)] = dict(
                ms=min(k1, k2), plain_ms=min(p1, p2), library_ms=lib,
                bound_ms=bound,
                bound_by="bytes" if by_bytes >= by_ops else "operations")
            print(f"k2 time {name} {dn}: kernel {k1:.4f}/{k2:.4f} ms, bound "
                  f"{bound:.5f} ms ({times[(name, dn)]['bound_by']}) = "
                  f"{bound / min(k1, k2):.1%}; library (torch.linalg.inv) "
                  f"{lib:.4f} ms; plain {p1:.4f}/{p2:.4f} ms (loops of "
                  f"{reps})", flush=True)
    return max_err, times


def _poses_by_id(lm):
    from linearsfm_tpu_torch import types
    h = types.to_numpy(lm)
    return {int(i): h.poses[s] for s, i in enumerate(h.pose_ids) if i >= 0}


def phase_small_trees():
    import numpy as np
    from synth import generate as gen
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver

    for datatype, n in (("stereo", 13), ("mono", 11)):
        maps, _, _ = gen.make_dataset(n, datatype, noise=0.01, seed=5)
        # refine is the main path; direct runs K1 and K2 in float64
        for method in ("refine", "direct"):
            a = _poses_by_id(DeviceTreeSolver(datatype, method=method,
                                              device="cuda").run(maps))
            b = _poses_by_id(DeviceTreeSolver(datatype, method=method,
                                              device="cpu").run(maps))
            if set(a) != set(b):
                raise AssertionError(f"{n}-map {datatype} tree: GPU and CPU "
                                     f"pose ids differ")
            diff = max(float(np.abs(a[k] - b[k]).max()) for k in a)
            if not diff <= 1e-9:
                raise AssertionError(f"{n}-map {datatype} tree {method}: GPU "
                                     f"vs CPU pose diff {diff:.3e}")
            print(f"tree{n} {datatype} {method}: GPU vs CPU max pose diff "
                  f"{diff:.3e} (atol 1e-9) ok", flush=True)


def phase_main_path(datatype):
    """One warm and one timed run of the 2,048-map covis set; returns the
    kernel launch counts of the timed run."""
    import numpy as np
    import torch
    from synth import generate as gen
    from linearsfm_tpu_torch import types
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.utils.metrics import LevelMetrics

    n, tag = 2048, f"main {datatype}"
    oracle = ORACLE_ATE_2048[datatype]
    t0 = time.perf_counter()
    maps, poses_gt, _ = gen.make_dataset(n, datatype, noise=0.005, seed=7,
                                         covis_radius=6.0, covis_max=6)
    print(f"{tag}: dataset {n} maps in {time.perf_counter() - t0:.2f} s",
          flush=True)
    solver = DeviceTreeSolver(datatype, method="refine", device="cuda")
    t0 = time.perf_counter()
    solver.run(maps)
    print(f"{tag}: warm run {time.perf_counter() - t0:.3f} s "
          f"{solver._last_timing}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    for k in kernels.launches:
        kernels.launches[k] = 0
    metrics = LevelMetrics()
    t0 = time.perf_counter()
    out = solver.run(maps, metrics=metrics, time_levels=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30

    h = types.to_numpy(out)
    ids, poses = h.pose_ids, h.poses
    valid = ids >= 0
    # stereo: pose 0 is the frame itself; mono keeps it as an explicit block
    want_ids = set(range(1, n + 1)) if datatype == "stereo" else set(range(n + 2))
    if (sorted(int(i) for i in ids[valid]) != sorted(want_ids)
            or not np.isfinite(poses[valid]).all()):
        raise AssertionError(f"{tag}: {int(valid.sum())} valid poses (want "
                             f"{len(want_ids)} ids), finite="
                             f"{np.isfinite(poses[valid]).all()}")
    err = [float(np.linalg.norm(poses[s][:3] - poses_gt[int(i)][:3]))
           for s, i in enumerate(ids) if i >= 0]
    ate = float(np.sqrt(np.mean(np.square(err))))
    res = [r.get("res_max", float("nan")) for r in metrics.records]
    res_max = max(res)
    print(f"{tag}: timed run {wall:.4f} s = {(n - 1) / wall:.2f} "
          f"maps_joined/s, peak device memory {peak:.2f} GiB, host phases "
          f"{ {k: round(v, 4) for k, v in solver._last_timing.items()} }",
          flush=True)
    for r in metrics.records:
        print(f"{tag}: level {r['level']:2d} joins {r['n_joins']:4d} "
              f"join_m {r['join_m']:5d} exec_wall {r['exec_wall'] * 1e3:9.3f} ms "
              f"res_max {r.get('res_max', float('nan')):.3e}", flush=True)
    print(f"{tag}: ATE {ate:.9f} (oracle {oracle:.9f}, diff "
          f"{ate - oracle:+.3e}), res_max {res_max:.3e}, {len(err)} poses, "
          f"kernel launches {launched}", flush=True)
    if not abs(ate - oracle) <= 1e-6:
        raise AssertionError(f"{tag}: ATE {ate} off the oracle's")
    if not res_max <= 1e-10:
        raise AssertionError(f"{tag}: res_max {res_max} > 1e-10")
    for k, c in launched.items():
        if c <= 0:
            raise AssertionError(f"{tag}: kernel {k} was never launched")
    return launched


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs one CUDA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    # full-f32 matmuls (the port refuses TF32 on its f32 Schur products)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, HERE)
    from linearsfm_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.build()
    print(f"build: {', '.join(os.path.basename(s) for s in kernels.SOURCES)} "
          f"(nvcc sm_90a) {time.perf_counter() - t0:.2f} s", flush=True)

    k1_err, k1_times = phase_kernels()
    k2_err, k2_times = phase_k2()
    phase_small_trees()
    paths = {d: phase_main_path(d) for d in ("stereo", "mono")}

    def record(name, source, replaces, max_err, t):
        by_path = {d: c[name] for d, c in paths.items()}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": max_err,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": t.get("bound_by", "bytes"),
                "library_ms": t["library_ms"]}

    print(json.dumps({"kernels": [
        record("blockcoo_to_dense",
               "linearsfm_tpu_torch/csrc/blockcoo_dense.cu",
               "linearsfm_tpu/ops/pallas_kernels.py:156", k1_err,
               k1_times["root W stripe 6x3 (plan)"]),
        record("inv3x3_sym", "linearsfm_tpu_torch/csrc/inv3x3_sym.cu",
               "linearsfm_tpu/ops/pallas_kernels.py:57", k2_err,
               k2_times[("root [1, 11648]", "float32")])]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
