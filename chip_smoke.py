#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`linearsfm_tpu_torch`) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi); no CUDA device -> exit 2;
2. build the port's CUDA kernels from `linearsfm_tpu_torch/csrc`;
3. kernel K1 (`blockcoo_to_dense`) against its plain PyTorch version on the
   card: K = 0, padding rows, duplicates, unsorted rows, lane-folded
   batches, float64, and the level-1 and root shapes of the main path,
   including a feature-chunked stripe. Exact where no two entries share a coordinate,
   else rtol 1e-6 (plus 1e-6 of the largest magnitude). Median CUDA-event
   time of each side;
4. a 13-map stereo tree solved on the GPU and on the CPU, by the main
   path's method ("refine") and by "direct" (K1 in float64): poses agree to
   atol 1e-9;
5. the main path: the 2,048-map stereo loop-closure set (seed 7, noise
   0.005, covis radius 6, at most 6 co-visible features per map) through
   `DeviceTreeSolver("stereo", method="refine", device="cuda")`, one warm
   run and one timed run. Fails unless the ATE is within 1e-6 of the oracle's
   0.009758730, every level's PCG residual is <= 1e-10 and K1 launched.

The line before the last is the kernel record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ORACLE_ATE_2048 = 0.009758730   # oracle ATE, stereo 2,048 covis, seed 7


def _median_ms(fn, reps):
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


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
        own = (cols >= lo) & (cols < lo + width)
        rows = torch.where(own, rows, -1)
        cols = torch.clamp(cols - lo, 0, width - 1)
        N = width
    return rows, cols, vals, M, N


def _has_duplicates(rows, cols, M, N):
    import torch
    ok = (rows >= 0) & (rows < M) & (cols >= 0) & (cols < N)
    lane = torch.arange(rows.shape[0], device=rows.device)[:, None]
    key = ((lane * M + rows) * N + cols)[ok]
    return key.numel() != torch.unique(key).numel()


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
    timed = ("level1 A 6x6", "level1 W 6x3", "root A 6x6", "root W stripe 6x3")
    max_err = 0.0
    times = {}
    for name, (rows, cols, vals, M, N) in cases.items():
        got = kernels.blockcoo_to_dense(rows, cols, vals, M, N)
        ref = kernels.blockcoo_to_dense_ref(rows, cols, vals, M, N)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max()) if ref.numel() else 0.0
        max_err = max(max_err, err)
        dup = _has_duplicates(rows, cols, M, N)
        if dup:
            scale = float(ref.abs().max())
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6 * scale)
        elif not torch.equal(got, ref):
            raise AssertionError(f"K1 {name}: not exact, max err {err}")
        print(f"k1 {name}: out {list(got.shape)} K={rows.shape[-1]} "
              f"max_abs_err={err:.3e} "
              f"({'rtol 1e-6' if dup else 'exact'}) ok", flush=True)
        if name in timed:
            # alternate plain, kernel, kernel, plain
            reps = 10
            p1 = _median_ms(lambda: kernels.blockcoo_to_dense_ref(
                rows, cols, vals, M, N), reps)
            k1 = _median_ms(lambda: kernels.blockcoo_to_dense(
                rows, cols, vals, M, N), reps)
            k2 = _median_ms(lambda: kernels.blockcoo_to_dense(
                rows, cols, vals, M, N), reps)
            p2 = _median_ms(lambda: kernels.blockcoo_to_dense_ref(
                rows, cols, vals, M, N), reps)
            times[name] = (min(k1, k2), min(p1, p2))
            print(f"k1 time {name}: kernel {k1:.3f}/{k2:.3f} ms, "
                  f"plain {p1:.3f}/{p2:.3f} ms (median of {reps})", flush=True)
        del got, ref
    return max_err, times


def _poses_by_id(lm):
    from linearsfm_tpu_torch import types
    h = types.to_numpy(lm)
    return {int(i): h.poses[s] for s, i in enumerate(h.pose_ids) if i >= 0}


def phase_small_tree():
    import numpy as np
    from synth import generate as gen
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver

    maps, _, _ = gen.make_dataset(13, "stereo", noise=0.01, seed=5)
    # refine is the main path; direct runs K1 in float64
    for method in ("refine", "direct"):
        a = _poses_by_id(DeviceTreeSolver("stereo", method=method,
                                          device="cuda").run(maps))
        b = _poses_by_id(DeviceTreeSolver("stereo", method=method,
                                          device="cpu").run(maps))
        if set(a) != set(b):
            raise AssertionError("13-map tree: GPU and CPU pose ids differ")
        diff = max(float(np.abs(a[k] - b[k]).max()) for k in a)
        if not diff <= 1e-9:
            raise AssertionError(f"13-map tree {method}: GPU vs CPU pose diff "
                                 f"{diff:.3e}")
        print(f"tree13 stereo {method}: GPU vs CPU max pose diff {diff:.3e} "
              f"(atol 1e-9) ok", flush=True)


def phase_main_path():
    import numpy as np
    import torch
    from synth import generate as gen
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.utils.metrics import LevelMetrics

    n = 2048
    t0 = time.perf_counter()
    maps, poses_gt, _ = gen.make_dataset(n, "stereo", noise=0.005, seed=7,
                                         covis_radius=6.0, covis_max=6)
    print(f"main: dataset {n} stereo maps in {time.perf_counter() - t0:.2f} s",
          flush=True)
    solver = DeviceTreeSolver("stereo", method="refine", device="cuda")
    t0 = time.perf_counter()
    solver.run(maps)
    print(f"main: warm run {time.perf_counter() - t0:.3f} s "
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

    from linearsfm_tpu_torch import types
    h = types.to_numpy(out)
    ids, poses = h.pose_ids, h.poses
    valid = ids >= 0
    if not np.isfinite(poses[valid]).all() or int(valid.sum()) != n:
        raise AssertionError(f"main: {int(valid.sum())} valid poses, "
                             f"finite={np.isfinite(poses[valid]).all()}")
    err = [float(np.linalg.norm(poses[s][:3] - poses_gt[int(i)][:3]))
           for s, i in enumerate(ids) if i >= 0]
    ate = float(np.sqrt(np.mean(np.square(err))))
    res = [r.get("res_max", float("nan")) for r in metrics.records]
    res_max = max(res)
    print(f"main: timed run {wall:.4f} s = {(n - 1) / wall:.2f} maps_joined/s, "
          f"peak device memory {peak:.2f} GiB, host phases "
          f"{ {k: round(v, 4) for k, v in solver._last_timing.items()} }",
          flush=True)
    for r in metrics.records:
        print(f"main: level {r['level']:2d} joins {r['n_joins']:4d} "
              f"join_m {r['join_m']:5d} exec_wall {r['exec_wall'] * 1e3:9.3f} ms "
              f"res_max {r.get('res_max', float('nan')):.3e}", flush=True)
    print(f"main: ATE {ate:.9f} (oracle {ORACLE_ATE_2048:.9f}, diff "
          f"{ate - ORACLE_ATE_2048:+.3e}), res_max {res_max:.3e}, "
          f"K1 launches {launched}", flush=True)
    if not abs(ate - ORACLE_ATE_2048) <= 1e-6:
        raise AssertionError(f"main: ATE {ate} off the oracle's")
    if not res_max <= 1e-10:
        raise AssertionError(f"main: res_max {res_max} > 1e-10")
    if launched["blockcoo_to_dense"] <= 0:
        raise AssertionError("main: K1 was never launched")
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
    print(f"build: blockcoo_to_dense (nvcc sm_90a) "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    max_err, times = phase_kernels()
    phase_small_tree()
    launched = phase_main_path()

    ms, plain_ms = times["root W stripe 6x3"]
    print(json.dumps({"kernels": [{
        "name": "blockcoo_to_dense", "route": "cuda",
        "source": "linearsfm_tpu_torch/csrc/blockcoo_dense.cu",
        "replaces": "linearsfm_tpu/ops/pallas_kernels.py:156",
        "launches": launched["blockcoo_to_dense"],
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
