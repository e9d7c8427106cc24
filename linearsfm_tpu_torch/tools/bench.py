"""Benchmark: the port's end-to-end hierarchical solve, maps-joined/s.

    python3 -m linearsfm_tpu_torch.tools.bench [--cpu]

Counterpart of `bench.py`, with its knobs, data, solvers, windows and
record. Environment knobs (bench.py's, with its defaults):

    BENCH_MAPS 2048        maps in the set
    BENCH_METHOD refine    refine | direct
    BENCH_TYPE stereo      stereo | mono
    BENCH_EXEC device      device (DeviceTreeSolver) | dense
                           (DenseTreeSolver) | host (TreeSolver)
    BENCH_COVIS 1          0: no loop-closure co-visibility
    BENCH_PATTERN loop     loop | grid
    BENCH_EXIT_TOL         the device executor's pcg_exit_tol
    BENCH_PROFILE_LEVELS 1 0: no third, per-level timed pass

The data is `synth.generate.make_dataset(BENCH_MAPS, BENCH_TYPE,
noise=0.005, seed=7, pattern=BENCH_PATTERN, covis_radius=6.0,
covis_max=6)` (no covis arguments with BENCH_COVIS=0). One warm run
(untimed; it also builds the kernels), then one timed run, from the call
to the device's end of its work; on the device executor it fills a
`LevelMetrics`; the largest PCG residual of its levels is `res_max`
(none on the direct solve, which computes no residual), and the
`utils/flops` model gives `mfu` and `achieved_f32_tflops`; then, unless
BENCH_PROFILE_LEVELS=0, a third run with per-level device walls beside the
model's f32 FLOPs of each level. `value` is (maps - 1) / wall;
`vs_baseline` is `value` over the repo root's `baseline_measured.json`
entry `<type>[_covis][_grid]_maps_per_s_<maps>` (the oracle binary's
rate on the host that file was measured on), 0.0 without one.

The last line of stdout is one JSON object with bench.py's keys: metric,
value, unit, vs_baseline and, on the device executor, res_max, mfu and
achieved_f32_tflops; nothing else goes to stdout. stderr has the log:
the card's line (nvidia-smi name and power limit), the host phases of
each run, per-level residuals and walls, the ATE to 9 digits, the peak
device memory and the timed run's kernel launches
(`kernel launches (timed run): {...}`, JSON). Runs on the card unless
--cpu is given (no CUDA and no --cpu: exit 1).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.normpath(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "..", ".."))
sys.path.insert(0, REPO)
BASELINE = os.path.join(REPO, "baseline_measured.json")


def log(msg: str) -> None:
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def knobs(env) -> dict:
    """bench.py's environment knobs, read from `env`."""
    k = dict(maps=int(env.get("BENCH_MAPS", "2048")),
             method=env.get("BENCH_METHOD", "refine"),
             datatype=env.get("BENCH_TYPE", "stereo"),
             executor=env.get("BENCH_EXEC", "device"),
             covis=env.get("BENCH_COVIS", "1") != "0",
             pattern=env.get("BENCH_PATTERN", "loop"),
             profile_levels=env.get("BENCH_PROFILE_LEVELS", "1") != "0",
             exit_tol=(float(env["BENCH_EXIT_TOL"])
                       if "BENCH_EXIT_TOL" in env else None))
    if k["executor"] not in ("device", "dense", "host"):
        raise ValueError(f"BENCH_EXEC must be device, dense or host, got "
                         f"{k['executor']!r}")
    return k


def build_solver(k: dict, device: str):
    if k["executor"] == "device":
        from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
        kw = {} if k["exit_tol"] is None else {"pcg_exit_tol": k["exit_tol"]}
        return DeviceTreeSolver(k["datatype"], method=k["method"], **kw,
                                device=device)
    if k["executor"] == "dense":
        from linearsfm_tpu_torch.core.dense_tree import DenseTreeSolver
        return DenseTreeSolver(k["datatype"], method=k["method"],
                               device=device)
    from linearsfm_tpu_torch.core.tree import TreeSolver
    return TreeSolver(k["datatype"], method=k["method"], device=device)


def _telemetry(solver, maps, k: dict, metrics, wall: float):
    """(res_max, the flops model's record) of the device executor's timed
    run; logs each level and, unless BENCH_PROFILE_LEVELS=0, runs the tree
    a third time with per-level device walls."""
    from linearsfm_tpu_torch.core import compact, plan
    from linearsfm_tpu_torch.utils import flops
    from linearsfm_tpu_torch.utils.metrics import LevelMetrics

    # the levels that computed a PCG residual (the direct solve computes
    # none: its lanes are NaN, and bench.py then prints no res_max); a NaN
    # lane of such a level shows as NaN
    rs = [float(np.max(r)) for r in solver.last_residuals.values()
          if r.size and not np.isnan(r).all()]
    res_max = float(np.max(rs)) if rs else None
    for r in metrics.records:
        log(f"  level {r['level']}: join_m={r.get('join_m')} "
            f"res_max={r.get('res_max', float('nan')):.3e}")
    st = compact.compact_stack(maps, solver.bucket, solver.u_bucket)
    tp = plan.plan_tree_exact(plan.sym_of_stacked(st), k["datatype"],
                              solver.bucket, solver.u_bucket)

    def iters_fn(join_m):
        return (solver.top_iters if join_m >= solver.top_min_m
                else solver.refine_iters)

    model = flops.mfu(tp, k["datatype"], iters_fn, wall)
    log(f"model: {model['f32_flops']:.3e} f32 FLOPs, "
        f"{model['f64_flops']:.3e} f64 FLOPs, {model['gbytes']:.1f} GB "
        f"memory -> {model['achieved_f32_tflops']:.2f} TF/s achieved = "
        f"{100 * model['mfu_f32']:.1f}% of f32 peak, "
        f"{model['gbytes_per_s']:.0f} GB/s")
    if k["profile_levels"]:
        from linearsfm_tpu_torch.tools.common import sync
        prof = LevelMetrics()
        solver.run(maps, metrics=prof, time_levels=True)
        sync(solver.device)
        if len(prof.records) != len(model["levels"]):
            raise RuntimeError(f"{len(prof.records)} level records, the "
                               f"model has {len(model['levels'])} levels")
        for r, c in zip(prof.records, model["levels"]):
            ew = r["exec_wall"]
            log(f"  level {r['level']} exec {ew:.3f}s model "
                f"{c['f32'] / 1e9:.1f} GF f32 -> "
                f"{c['f32'] / ew / 1e12:.2f} TF/s")
    return res_max, model


def _vs_baseline(k: dict, value: float) -> float:
    tag = ("_covis" if k["covis"] else "") + (
        "_grid" if k["pattern"] == "grid" else "")
    key = f"{k['datatype']}{tag}_maps_per_s_{k['maps']}"
    b = None
    if os.path.exists(BASELINE):
        with open(BASELINE) as fh:
            b = json.load(fh).get(key)
    if not b:
        log(f"vs_baseline: no {key} in {BASELINE}: 0.0")
        return 0.0
    log(f"vs_baseline: {value:.3f} / {b} ({key} in {BASELINE}: the oracle "
        f"binary's rate on the host that file was measured on)")
    return value / b


def main(argv=None, env=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    k = knobs(os.environ if env is None else env)

    from linearsfm_tpu_torch.tools.common import open_device
    device = open_device(args.cpu, "bench", file=sys.stderr)
    if device is None:
        return 1
    import torch
    from synth import generate as gen
    from linearsfm_tpu_torch import types
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.tools.common import sync
    from linearsfm_tpu_torch.utils.metrics import LevelMetrics

    n = k["maps"]
    cov = dict(covis_radius=6.0, covis_max=6) if k["covis"] else {}
    log(f"dataset: {n} {k['datatype']} maps (noise=0.005, seed=7, "
        f"covis={'on' if k['covis'] else 'off'}, pattern={k['pattern']})")
    maps, poses_gt, _ = gen.make_dataset(n, k["datatype"], noise=0.005,
                                         seed=7, pattern=k["pattern"], **cov)
    solver = build_solver(k, device)
    device_exec = k["executor"] == "device"

    t0 = time.perf_counter()
    log(f"warmup run (kernels built at first use, exec={k['executor']}, "
        f"method={k['method']}, {device})")
    solver.run(maps)
    sync(device)
    log(f"warmup done in {time.perf_counter() - t0:.1f}s "
        f"{solver._last_timing}")

    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for name in kernels.launches:
        kernels.launches[name] = 0
    metrics = LevelMetrics()
    t0 = time.perf_counter()
    final = (solver.run(maps, metrics=metrics) if device_exec
             else solver.run(maps))
    sync(device)
    wall = time.perf_counter() - t0
    launched = dict(kernels.launches)
    log(f"timed run: {wall:.4f}s {solver._last_timing}")
    log(f"kernel launches (timed run): {json.dumps(launched)}")
    log("peak device memory (timed run): " + (
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB" if cuda
        else "not measured (CPU)"))

    res_max = model = None
    if device_exec:
        res_max, model = _telemetry(solver, maps, k, metrics, wall)

    h = types.host_fields(final)
    err = [float(np.linalg.norm(h.poses[s][:3] - poses_gt[int(i)][:3]))
           for s, i in enumerate(h.pose_ids) if i >= 0]
    ate = float(np.sqrt(np.mean(np.square(err))))
    log(f"ATE {ate:.9f} over {len(err)} poses")

    value = (n - 1) / wall
    rec = {
        "metric": f"synthetic {k['datatype']}"
                  f"{' covis' if k['covis'] else ''}"
                  f"{' grid' if k['pattern'] == 'grid' else ''} "
                  f"{n}-map hierarchical solve (ATE {ate:.2e})",
        "value": round(value, 3),
        "unit": "maps_joined/s",
        "vs_baseline": round(_vs_baseline(k, value), 3),
    }
    if res_max is not None:
        rec["res_max"] = float(f"{res_max:.3e}")
    if model is not None:
        rec["mfu"] = round(model["mfu_f32"], 4)
        rec["achieved_f32_tflops"] = round(model["achieved_f32_tflops"], 2)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
