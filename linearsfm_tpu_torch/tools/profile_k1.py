"""Profile kernel K1 on the port's 2,048-map main paths (one CUDA GPU).

    python3 -m linearsfm_tpu_torch.tools.profile_k1 [--paths stereo,mono]
        [--out profile_k1_out] [--repeat 1]

For each path (the 2,048-map covis set of `chip_smoke.py`, seed 7, through
`DeviceTreeSolver(datatype, method="refine", device="cuda")`): one warm run,
one run under `torch.profiler` (CPU and CUDA activities), and --repeat
timed runs with per-level CUDA-event walls (`time_levels=True`), outside
the profiler; the summary gives each run's sum of level walls and their
median.

From the profiler's Chrome trace it reports:
* every K1 launch (kernel name containing "blockcoo"), in launch order, with
  its tree level, its operand (A, Wd or Yd: per level A first, then Wd and
  Yd per feature stripe), its output's bytes and their write bound (bytes
  over 3.35 TB/s, the H100 SXM's HBM rate), and its device time;
* the device time of every other kernel launched inside K1's Python wrappers
  (output fills, the sort, `searchsorted`, ...), by wrapper and kernel name;
* the device time of all kernels launched inside `_assemble_schur_dense`;
* kernel K2's launches and device time beside its bound (each block's upper
  triangle read and its 9 values written once, over the HBM rate);
* the device busy time (union of kernel intervals) and span.

The K1 wrappers are wrapped here in `torch.profiler.record_function` ranges
("k1/<function>"); each level runs inside a "level<n>" range. Nothing of the
port is changed. One JSON file per path goes to --out; the summary lines go
to stdout, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

N_MAPS = 2048
HBM_BYTES_PER_S = 3.35e12
_out_bytes = []   # output bytes of each K1 launch, in launch order
_k2_bytes = []    # bytes each K2 launch must move


def _wrap(fn, label):
    import torch

    @functools.wraps(fn)
    def inner(*a, **k):
        with torch.profiler.record_function(label):
            return fn(*a, **k)
    return inner


def _wrap_modules(kernels, schur):
    """record_function ranges around K1's wrappers (whichever the port has)
    and the Schur assembly; once per process."""
    if getattr(kernels, "_profiled", False):
        return
    kernels._profiled = True
    # the function that launches the kernel records its output's bytes
    launcher = ("blockcoo_to_dense_planned"
                if hasattr(kernels, "blockcoo_to_dense_planned")
                else "blockcoo_to_dense")
    fn = getattr(kernels, launcher)

    @functools.wraps(fn)
    def record(*a, **k):
        n0 = kernels.launches["blockcoo_to_dense"]
        out = fn(*a, **k)
        if kernels.launches["blockcoo_to_dense"] > n0:
            _out_bytes.append(out.numel() * out.element_size())
        return out
    setattr(kernels, launcher, record)
    for name in ("blockcoo_to_dense", "coo_plan", "blockcoo_to_dense_planned"):
        if hasattr(kernels, name):
            setattr(kernels, name, _wrap(getattr(kernels, name), f"k1/{name}"))
    inv = kernels.inv3x3_sym

    @functools.wraps(inv)
    def record_k2(V):
        n0 = kernels.launches["inv3x3_sym"]
        out = inv(V)
        if kernels.launches["inv3x3_sym"] > n0:
            _k2_bytes.append(V.numel() // 9 * 15 * V.element_size())
        return out
    kernels.inv3x3_sym = record_k2
    # the Schur module's own names for the wrappers
    for alias, name in (("densify_blocks", "blockcoo_to_dense"),
                        ("densify_planned", "blockcoo_to_dense_planned")):
        if hasattr(schur, alias):
            setattr(schur, alias, getattr(kernels, name))
    schur._assemble_schur_dense = _wrap(schur._assemble_schur_dense,
                                        "schur/assemble")


def _instrument(solver):
    """Ranges around the K1 wrappers, the Schur assembly and each level;
    returns the list that collects one label per K1 launch, and its reset."""
    from linearsfm_tpu_torch.ops import kernels, schur

    labels = []
    state = {"level": 0}
    _wrap_modules(kernels, schur)
    level_fn, final_fn = solver._level, solver._final

    def level(x, lp):
        import torch
        state["level"] += 1
        with torch.profiler.record_function(f"level{state['level']}"):
            n0 = kernels.launches["blockcoo_to_dense"]
            out = level_fn(x, lp)
            n = kernels.launches["blockcoo_to_dense"] - n0
        for i in range(n):
            op = "A" if i == 0 else ("Wd" if i % 2 == 1 else "Yd")
            labels.append({"level": state["level"], "operand": op,
                           "stripe": (i - 1) // 2 if i else None,
                           "stripes": (n - 1) // 2})
        return out

    def final(*a, **k):
        import torch
        with torch.profiler.record_function("final"):
            return final_fn(*a, **k)

    solver._level, solver._final = level, final

    def reset():
        labels.clear()
        _out_bytes.clear()
        _k2_bytes.clear()
        state["level"] = 0
    return labels, reset


def _union_us(iv):
    tot, end = 0.0, -1e300
    for a, b in sorted(iv):
        if b <= end:
            continue
        tot += b - max(a, end)
        end = b
    return tot


def _analyse(trace_path, labels):
    with open(trace_path) as fh:
        ev = json.load(fh)["traceEvents"]
    dev = [e for e in ev if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")]
    launch_ts = {}
    for e in ev:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "args" in e:
            c = e["args"].get("correlation")
            if c is not None:
                launch_ts[c] = e["ts"]
    ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                     if e.get("cat") == "user_annotation"
                     and e.get("ph") == "X"), key=lambda r: r[0])

    def innermost(ts, prefix):
        best = None
        for a, b, n in ranges:
            if a > ts:
                break
            if b >= ts and n.startswith(prefix):
                if best is None or a >= best[0]:
                    best = (a, b, n)
        return best[2] if best else None

    dev.sort(key=lambda e: e["ts"])
    k1 = [e for e in dev if "blockcoo" in e["name"]]
    if len(k1) != len(labels):
        raise AssertionError(f"{len(k1)} K1 kernels in the trace, "
                             f"{len(labels)} launches counted")
    rows = []
    for e, lab, nbytes in zip(k1, labels, _out_bytes):
        rows.append(dict(lab, us=e["dur"], out_bytes=nbytes,
                         bound_us=nbytes / HBM_BYTES_PER_S * 1e6,
                         grid=e["args"].get("grid"),
                         block=e["args"].get("block"),
                         smem=e["args"].get("shared memory")))
    wrapper, assembly_us = {}, 0.0
    for e in dev:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        if innermost(ts, "schur/assemble"):
            assembly_us += e["dur"]
        where = innermost(ts, "k1/")
        if where is None or "blockcoo" in e["name"]:
            continue
        key = (where, e["name"][:90])
        c, t = wrapper.get(key, (0, 0.0))
        wrapper[key] = (c + 1, t + e["dur"])
    k2 = [e["dur"] for e in dev if "inv3x3" in e["name"]]
    if len(k2) != len(_k2_bytes):
        raise AssertionError(f"{len(k2)} K2 kernels in the trace, "
                             f"{len(_k2_bytes)} launches counted")
    iv = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    span = (max(b for _, b in iv) - min(a for a, _ in iv)) if iv else 0.0
    return {"k1": rows,
            "k1_us": sum(r["us"] for r in rows),
            "k1_bound_us": sum(r["bound_us"] for r in rows),
            "wrapper_kernels": [{"range": w, "kernel": n, "count": c, "us": t}
                                for (w, n), (c, t) in sorted(
                                    wrapper.items(), key=lambda x: -x[1][1])],
            "assembly_us": assembly_us,
            "k2_launches": len(k2), "k2_us": sum(k2),
            "k2_bound_us": sum(_k2_bytes) / HBM_BYTES_PER_S * 1e6,
            "busy_us": _union_us(iv), "span_us": span,
            "n_device_events": len(dev)}


def profile_path(datatype, out_dir, repeat):
    import torch
    from synth import generate as gen
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.utils.metrics import LevelMetrics

    tag = f"profile {datatype}"
    maps, _, _ = gen.make_dataset(N_MAPS, datatype, noise=0.005, seed=7,
                                  covis_radius=6.0, covis_max=6)
    solver = DeviceTreeSolver(datatype, method="refine", device="cuda")
    labels, reset = _instrument(solver)
    solver.run(maps)                                   # warm
    torch.cuda.synchronize()
    reset()
    n0 = kernels.launches["blockcoo_to_dense"]
    trace = os.path.join(out_dir, f"trace_{datatype}.json")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        solver.run(maps)
        torch.cuda.synchronize()
    wall_prof = time.perf_counter() - t0
    prof.export_chrome_trace(trace)
    n_k1 = kernels.launches["blockcoo_to_dense"] - n0
    rep = _analyse(trace, labels)
    os.remove(trace)                                   # tens of MB
    rep["k1_launches"] = n_k1
    rep["wall_profiled_s"] = wall_prof

    # timed runs outside the profiler: per-level CUDA-event walls
    rep["timed"] = []
    for _ in range(repeat):
        reset()
        metrics = LevelMetrics()
        t0 = time.perf_counter()
        solver.run(maps, metrics=metrics, time_levels=True)
        torch.cuda.synchronize()
        levels = [{"level": r["level"], "join_m": r["join_m"],
                   "exec_wall_ms": r["exec_wall"] * 1e3,
                   "res_max": r.get("res_max")} for r in metrics.records]
        rep["timed"].append({
            "wall_s": time.perf_counter() - t0,
            "host": dict(solver._last_timing), "levels": levels,
            "levels_sum_ms": sum(r["exec_wall_ms"] for r in levels)})
    sums = sorted(r["levels_sum_ms"] for r in rep["timed"])
    rep["levels_sum_median_ms"] = sums[len(sums) // 2]

    with open(os.path.join(out_dir, f"profile_k1_{datatype}.json"), "w") as fh:
        json.dump(rep, fh, indent=1)
    by = {}
    for r in rep["k1"]:
        k = (r["level"], r["operand"])
        c, t = by.get(k, (0, 0.0))
        by[k] = (c + 1, t + r["us"])
    print(f"{tag}: K1 {n_k1} launches, device {rep['k1_us'] / 1e3:.4f} ms "
          f"(write bound {rep['k1_bound_us'] / 1e3:.4f} ms); "
          f"assembly {rep['assembly_us'] / 1e3:.4f} ms; device busy "
          f"{rep['busy_us'] / 1e3:.3f} ms of span {rep['span_us'] / 1e3:.3f} "
          f"ms ({rep['n_device_events']} device events)", flush=True)
    for (lv, op), (c, t) in sorted(by.items()):
        bound = sum(r["bound_us"] for r in rep["k1"]
                    if r["level"] == lv and r["operand"] == op)
        print(f"{tag}: K1 level {lv:2d} {op:2s} x{c}: {t / 1e3:.4f} ms, "
              f"bound {bound / 1e3:.4f} ms ({bound / t:.0%})", flush=True)
    print(f"{tag}: K2 {rep['k2_launches']} launches, device "
          f"{rep['k2_us'] / 1e3:.4f} ms (bound {rep['k2_bound_us'] / 1e3:.5f} "
          f"ms)", flush=True)
    for w in rep["wrapper_kernels"][:12]:
        print(f"{tag}: wrapper {w['range']} {w['kernel']}: {w['count']} x, "
              f"{w['us'] / 1e3:.4f} ms", flush=True)
    for r in rep["timed"]:
        print(f"{tag}: timed run {r['wall_s']:.4f} s, levels sum "
              f"{r['levels_sum_ms']:.3f} ms, host "
              f"{ {k: round(v, 4) for k, v in r['host'].items()} }; levels "
              + " ".join(f"{x['level']}:{x['exec_wall_ms']:.3f}"
                         for x in r["levels"]), flush=True)
    print(f"{tag}: levels sum median {rep['levels_sum_median_ms']:.3f} ms "
          f"of {repeat} timed runs", flush=True)
    return rep


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--paths", default="stereo,mono")
    ap.add_argument("--out", default="profile_k1_out")
    ap.add_argument("--repeat", type=int, default=1,
                    help="timed runs per path (per-level walls)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_k1: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    for d in args.paths.split(","):
        profile_path(d, args.out, args.repeat)
    return 0


if __name__ == "__main__":
    sys.exit(main())
