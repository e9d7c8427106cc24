"""Profile kernels K1 and K2 on the port's 2,048-map main paths (one GPU).

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
  its tree level, its operand (A, Wd or Yd: per level A first; a tree
  whose refine joins form the Schur product with kernel K4 launches K1 for
  A alone, an older tree then Wd and Yd per feature stripe), its output's
  bytes and their write bound (bytes
  over 3.35 TB/s, the H100 SXM's HBM rate), and its device time;
* the device time of every other kernel launched inside K1's Python wrappers
  (output fills, the sort, `searchsorted`, ...), by wrapper and kernel name;
* the device time of all kernels launched inside `_assemble_schur_dense`;
* every launch of kernel K2 (`inv3x3_wy`, fused: V^-1 and Y = W V^-1[wf];
  or `inv3x3_sym`, the inverse alone, in a tree that has no fused entry),
  with its level, shape (P, N, K), device time and bound: `k2_bytes` over
  the HBM rate;
* the device time of every kernel at the Y sites, by level and kernel name:
  the kernels launched from a level's first K2 call (a "k2/<function>"
  range) to the start of its Schur assembly. In a tree with the fused
  kernel that is K2 alone; in one without, K2, the gather of V^-1[wf] and
  the batched product W V^-1[wf]; so the two trees compare at the same
  sites;
* the device busy time (union of kernel intervals) and span.

Every total is read from a trace in which each kernel launch, fill and
copy the host issued has its device record (`require_records`); late in a
long process the profiler can drop some, and the tool then fails rather
than print short totals.

The K1 and K2 wrappers are wrapped here in `torch.profiler.record_function`
ranges ("k1/<function>", "k2/<function>"); each level runs inside a
"level<n>" range. Nothing of the port is changed, and the tool runs
against an older tree of the port too, which is how parent and change are
compared: from that tree's root,
    PYTHONPATH=. python3 <this tree>/linearsfm_tpu_torch/tools/profile_k1.py
One JSON file per path goes to --out; the summary lines go to stdout, the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import subprocess
import sys
import time

N_MAPS = 2048
HBM_BYTES_PER_S = 3.35e12
_out_bytes = []   # output bytes of each K1 launch, in launch order
_k2_launches = []  # shape, bytes and level of each K2 launch


def _wrap(fn, label):
    import torch

    @functools.wraps(fn)
    def inner(*a, **k):
        with torch.profiler.record_function(label):
            return fn(*a, **k)
    return inner


def k2_bytes(P, N, K, esz):
    """Bytes one K2 launch must move: each V block's upper triangle read and
    its 9 inverse values written, each W entry's 18 values read and its 18
    Y values written, and its int64 (wp, wf) pair read (fetched whole)."""
    return P * N * (6 + 9) * esz + P * K * ((18 + 18) * esz + 16)


def _record_k2(kernels, name):
    """K2 entry `name`, recording each launch's shape and bytes."""
    fn = getattr(kernels, name)

    @functools.wraps(fn)
    def record(V, *rest):
        n0 = kernels.launches["inv3x3_sym"]
        out = fn(V, *rest)
        if kernels.launches["inv3x3_sym"] > n0:
            if rest:
                P, N, K = V.shape[0], V.shape[1], rest[0].shape[1]
            else:
                P, N, K = 1, V.numel() // 9, 0
            _k2_launches.append({"fn": name, "P": P, "N": N, "K": K,
                                 "dtype": str(V.dtype).split(".")[-1],
                                 "bytes": k2_bytes(P, N, K,
                                                   V.element_size())})
        return out
    return record


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
    # K2: the fused entry (this tree's main path) and the inverse alone (a
    # parent tree's); each launch's shape and the bytes it must move
    for name in ("inv3x3_wy", "inv3x3_sym"):
        if hasattr(kernels, name):
            setattr(kernels, name, _wrap(_record_k2(kernels, name),
                                         f"k2/{name}"))
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
            k0 = len(_k2_launches)
            out = level_fn(x, lp)
            n = kernels.launches["blockcoo_to_dense"] - n0
        for r in _k2_launches[k0:]:
            r["level"] = state["level"]
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
        _k2_launches.clear()
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


def load_trace(path):
    """(device events sorted by start, {correlation: host launch ts}, user
    ranges (start, end, name) sorted by start) of a torch.profiler Chrome
    trace. Device events are kernels, fills and copies."""
    with open(path) as fh:
        ev = json.load(fh)["traceEvents"]
    dev = sorted((e for e in ev if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")),
                 key=lambda e: e["ts"])
    launch = {}
    for e in ev:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "args" in e:
            c = e["args"].get("correlation")
            if c is not None:
                launch[c] = e["ts"]
    ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                     if e.get("cat") == "user_annotation"
                     and e.get("ph") == "X"), key=lambda r: r[0])
    return dev, launch, ranges


def innermost(ranges, ts, prefix):
    """The innermost range (start, end, name) holding host time ts whose
    name starts with prefix, or None."""
    best = None
    if ts is None:
        return None
    for r in ranges:
        if r[0] > ts:
            break
        if r[1] >= ts and r[2].startswith(prefix):
            if best is None or r[0] >= best[0]:
                best = r
    return best


def device_events_by_range(trace_path, prefix):
    """{range name: [(device us, device events, launches) of each
    instance]} over the ranges whose name starts with prefix: the summed
    durations and the count of the device events launched inside one
    instance of the range, and the count of the kernel launches, fills and
    copies the host issued inside it (each should have one device event;
    fewer means the profiler lost some)."""
    with open(trace_path) as fh:
        ev = json.load(fh)["traceEvents"]
    dev, launch, ranges = load_trace(trace_path)
    own = [r for r in ranges if r[2].startswith(prefix)]
    acc = {(r[0], r[2]): [0.0, 0, 0] for r in own}
    for e in dev:
        r = innermost(own, launch.get(e.get("args", {}).get("correlation")),
                      prefix)
        if r is not None:
            acc[(r[0], r[2])][0] += e["dur"]
            acc[(r[0], r[2])][1] += 1
    for e in ev:
        if (e.get("cat") in ("cuda_runtime", "cuda_driver")
                and re.search(r"Launch|Memset|Memcpy", e.get("name", ""))):
            r = innermost(own, e["ts"], prefix)
            if r is not None:
                acc[(r[0], r[2])][2] += 1
    out = {}
    for (_, name), rec in sorted(acc.items()):
        out.setdefault(name, []).append(tuple(rec))
    return out


_ISSUED = re.compile(r"Launch|Memset|Memcpy")


class LostRecords(AssertionError):
    """The profiler dropped device records of launches, fills or copies
    that the host issued: totals summed from such a trace read short."""


def record_counts(trace_path, start=None):
    """(issued, recorded) in a torch.profiler Chrome trace: the kernel
    launches, fills and copies the host issued (`cuda_runtime` /
    `cuda_driver` events whose name matches Launch|Memset|Memcpy, at host
    time >= start if given), and how many of them have a device record (a
    kernel, fill or copy event with the same correlation id)."""
    with open(trace_path) as fh:
        ev = json.load(fh)["traceEvents"]
    dev = {e.get("args", {}).get("correlation") for e in ev
           if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")}
    issued = recorded = 0
    for e in ev:
        if (e.get("cat") in ("cuda_runtime", "cuda_driver")
                and _ISSUED.search(e.get("name", ""))
                and (start is None or e["ts"] >= start)):
            issued += 1
            recorded += e.get("args", {}).get("correlation") in dev
    return issued, recorded


def require_records(trace_path, what, start=None):
    """Raises LostRecords, naming both counts, unless every launch, fill and
    copy of the trace (`record_counts`) has its device record."""
    issued, recorded = record_counts(trace_path, start)
    if recorded != issued:
        raise LostRecords(f"{what}: the profiler lost device records: "
                          f"{issued} kernel launches, fills and copies "
                          f"issued, {recorded} with a device record")


def _analyse(trace_path, labels):
    require_records(trace_path, "profile_k1")
    dev, launch_ts, ranges = load_trace(trace_path)
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
    levels = [r for r in ranges if re.fullmatch(r"level\d+", r[2])]
    assembles = [r for r in ranges if r[2] == "schur/assemble"]
    k2_calls = [r for r in ranges if r[2].startswith("k2/")]
    # the Y sites of a level: from its first K2 call to its Schur assembly
    sites = []
    for lv in levels:
        a = next((r[0] for r in k2_calls if lv[0] <= r[0] <= lv[1]), None)
        b = next((r[0] for r in assembles if lv[0] <= r[0] <= lv[1]), lv[1])
        if a is not None:
            sites.append((int(lv[2][5:]), a, b))
    wrapper, assembly_us, ysite = {}, 0.0, {}
    for e in dev:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        if innermost(ranges, ts, "schur/assemble"):
            assembly_us += e["dur"]
        for lv, a, b in sites:
            if a <= ts < b:
                key = (lv, e["name"][:90])
                c, t = ysite.get(key, (0, 0.0))
                ysite[key] = (c + 1, t + e["dur"])
        where = innermost(ranges, ts, "k1/")
        if where is None or "blockcoo" in e["name"]:
            continue
        key = (where[2], e["name"][:90])
        c, t = wrapper.get(key, (0, 0.0))
        wrapper[key] = (c + 1, t + e["dur"])
    k2 = [e for e in dev if "inv3x3" in e["name"]]
    if len(k2) != len(_k2_launches):
        raise AssertionError(f"{len(k2)} K2 kernels in the trace, "
                             f"{len(_k2_launches)} launches counted")
    k2_rows = [dict(lab, us=e["dur"],
                    bound_us=lab["bytes"] / HBM_BYTES_PER_S * 1e6)
               for e, lab in zip(k2, _k2_launches)]
    iv = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    span = (max(b for _, b in iv) - min(a for a, _ in iv)) if iv else 0.0
    return {"k1": rows,
            "k1_us": sum(r["us"] for r in rows),
            "k1_bound_us": sum(r["bound_us"] for r in rows),
            "wrapper_kernels": [{"range": w, "kernel": n, "count": c, "us": t}
                                for (w, n), (c, t) in sorted(
                                    wrapper.items(), key=lambda x: -x[1][1])],
            "assembly_us": assembly_us,
            "k2": k2_rows, "k2_launches": len(k2),
            "k2_us": sum(r["us"] for r in k2_rows),
            "k2_bound_us": sum(r["bound_us"] for r in k2_rows),
            "y_sites": [{"level": lv, "kernel": n, "count": c, "us": t}
                        for (lv, n), (c, t) in sorted(ysite.items())],
            "y_sites_us": sum(t for _, t in ysite.values()),
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
          f"{rep['k2_us'] / 1e3:.4f} ms (bound {rep['k2_bound_us'] / 1e3:.4f} "
          f"ms, {rep['k2_bound_us'] / max(rep['k2_us'], 1e-9):.0%}); kernels "
          f"at the Y sites {rep['y_sites_us'] / 1e3:.4f} ms", flush=True)
    for r in rep["k2"]:
        print(f"{tag}: K2 level {r.get('level', 0):2d} {r['fn']} P {r['P']} "
              f"N {r['N']} K {r['K']} {r['dtype']}: {r['us']:.2f} us, bound "
              f"{r['bound_us']:.2f} us ({r['bound_us'] / r['us']:.0%})",
              flush=True)
    for y in rep["y_sites"]:
        print(f"{tag}: Y site level {y['level']:2d} {y['kernel']}: "
              f"{y['count']} x, {y['us']:.2f} us", flush=True)
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
