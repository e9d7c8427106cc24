"""The solver's spans on the card, for PERF.md: what one span costs with no
profiler recording, the fused map with and without a profiler session (and
saved, for a bit-for-bit comparison with another tree's), a traced solve
per cell with its idle gaps put under the program's innermost span, and
traced solves with and without the program's profiler ranges (patched out
here, in turns).

    python3 _archive/spans18/probe.py --root TREE --maps-out DIR
        [--save-only] [--seed N] [--pairs K]

--root: the tree whose `linearsfm_tpu_torch` runs (the benchmark's
generator and configurations come from this tree). --save-only: only the
warm and the plain solve of each cell, whose fused map is saved.
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

PROGRAM_SPANS = ("ingest_plan", "plan_tree", "upload", "levels", "level",
                 "transform", "join", "sync", "regauge_compact", "final")
CELLS = (("rs468_mono", "rs468_mono.covis"),
         ("nc3500_stereo", "nc3500_stereo.covis"))


def per_span_cost(n=200, per=1000):
    """ns per span and per count: no recorder (the shared no-op), and a
    recorder open with no profiler recording (a solve's case: n recorders
    of `per` spans each, about a solve's number)."""
    from linearsfm_tpu_torch.utils import metrics
    out = {}
    t = time.perf_counter_ns()
    for _ in range(n * per):
        with metrics.span("x", level=1):
            pass
    out["span_noop_ns"] = (time.perf_counter_ns() - t) / (n * per)
    t = time.perf_counter_ns()
    for _ in range(n * per):
        metrics.count("x")
    out["count_noop_ns"] = (time.perf_counter_ns() - t) / (n * per)
    span_ns = count_ns = 0
    for _ in range(n):
        with metrics.recording():
            t = time.perf_counter_ns()
            for _ in range(per):
                with metrics.span("x", level=1):
                    pass
            span_ns += time.perf_counter_ns() - t
            with metrics.span("y"):
                t = time.perf_counter_ns()
                for _ in range(per):
                    metrics.count("x")
                count_ns += time.perf_counter_ns() - t
    out["span_on_ns"] = span_ns / (n * per)
    out["count_on_ns"] = count_ns / (n * per)
    return out


def traced(solve, ranges=True):
    """(wall of solve() inside a CPU+CUDA profiler session, its events);
    ranges=False patches the program's profiler ranges out."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    rf = torch.profiler.record_function
    if not ranges:
        torch.profiler.record_function = lambda name: contextlib.nullcontext()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            x = torch.empty(64, device="cuda")
            for _ in range(64):
                x.fill_(0.0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            with record_function("probe_solve"):
                solve()
            wall = time.perf_counter() - t
    finally:
        torch.profiler.record_function = rf
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        p.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    return wall, events


def gaps_by_span(events):
    """The traced solve's idle gaps, each named by the innermost program
    span holding its middle: (wall s, busy s, [(name, s)] largest first,
    {name: idle s})."""
    solve = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == "probe_solve"][0]
    t0, t1 = solve["ts"], solve["ts"] + solve["dur"]
    dev = sorted((e["ts"], min(e["ts"] + e["dur"], t1)) for e in events
                 if e.get("ph") == "X"
                 and e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")
                 and t0 <= e["ts"] < t1)
    busy = []
    for a, b in dev:
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") in PROGRAM_SPANS)
    gaps, prev = [], t0
    for a, b in busy + [[t1, t1]]:
        if a > prev:
            mid, name = 0.5 * (a + prev), "solve"
            for s0, s1, nm in spans:
                if s0 <= mid <= s1:
                    name = nm
            gaps.append((name, (a - prev) * 1e-6))
        prev = max(prev, b)
    by = {}
    for nm, g in gaps:
        by[nm] = by.get(nm, 0.0) + g
    return ((t1 - t0) * 1e-6, sum(b - a for a, b in busy) * 1e-6,
            sorted(gaps, key=lambda g: -g[1]), by)


def runtime_by_span(events):
    """Host seconds inside CUDA runtime and driver calls (launches, copies,
    synchronises: a full launch queue blocks the launch), by the innermost
    program span holding each call's start, and the longest calls as
    (name, ms, span, level number)."""
    solve = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == "probe_solve"][0]
    t0, t1 = solve["ts"], solve["ts"] + solve["dur"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") in PROGRAM_SPANS)
    levels = [s for s in spans if s[2] == "level"]
    by, calls = {}, []
    for e in events:
        if (e.get("cat") not in ("cuda_runtime", "cuda_driver")
                or not t0 <= e["ts"] < t1):
            continue
        name, lv = "solve", 0
        for s0, s1, nm in spans:
            if s0 <= e["ts"] <= s1:
                name = nm
        for k, (s0, s1, _) in enumerate(levels, start=1):
            if s0 <= e["ts"] <= s1:
                lv = k
        by[name] = by.get(name, 0.0) + e["dur"] * 1e-6
        calls.append((e["name"], round(e["dur"] * 1e-3, 3), name, lv))
    return by, sorted(calls, key=lambda c: -c[1])[:8]


def level_rows(solver):
    from linearsfm_tpu_torch.utils.metrics import self_seconds, subtree
    spans, rows = solver.last_spans, []
    for i, sp in enumerate(spans):
        if sp["name"] == "level":
            under = subtree(spans, i)
            own = self_seconds(spans, [i] + under)
            rows.append(dict(sp["attrs"], host_ms={
                k: round(own.get(k, 0.0) * 1e3, 3) for k in
                ("level", "transform", "join", "sync", "regauge_compact")},
                sweeps=sum(spans[j]["attrs"].get("pcg_sweeps", 0)
                           for j in under)))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--maps-out", required=True,
                    help="where the fused maps are saved (large)")
    ap.add_argument("--save-only", action="store_true")
    ap.add_argument("--seed", type=int, default=9180000001)
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.makedirs(args.maps_out, exist_ok=True)
    import torch
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch import types
    from benchmark import gen
    if not args.save_only:
        from linearsfm_tpu_torch.utils.metrics import self_seconds
    print(f"tree {root}; torch {torch.__version__}, CUDA {torch.version.cuda}"
          f", {torch.cuda.get_device_name(0)}", flush=True)
    kernels.build()
    if not args.save_only:
        print("profiler_enabled() outside a session:",
              torch._C._autograd._profiler_enabled(), flush=True)
        print("per span / count cost:", json.dumps(per_span_cost()),
              flush=True)

    def sync():
        torch.cuda.synchronize()

    for cfg_name, cell in CELLS:
        with open(os.path.join(root, "benchmark", "configs",
                               f"{cfg_name}.json")) as fh:
            cfg = json.load(fh)
        with open(os.path.join(root, "benchmark", "traffic",
                               "covis.json")) as fh:
            mix = json.load(fh)
        warm = gen.make_set(cfg, mix, args.seed, -1)
        maps = gen.make_set(cfg, mix, args.seed, 0)
        solver = DeviceTreeSolver(cfg["datatype"], method=cfg["method"],
                                  device="cuda")
        solver.run(warm)
        sync()
        t = time.perf_counter()
        plain = solver.run(maps)
        sync()
        wall = time.perf_counter() - t
        fields = {f: getattr(plain, f).cpu() for f in types.MAP_FIELDS}
        torch.save(fields, os.path.join(args.maps_out, f"{cell}.pt"))
        print(f"{cell}: plain solve {wall:.4f} s, timing "
              f"{ {k: round(v, 6) for k, v in solver._last_timing.items()} }",
              flush=True)
        if args.save_only:
            continue
        own = self_seconds(solver.last_spans)
        print(f"{cell}: self s by span "
              f"{ {k: round(v, 6) for k, v in own.items()} }", flush=True)
        names = {}
        for sp in solver.last_spans:
            names[sp["name"]] = names.get(sp["name"], 0) + 1
        print(f"{cell}: {len(solver.last_spans)} spans per solve {names}",
              flush=True)
        for r in level_rows(solver):
            print(f"{cell}: level {json.dumps(r)}", flush=True)
        out = {}

        def solve():
            out["y"] = solver.run(maps)
            sync()
        w_on, events = traced(solve)
        same = all(torch.equal(getattr(out["y"], f).cpu(), fields[f])
                   for f in types.MAP_FIELDS)
        print(f"{cell}: traced solve {w_on:.4f} s; fused map torch.equal "
              f"with and without the profiler: {same}", flush=True)
        ranges = sum(1 for e in events if e.get("cat") == "user_annotation"
                     and e.get("name") in PROGRAM_SPANS)
        print(f"{cell}: program ranges in the trace {ranges} of "
              f"{len(solver.last_spans)} spans", flush=True)
        w, busy, gaps, by = gaps_by_span(events)
        print(f"{cell}: traced wall {w:.4f} s, busy {busy:.4f} s, idle "
              f"{100 * (1 - busy / w):.2f}%", flush=True)
        print(f"{cell}: idle by innermost span (s) "
              f"{ {k: round(v, 5) for k, v in sorted(by.items(), key=lambda kv: -kv[1])} }",
              flush=True)
        rt, longest = runtime_by_span(events)
        print(f"{cell}: host s in CUDA runtime calls by innermost span "
              f"{ {k: round(v, 5) for k, v in sorted(rt.items(), key=lambda kv: -kv[1])} }",
              flush=True)
        print(f"{cell}: longest runtime calls (name, ms, span, level) "
              f"{longest}", flush=True)
        print(f"{cell}: top idle gaps (ms) "
              f"{[(n, round(g * 1e3, 3)) for n, g in gaps[:12]]}", flush=True)
        walls = {True: [], False: []}
        for k in range(args.pairs):
            for on in ((True, False) if k % 2 == 0 else (False, True)):
                walls[on].append(round(traced(solve, on)[0], 4))
        print(f"{cell}: traced solve walls, with the program's ranges "
              f"{walls[True]}, without {walls[False]}", flush=True)
        del solver, plain, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
