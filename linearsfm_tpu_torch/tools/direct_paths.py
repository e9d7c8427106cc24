"""Measurements of the direct (float64 Cholesky) paths at 2,048 maps,
one GPU.

    python3 -m linearsfm_tpu_torch.tools.direct_paths [--parts schur,ate]
        [--paths stereo,mono] [--reps 3] [--out direct_paths_out]
        [--maps 2048] [--exec device,dense,host] [--method direct]
        [--profile] [--cpu]

The data is `chip_smoke.py`'s 2,048-map covis set (seed 7, noise 0.005,
covis radius 6, at most 6 co-visible features per map).

schur: grouped against dense Schur assembly on the host executor
(`TreeSolver(datatype, method="direct")`, the CLI's `--exec host`). One run
of the tree keeps each batched level's inputs (the lane stacks and
`JoinConfig` that `TreeSolver._merge` receives: levels 1-10; the root is a
single pair). Each level's join then runs again on those inputs as shipped
(grouped below `schur._DENSE_SCHUR_DIM`, else dense) and forced dense
(`dense_schur=True`), alternating shipped, dense, dense, shipped for --reps
rounds. Reported per level: the join's wall (synchronised before and after;
the host executor waits for exactly this), min and median, K1 and K2
launches per join, and the largest pose difference between the two.

ate: run-to-run spread of the device executor's direct path
(`DeviceTreeSolver(datatype, method="direct")`, the CLI's default) — --reps
runs in each of three modes: PyTorch's defaults; PyTorch's global mode,
`torch.use_deterministic_algorithms(True, warn_only=True)` (index_add_ and
index_put_ sum in a fixed order; the operations that still warn are
listed); and the port's own scope, `ops/segment.deterministic()` (kernel
K3), whose first run also lists every accumulating scatter that still ran
on the card (`index_add_`, `index_put_` with accumulate, `scatter_add_`,
`scatter_reduce_`, `index_reduce_`, `put_`, `bincount`, `histc`; by
dtype): an integer sum is exact in any order, a float one would wander.
Each run prints its ATE to 12 digits and its largest pose difference from
the mode's first run. The first run also reports the condition number of
the root's reduced system over its free coordinates (eigenvalues by
`torch.linalg.eigvalsh`, float64). CUBLAS_WORKSPACE_CONFIG=:4096:8 is set
for the whole process, as the deterministic modes require.

order: each executor's (--exec device,dense,host) solve by --method
(direct by default) timed with PyTorch's default sums and in a fixed order
(`ops/segment.deterministic`), in --reps warm pairs after a warm-up run,
default first in the even pairs and fixed first in the odd ones: walls
(the device and dense executors' level walls too), ATEs, the pose spread
within each mode and the median of the pairs' fixed / default ratios.
The executors' own scope is turned off while it runs (the mode decides).
--profile adds one run of each mode under torch.profiler: the device time
of the segment sums (`index_add_`, `index_put_`, K3's kernel and the sort
and search of its plans) and of the fills of uninitialized memory, read
from the run's Chrome trace, and K3's launches by call site: each launch
runs inside a "k3/<module>:<line>" range (its caller in the port), and
each site prints its launches, device time, (P, num, tail, dtype), longest
segment and summed bound (bytes, and the chain floor at the add latency
the tool measures first), then the totals and the launch of the most
device time. A
trace in which any kernel launch, fill or copy lacks its device record
(late in a long process the profiler drops some) is not summed: the run
is profiled again, at most three times, then the tool fails.

The card's name and power limit come first; one JSON file per part goes to
--out. --cpu (with a small --maps) rehearses the tool on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

ORACLE_ATE_2048 = {"stereo": 0.009758730, "mono": 0.014352172}
_run = {"device": "cuda", "maps": 2048}


@contextlib.contextmanager
def _own_scope_off():
    """The executors' own fixed-order scope (`ops/segment.deterministic`,
    entered by the device and dense executors for direct mono) replaced by
    a no-op while active; yields the real scope, for the caller's mode."""
    from linearsfm_tpu_torch.ops import segment
    scope = segment.deterministic
    segment.deterministic = contextlib.nullcontext
    try:
        yield scope
    finally:
        segment.deterministic = scope


def _sync():
    import torch
    if _run["device"] == "cuda":
        torch.cuda.synchronize()


@functools.lru_cache(maxsize=None)
def _dataset(datatype):
    from synth import generate as gen
    maps, poses_gt, _ = gen.make_dataset(_run["maps"], datatype, noise=0.005,
                                         seed=7, covis_radius=6.0,
                                         covis_max=6)
    return maps, poses_gt


def _poses(lm):
    """{pose id: pose} of a solved map (host form or one-lane stack)."""
    from linearsfm_tpu_torch import types
    h = types.host_fields(lm)
    return {int(i): h.poses[s] for s, i in enumerate(h.pose_ids) if i >= 0}


def _ate(poses, poses_gt):
    import numpy as np
    err = [float(np.linalg.norm(p[:3] - poses_gt[i][:3]))
           for i, p in poses.items()]
    return float(np.sqrt(np.mean(np.square(err))))


def _max_diff(a, b):
    import numpy as np
    if set(a) != set(b):
        return float("nan")
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def schur_part(datatype, reps):
    """Grouped (as shipped) against forced-dense assembly per level of the
    host executor; returns one record per batched level."""
    import torch
    from linearsfm_tpu_torch.core.tree import TreeSolver
    from linearsfm_tpu_torch.ops import kernels, schur

    maps, poses_gt = _dataset(datatype)
    solver = TreeSolver(datatype, method="direct", device=_run["device"])
    kept = []
    merge = solver._merge

    def keep(G, Mb, cfg):
        kept.append((G, Mb, cfg))
        return merge(G, Mb, cfg)
    solver._merge = keep
    t0 = time.perf_counter()
    root = solver.run(maps)
    _sync()
    wall = time.perf_counter() - t0
    solver._merge = merge
    print(f"schur {datatype}: host executor run {wall:.3f} s, ATE "
          f"{_ate(_poses(root), poses_gt):.12f}, {len(kept)} batched levels "
          f"kept", flush=True)

    def timed(G, Mb, cfg):
        n0 = dict(kernels.launches)
        _sync()
        t = time.perf_counter()
        out = solver._merge(G, Mb, cfg)
        _sync()
        dt = time.perf_counter() - t
        return dt, out, {k: kernels.launches[k] - n0[k] for k in n0}

    rows = []
    for level, (G, Mb, cfg) in enumerate(kept, start=1):
        Mo = G.M + Mb.M
        shipped = ("dense" if cfg.dense_schur
                   or 6 * Mo >= schur._DENSE_SCHUR_DIM else "grouped")
        dense = cfg._replace(dense_schur=True)
        timed(G, Mb, cfg)          # warm-up of both
        timed(G, Mb, dense)
        ts, td = [], []
        for _ in range(reps):
            ts.append(timed(G, Mb, cfg)[0])
            td.append(timed(G, Mb, dense)[0])
            td.append(timed(G, Mb, dense)[0])
            ts.append(timed(G, Mb, cfg)[0])
        _, a, la = timed(G, Mb, cfg)
        _, b, lb = timed(G, Mb, dense)
        diff = float((a.poses - b.poses).abs().max())
        r = dict(level=level, lanes=int(G.poses.shape[0]), Mo=Mo,
                 six_M=6 * Mo, No=G.N + Mb.N, max_obs=cfg.max_obs,
                 shipped=shipped,
                 shipped_s=ts, dense_s=td, shipped_launches=la,
                 dense_launches=lb, max_pose_diff=diff)
        rows.append(r)
        print(f"schur {datatype} level {level:2d}: {r['lanes']:4d} lanes, "
              f"Mo {Mo:5d} (6M {6 * Mo:5d}), No {r['No']:6d}, max_obs "
              f"{cfg.max_obs:3d}; shipped ({shipped}) min "
              f"{min(ts) * 1e3:.3f} ms median "
              f"{statistics.median(ts) * 1e3:.3f} ms, launches {la}; forced "
              f"dense min {min(td) * 1e3:.3f} ms median "
              f"{statistics.median(td) * 1e3:.3f} ms, launches {lb}; max pose "
              f"diff {diff:.3e}", flush=True)
        del a, b
    tot_s = sum(min(r["shipped_s"]) for r in rows)
    tot_d = sum(min(r["dense_s"]) for r in rows)
    print(f"schur {datatype}: sum over levels of the min join wall: shipped "
          f"{tot_s * 1e3:.3f} ms, forced dense {tot_d * 1e3:.3f} ms",
          flush=True)
    return dict(datatype=datatype, run_s=wall, levels=rows)


def _root_condition(captured):
    """Condition number of the largest reduced system seen, over its free
    coordinates (float64 eigenvalues)."""
    import torch
    S, fixed = captured
    free = (~fixed[0]).nonzero().reshape(-1)
    Sf = S[0].index_select(0, free).index_select(1, free)
    ev = torch.linalg.eigvalsh(Sf)
    lo, hi = float(ev[0]), float(ev[-1])
    return dict(dim=int(Sf.shape[0]), eig_min=lo, eig_max=hi,
                cond=hi / lo if lo > 0 else float("inf"))


def ate_part(datatype, reps):
    """Run-to-run spread of the direct device executor, default and
    deterministic; returns the runs' ATEs and pose spreads."""
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver

    maps, poses_gt = _dataset(datatype)
    solver = DeviceTreeSolver(datatype, method="direct",
                              device=_run["device"])
    with _own_scope_off() as scope:    # the mode below decides
        return _ate_runs(solver, maps, poses_gt, datatype, reps, scope)


_ACCUMULATING = ("index_add", "index_put", "_index_put_impl",
                 "scatter_add", "scatter_reduce", "index_reduce", "put",
                 "bincount", "histc")


def _census():
    """A dispatch mode that counts the accumulating scatters on CUDA
    tensors by op and dtype (`index_put_` only with accumulate=True);
    its `seen` is a Counter."""
    import collections
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Census(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            if name.rstrip("_") in _ACCUMULATING and args:
                x = args[0]
                acc = (kwargs.get("accumulate", args[3] if len(args) > 3
                                  else False)
                       if "index_put" in name else True)
                if (acc and isinstance(x, torch.Tensor)
                        and x.device.type == "cuda"):
                    self.seen[f"{name} {str(x.dtype).split('.')[-1]}"] += 1
            return func(*args, **kwargs)
    return Census()


def _ate_runs(solver, maps, poses_gt, datatype, reps, scope):
    """The ate part's runs; `scope` is the port's fixed-order scope."""
    import torch
    from linearsfm_tpu_torch.ops import solve

    solver.run(maps)                   # warm-up
    out = dict(datatype=datatype, oracle=ORACLE_ATE_2048[datatype])
    for mode in ("default", "deterministic", "fixed"):
        torch.use_deterministic_algorithms(mode == "deterministic",
                                           warn_only=True)
        census = _census() if mode == "fixed" else None
        runs, first, warned = [], None, set()
        for rep in range(reps):
            captured = []
            reduced = solve.solve_reduced

            def keep(S, E, fixed_mask=None, *a, **k):
                big = not captured or S.shape[-1] > captured[0][0].shape[-1]
                if fixed_mask is not None and big:
                    captured[:] = [(S, fixed_mask)]
                return reduced(S, E, fixed_mask, *a, **k)
            if rep == 0 and mode == "default":
                solve.solve_reduced = keep
            counting = census if rep == 0 else None
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                try:
                    with (scope() if mode == "fixed"
                          else contextlib.nullcontext()), (
                            counting or contextlib.nullcontext()):
                        p = _poses(solver.run(maps))
                finally:
                    solve.solve_reduced = reduced
                wall = time.perf_counter() - t0
            warned |= {str(w.message).split("\n")[0][:160] for w in caught
                       if "deterministic" in str(w.message)}
            first = first or p
            r = dict(ate=_ate(p, poses_gt), wall_s=wall,
                     max_pose_diff_vs_first=_max_diff(p, first))
            runs.append(r)
            print(f"ate {datatype} {mode} run {rep}: ATE {r['ate']:.12f} "
                  f"(oracle {out['oracle']:.9f}, diff "
                  f"{r['ate'] - out['oracle']:+.3e}), max pose diff vs the "
                  f"first run {r['max_pose_diff_vs_first']:.3e}, wall "
                  f"{wall:.3f} s", flush=True)
            if captured:
                c = _root_condition(captured[0])
                out["root"] = c
                print(f"ate {datatype}: root reduced system over its "
                      f"{c['dim']} free coordinates: eigenvalues "
                      f"{c['eig_min']:.6e} .. {c['eig_max']:.6e}, condition "
                      f"number {c['cond']:.6e}", flush=True)
                del captured[:]
        spread = max(r["ate"] for r in runs) - min(r["ate"] for r in runs)
        out[mode] = dict(runs=runs, ate_spread=spread,
                         still_nondeterministic=sorted(warned))
        print(f"ate {datatype} {mode}: ATE spread over {reps} runs "
              f"{spread:.3e}; operations without a deterministic version "
              f"that ran: {sorted(warned) or 'none'}", flush=True)
        if census is not None:
            out[mode]["accumulating_on_card"] = dict(census.seen)
            print(f"ate {datatype} {mode}: accumulating scatters on the "
                  f"card in run 0 (op dtype: calls): "
                  f"{dict(census.seen) or 'none'}", flush=True)
    torch.use_deterministic_algorithms(False)
    return out


_SUM_OPS = ("aten::index_add_", "aten::index_put_", "aten::fill_",
            "aten::sort", "aten::searchsorted")
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# frames that lie between a K3 call site and the kernel's wrapper
_PASS = tuple(os.path.join(_PKG, *f) for f in (("ops", "segment.py"),
                                                ("ops", "kernels.py"),
                                                ("tools", "direct_paths.py")))


def _call_site():
    """The K3 call site "<module path>:<line>" under the package: the first
    frame of the port outside ops/segment, ops/kernels and this tool."""
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PKG) and path not in _PASS:
            return f"{os.path.relpath(path, _PKG)}:{f.f_lineno}"
        f = f.f_back
    return "other"


@contextlib.contextmanager
def _k3_sites():
    """While active every call of K3's wrapper (`kernels.seg_sum_fixed`) runs
    inside a torch.profiler range "k3/<call site>", and yields a list that
    collects one record per call: its site, (P, K, num, tail, dtype), the
    form (a new sum or accumulate-into), whether it launched, and the plan's
    offsets (read after the run, so the run gains no sync)."""
    import torch
    from linearsfm_tpu_torch.ops import kernels
    fn = kernels.seg_sum_fixed
    calls = []

    def labelled(vals, plan, out=None, alpha=1):
        site = _call_site()
        n0 = kernels.launches["seg_sum_fixed"]
        with torch.profiler.record_function(f"k3/{site}"):
            res = fn(vals, plan, out, alpha)
        calls.append(dict(site=site, P=plan.P, K=plan.K, num=plan.num,
                          tail=tuple(vals.shape[2:]),
                          dtype=str(vals.dtype).split(".")[-1],
                          esz=vals.element_size(), into=out is not None,
                          launched=kernels.launches["seg_sum_fixed"] > n0,
                          off=plan.off))
        return res
    kernels.seg_sum_fixed = labelled
    try:
        yield calls
    finally:
        kernels.seg_sum_fixed = fn


def _order_run(solver, maps, scope, metrics=None):
    """One timed run under `scope`: (poses by id, wall, level walls sum or
    None; the host executor has no level walls)."""
    from linearsfm_tpu_torch.core.tree import TreeSolver
    from linearsfm_tpu_torch.utils.metrics import LevelMetrics
    metrics = LevelMetrics() if metrics is None else metrics
    kw = {} if isinstance(solver, TreeSolver) else dict(time_levels=True)
    _sync()
    t0 = time.perf_counter()
    with scope():
        p = _poses(solver.run(maps, metrics=metrics, **kw))
    _sync()
    wall = time.perf_counter() - t0
    lv = [r["exec_wall"] for r in metrics.records if "exec_wall" in r]
    return p, wall, sum(lv) if lv else None


def _trace_totals(trace_path):
    """From a torch.profiler Chrome trace: the calls, host time and device
    time (ms) of each op of _SUM_OPS (the kernels, fills and copies launched
    inside any of its calls), of K3 ("K3": its launches, each a direct
    kernel and a ring kernel, and their summed device time), and K3's
    device time (us) in each "k3/<site>" range, in the ranges' order
    ("k3_us"). Raises
    profile_k1.LostRecords when a launch, fill or copy of the trace (from
    the start of its "order/run" range, if it has one) has no device
    record: the totals would read short."""
    import bisect
    from linearsfm_tpu_torch.tools.profile_k1 import require_records
    with open(trace_path) as fh:
        ev = json.load(fh)["traceEvents"]
    run = [e["ts"] for e in ev if e.get("cat") == "user_annotation"
           and e.get("name") == "order/run"]
    require_records(trace_path, "direct_paths --profile",
                    start=min(run) if run else None)
    launch, dev, sites = {}, [], []
    ops = {k: [] for k in _SUM_OPS}
    for e in ev:
        cat, name = e.get("cat"), e.get("name", "")
        if cat in ("cuda_runtime", "cuda_driver"):
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = e["ts"]
        elif e.get("ph") != "X":
            continue
        elif cat == "cpu_op" and name in ops:
            ops[name].append((e["ts"], e["ts"] + e["dur"]))
        elif cat == "user_annotation" and name.startswith("k3/"):
            sites.append((e["ts"], e["ts"] + e["dur"]))
        elif cat in ("kernel", "gpu_memset", "gpu_memcpy"):
            dev.append(e)
    out = {}
    spans = {}
    for name, iv in ops.items():
        out[name] = dict(calls=len(iv), device_ms=0.0,
                         cpu_ms=sum(b - a for a, b in iv) / 1e3)
        merged = []
        for a, b in sorted(iv):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        spans[name] = ([a for a, _ in merged], [b for _, b in merged])
    sites.sort()
    starts = [a for a, _ in sites]
    k3_us = [0.0] * len(sites)
    out["K3"] = dict(calls=0, device_ms=0.0)

    def inside(starts, ends, t):
        i = bisect.bisect_right(starts, t) - 1
        return i if i >= 0 and t <= ends[i] else None
    for e in dev:
        t = launch.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        for name, (a, b) in spans.items():
            if inside(a, b, t) is not None:
                out[name]["device_ms"] += e["dur"] / 1e3
        if "seg_sum" in e["name"]:       # K3's kernels (two per launch)
            out["K3"]["calls"] += "seg_sum_ring" not in e["name"]
            out["K3"]["device_ms"] += e["dur"] / 1e3
            i = inside(starts, [b for _, b in sites], t)
            if i is not None:
                k3_us[i] += e["dur"]
    out["k3_us"] = k3_us
    return out


def add_latency_ns(dtype, n=2**20):
    """The card's dependent add latency in `dtype` (ns): K3's chain-floor
    probe (`kernels.add_chain`, one thread, each add waiting for the last)
    timed by CUDA events at n and 2n adds, the least of three differences
    over n (the launch's own cost cancels)."""
    import torch
    from linearsfm_tpu_torch.ops import kernels
    x = torch.tensor([1.0, 2.0**-30], dtype=dtype, device="cuda")

    def ms(m):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        kernels.add_chain(x, m)
        b.record()
        b.synchronize()
        return a.elapsed_time(b)
    ms(n)
    return min(ms(2 * n) - ms(n) for _ in range(3)) / n * 1e6


def _k3_census(calls, k3_us, add_ns=None):
    """K3's launches by call site: launches, device time (ms; `k3_us`, one
    entry per call in call order, from `_trace_totals`), summed over the
    launches the byte bound (`kernels.seg_sum_bytes` over 3.35 TB/s), the
    chain floor (the longest segment's adds at `add_ns[dtype]` ns each;
    0 without `add_ns`) and the bound (the larger of the two, launch by
    launch), the longest segment, and the distinct (P, num, tail, dtype);
    and the launch of the most device time. Reads each call's plan offsets
    (syncs). Raises profile_k1.LostRecords when the trace holds another
    number of "k3/<site>" ranges than there were calls: the per-site
    times would read short or land on the wrong sites."""
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.tools.profile_k1 import LostRecords
    if len(k3_us) != len(calls):
        raise LostRecords(f"K3 census: {len(calls)} calls of the wrapper, "
                          f"{len(k3_us)} k3/<site> ranges in the trace")
    sites, worst = {}, None
    for c, us in zip(calls, k3_us):
        P, num = c["P"], c["num"]
        lens = (c["off"][1:] - c["off"][:-1]).view(P, num + 1)[:, :num]
        longest = int(lens.max()) if lens.numel() else 0
        nbytes = kernels.seg_sum_bytes(int(lens.sum()), P, num,
                                       math.prod(c["tail"]), c["esz"],
                                       c["into"])
        byte_ms = nbytes / 3.35e12 * 1e3
        chain_ms = longest * (add_ns or {}).get(c["dtype"], 0.0) * 1e-6
        bound = max(byte_ms, chain_ms)
        r = sites.setdefault(c["site"], dict(launches=0, device_ms=0.0,
                                             byte_ms=0.0, chain_ms=0.0,
                                             bound_ms=0.0, longest=0,
                                             shapes={}))
        r["launches"] += c["launched"]
        r["device_ms"] += us / 1e3
        r["byte_ms"] += byte_ms * c["launched"]
        r["chain_ms"] += chain_ms * c["launched"]
        r["bound_ms"] += bound * c["launched"]
        r["longest"] = max(r["longest"], longest)
        shape = f"({P}, {num}, {c['tail']}, {c['dtype']})"
        r["shapes"][shape] = r["shapes"].get(shape, 0) + 1
        if c["launched"] and (worst is None or us > worst["us"]):
            worst = dict(site=c["site"], P=P, K=c["K"], num=num,
                         tail=c["tail"], dtype=c["dtype"], into=c["into"],
                         longest=longest, us=us, byte_ms=byte_ms,
                         chain_ms=chain_ms)
    return dict(sites=dict(sorted(sites.items(),
                                  key=lambda x: -x[1]["device_ms"])),
                worst=worst)


def _order_profile(solver, maps, scope, attempts=3):
    """Device time (ms) and calls of the segment sums and fills in one
    profiled run under `scope`, and K3's census by call site
    (`_k3_census`). A run whose trace lacks a device record of any launch,
    fill or copy, or the range of any K3 call, is profiled again, at most `attempts` times in all; then
    it fails (profile_k1.LostRecords)."""
    import tempfile
    import torch
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.tools.profile_k1 import LostRecords
    acts = [torch.profiler.ProfilerActivity.CPU]
    add_ns = None
    if _run["device"] == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        add_ns = {str(d).split(".")[-1]: add_latency_ns(d)
                  for d in (torch.float32, torch.float64)}
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    pad = torch.empty(1024, device=_run["device"])
    for attempt in range(1, attempts + 1):
        with _k3_sites() as calls, torch.profiler.profile(
                activities=acts) as prof:
            # late in a long process the profiler drops a session's first
            # device records: 64 small fills outside the counted range
            for _ in range(64):
                pad.zero_()
            _sync()
            with torch.profiler.record_function("order/run"):
                _order_run(solver, maps, scope)
        with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
            trace = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(trace)
            try:
                out = _trace_totals(trace)
                out["k3_census"] = _k3_census(calls, out.pop("k3_us"),
                                              add_ns)
            except LostRecords as err:
                print(f"order profile, attempt {attempt} of {attempts}: "
                      f"{err}", flush=True)
                continue
        out["k3_census"]["add_ns"] = add_ns
        return out
    raise LostRecords(f"order profile: device records lost in {attempts} "
                      f"profiled runs")


def _print_census(tag, census):
    """K3's census (`_k3_census`) as one line per call site, the totals
    and the worst launch; nothing where K3 did not run."""
    if not census["sites"]:
        return
    for site, r in census["sites"].items():
        shapes = sorted(r["shapes"].items(), key=lambda x: -x[1])
        more = f" and {len(shapes) - 3} more" if len(shapes) > 3 else ""
        print(f"{tag}: K3 at {site}: {r['launches']} launches, device "
              f"{r['device_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms (bytes "
              f"{r['byte_ms']:.3f}, chain {r['chain_ms']:.3f}), longest "
              f"segment {r['longest']}; (P, num, tail, dtype) x calls: "
              + ", ".join(f"{k} x{n}" for k, n in shapes[:3]) + more,
              flush=True)
    tot = {k: sum(r[k] for r in census["sites"].values())
           for k in ("launches", "device_ms", "byte_ms", "chain_ms",
                     "bound_ms")}
    print(f"{tag}: K3 in all: {tot['launches']} launches, device "
          f"{tot['device_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms "
          f"(bytes {tot['byte_ms']:.3f}, chain {tot['chain_ms']:.3f}; add "
          f"latency {census.get('add_ns')} ns)", flush=True)
    w = census["worst"]
    if w is not None:
        print(f"{tag}: K3's longest launch: {w['site']} (P, K, num) "
              f"({w['P']}, {w['K']}, {w['num']}) tail {w['tail']} "
              f"{w['dtype']}{' into' if w['into'] else ''}, longest "
              f"segment {w['longest']}, device {w['us'] / 1e3:.4f} ms, byte "
              f"bound {w['byte_ms']:.4f} ms, chain floor "
              f"{w['chain_ms']:.4f} ms", flush=True)


def order_part(datatype, reps):
    """Wall of each --exec executor's solve (--method) with PyTorch's default
    sums against the same solve under `ops/segment.deterministic()`, in
    --reps warm pairs (default first in even pairs, fixed first in odd);
    returns per executor the walls, level walls, ATEs, pose spreads, the
    median of the pairs' fixed / default ratios and (--profile) the sums'
    device time by mode."""
    from linearsfm_tpu_torch.core.dense_tree import DenseTreeSolver
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.core.tree import TreeSolver

    classes = {"device": DeviceTreeSolver, "dense": DenseTreeSolver,
               "host": TreeSolver}
    maps, poses_gt = _dataset(datatype)
    out = dict(datatype=datatype, maps=_run["maps"])
    for ex in _run["exec"]:
        solver = classes[ex](datatype, method=_run["method"],
                             device=_run["device"])
        with _own_scope_off() as fixed:
            scopes = {"default": contextlib.nullcontext, "fixed": fixed}
            _order_run(solver, maps, scopes["default"])       # warm-up
            runs = {"default": [], "fixed": []}
            for rep in range(reps):
                for mode in (("default", "fixed") if rep % 2 == 0
                             else ("fixed", "default")):
                    p, wall, lv = _order_run(solver, maps, scopes[mode])
                    first = runs[mode][0]["poses"] if runs[mode] else p
                    r = dict(poses=p, wall_s=wall, levels_s=lv,
                             ate=_ate(p, poses_gt),
                             max_pose_diff_vs_first=_max_diff(p, first))
                    runs[mode].append(r)
                    lvs = "" if lv is None else f", level walls {lv:.4f} s"
                    print(f"order {datatype} {ex} {mode} pair {rep}: wall "
                          f"{wall:.4f} s{lvs}, ATE {r['ate']:.12f}, max pose "
                          f"diff vs the mode's first run "
                          f"{r['max_pose_diff_vs_first']:.3e}", flush=True)
            prof = ({m: _order_profile(solver, maps, scopes[m])
                     for m in scopes} if _run["profile"] else None)
        rec = {}
        for mode, rs in runs.items():
            rec[mode] = dict(walls_s=[r["wall_s"] for r in rs],
                             levels_s=[r["levels_s"] for r in rs],
                             ates=[r["ate"] for r in rs],
                             max_pose_diff=max(r["max_pose_diff_vs_first"]
                                               for r in rs))
        ratios = [f / d - 1 for d, f in zip(rec["default"]["walls_s"],
                                            rec["fixed"]["walls_s"])]
        rec["pair_ratios"] = ratios
        rec["fixed_vs_default_median"] = statistics.median(ratios)
        print(f"order {datatype} {ex}: {reps} pairs, median wall default "
              f"{statistics.median(rec['default']['walls_s']):.4f} s, fixed "
              f"{statistics.median(rec['fixed']['walls_s']):.4f} s, median "
              f"pair ratio {rec['fixed_vs_default_median']:+.2%} (min "
              f"{min(ratios):+.2%}, max {max(ratios):+.2%}); pose spread "
              f"default {rec['default']['max_pose_diff']:.3e}, fixed "
              f"{rec['fixed']['max_pose_diff']:.3e}", flush=True)
        if prof is not None:
            rec["profile"] = prof
            for mode, ops in prof.items():
                print(f"order {datatype} {ex} profile {mode}: " + "; ".join(
                    f"{k} {v['calls']} calls, device {v['device_ms']:.3f} ms"
                    + (f", cpu {v['cpu_ms']:.3f} ms" if "cpu_ms" in v
                       else "") for k, v in ops.items()
                    if k != "k3_census"), flush=True)
                _print_census(f"order {datatype} {ex} profile {mode}",
                              ops["k3_census"])
        out[ex] = rec
        del solver
    return out


def main(argv=None) -> int:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default="schur,ate")
    ap.add_argument("--paths", default="stereo,mono")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="direct_paths_out")
    ap.add_argument("--maps", type=int, default=2048)
    ap.add_argument("--exec", default="device",
                    help="the executors of the order part, comma-separated "
                         "(device, dense, host)")
    ap.add_argument("--method", default="direct",
                    help="the order part's solve (direct or refine)")
    ap.add_argument("--profile", action="store_true",
                    help="the order part also profiles one run of each mode")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    _run.update(device="cpu" if args.cpu else "cuda", maps=args.maps,
                exec=args.exec.split(","), profile=args.profile,
                method=args.method)
    if not args.cpu and not torch.cuda.is_available():
        print("direct_paths: no CUDA device", file=sys.stderr)
        return 2
    if not args.cpu:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    parts = {"schur": schur_part, "ate": ate_part, "order": order_part}
    for part in args.parts.split(","):
        rep = [parts[part](d, args.reps) for d in args.paths.split(",")]
        with open(os.path.join(args.out, f"direct_paths_{part}.json"),
                  "w") as fh:
            json.dump(rep, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
