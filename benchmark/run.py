"""The benchmark of linearsfm_tpu_torch, the PyTorch and CUDA port.

    python3 benchmark/run.py --workload <config>.<mix> --seed N --seconds S
        --trace 0|1

One cell is one deployment (`configs/<config>.json`) under one traffic mix
(`traffic/<mix>.json`), named in BENCHMARK.json. The loop is closed, with
one caller, as a user of the solver works: set-up builds the card's
kernels, generates the cell's pool of distinct local-map sets from the
seed (`gen.py`), builds the solver once and solves one more set outside
the pool; then the window runs `solver.run(maps)` and a synchronise back to
back, each on the next set of the pool, and ends with the first solve that
finishes after --seconds. With --trace 0 the last stdout line holds the
cell's end-to-end metrics; with --trace 1 its per-layer metrics, each read
by `metrics/<metric>.py` from the solves' host timings and from one
torch.profiler session per traced solve (`trace.py`).

After the window a sample of the window's solves, drawn from the seed, is
solved again by the plain reference (`reference.py`, float64) and compared
(`compare.py`) against the limits of the configuration's file; that decides
`correct`. A run needs a CUDA card and never falls back to the CPU; it
imports neither JAX nor the JAX package (checked at its end).
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from concurrent.futures import ProcessPoolExecutor  # noqa: E402
from multiprocessing import get_context  # noqa: E402

# one process with one math-library thread: the host's cores are shared,
# and idle pool threads that spin between small operations make the solver's
# host work slower and less steady (set before numpy and torch load)
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# light at the top: set-up's worker processes load this module again
from benchmark import gen  # noqa: E402

# the reference solves sets of this many maps at least, one set at least
CHECK_MAPS = 1000
# traced solves per traced run, and profiler sessions tried for them
TRACE_SOLVES, TRACE_TRIES = 1, 3
FORBIDDEN = ("jax", "jaxlib", "flax", "linearsfm_tpu")
# set-up generates the pool in this many worker processes, which end with
# it (most of a set's making is interpreter work, one map at a time)
GEN_PROCS = 6


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def process_age() -> float:
    """Seconds since this process started (Linux /proc), else since this
    module was loaded."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def host_sample() -> dict:
    """The host's state now (Linux /proc; what cannot be read is left
    out): this process's CPU seconds and involuntary context switches, the
    machine's CPU ticks (all, idle + iowait, steal), the 1-minute load, the
    mean clock of the cores in MHz, and the cores this thread may run on."""
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = dict(cpu_s=ru.ru_utime + ru.ru_stime, nivcsw=ru.ru_nivcsw,
               cores=sorted(os.sched_getaffinity(0)))
    try:
        with open("/proc/stat") as fh:
            t = [int(x) for x in fh.readline().split()[1:]]
        out.update(ticks=sum(t[:8]), idle=t[3] + t[4], steal=t[7])
        with open("/proc/loadavg") as fh:
            out["load1"] = float(fh.read().split()[0])
        with open("/proc/cpuinfo") as fh:
            mhz = [float(ln.split(":")[1]) for ln in fh
                   if ln.startswith("cpu MHz")]
        out["mhz"] = sum(mhz) / len(mhz)
    except (OSError, ValueError, IndexError, ZeroDivisionError):
        pass
    return out


def host_line(a: dict, b: dict, wall: float) -> str:
    """What the host did between samples a and b, `wall` seconds apart."""
    d = {k: b[k] - a[k] for k in a if k in b and k != "cores"}
    parts = [f"this process on the CPU {d['cpu_s']:.2f} s of {wall:.2f} s",
             f"involuntary switches {d['nivcsw']}"]
    if d.get("ticks", 0) > 0:
        parts += [f"machine busy {100 * (1 - d['idle'] / d['ticks']):.1f}%",
                  f"steal {100 * d['steal'] / d['ticks']:.2f}%"]
    for k in ("load1", "mhz"):
        if k in a and k in b:
            parts.append(f"{k} {a[k]:g} -> {b[k]:g}")
    parts.append(f"cores {b['cores']}")
    return "host over the window: " + ", ".join(parts)


# --- the files that name a cell ---------------------------------------------

class Bench:
    """BENCHMARK.json and the files it names, under `root`."""

    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.spec = json.load(fh)
        self.dir = os.path.join(root, self.spec["paths"][0])

    def _json(self, *parts):
        with open(os.path.join(self.dir, *parts)) as fh:
            return json.load(fh)

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", f"{name}.json")

    def mix(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metrics the cell reports: its end-to-end ones, or its
        per-layer ones with --trace 1."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """`read(run) -> float | None` of metrics/<metric>.py."""
        path = os.path.join(self.dir, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def pool_sets(cfg: dict, mix: dict, seed: int):
    """(the window's pool of distinct sets, the warm-up set j = -1), made
    in GEN_PROCS worker processes (none: in this one); each set depends on
    (seed, j) alone, so they come out the same either way."""
    size = max(2, math.ceil(mix["pool_maps"] / cfg["maps"]))
    js = range(-1, size)
    if GEN_PROCS > 1:
        with ProcessPoolExecutor(GEN_PROCS, mp_context=get_context(
                "spawn")) as ex:
            sets = list(ex.map(gen.make_set, *zip(*[(cfg, mix, seed, j)
                                                 for j in js]),
                               chunksize=max(1, len(js) // (4 * GEN_PROCS))))
    else:
        sets = [gen.make_set(cfg, mix, seed, j) for j in js]
    return sets[1:], sets[0]


# --- the window ---------------------------------------------------------------

def nearest_rank(values, q: float) -> float:
    """The nearest-rank q-quantile (0 < q <= 1) of values."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def end_to_end(solves: list[dict], maps: int) -> dict:
    """maps_joined_per_s: (maps - 1) per solve over the wall from the first
    solve's call to the last solve's synchronise; solve_s_p95: the
    nearest-rank 95th percentile of the solve walls."""
    span = solves[-1]["end"] - solves[0]["start"]
    return dict(maps_joined_per_s=(maps - 1) * len(solves) / span,
                solve_s_p95=nearest_rank([s["wall"] for s in solves], 0.95))


def run_window(solver, pool, seconds, sync, keep, rng, recorder=None):
    """Solves back to back, each on the next set of the pool (from the
    first again once it is used up), until the first solve that ends
    `seconds` after the first call. Of the solves that return, `keep`
    outputs drawn by `rng` are kept (a reservoir: each is equally likely,
    and no more are held), and of each a flag, read after the window,
    whether its states are finite. With a recorder, up to TRACE_SOLVES
    solves run each in its own profiler session (up to TRACE_TRIES
    sessions, a session that lost device records dropped). Returns (solve
    records, kept outputs by solve index, traced sessions)."""
    from benchmark import compare, trace
    solves, kept, sessions, tries, seen = [], {}, [], 0, 0
    t_first = None
    j = 0
    while True:
        maps = pool[j % len(pool)]

        def solve():
            out = solver.run(maps)
            sync()
            return out
        traced = (recorder is not None and len(sessions) < TRACE_SOLVES
                  and tries < TRACE_TRIES)
        start = time.perf_counter()
        t_first = start if t_first is None else t_first
        ok, events, flag = True, None, None
        try:
            if traced:
                tries += 1
                k3_0 = recorder.kernels.launches["seg_sum_fixed"]
                out, events, ts = trace.profile_solve(recorder, solve)
            else:
                out = solve()
        except Exception as exc:  # a failed solve counts, the window goes on
            log(f"solve {j} raised {type(exc).__name__}: {exc}")
            out, ok = None, False
        end = time.perf_counter()
        if out is not None:
            flag = compare.finite_flag(out)
            seen += 1
            if len(kept) < keep:
                kept[j] = out
            else:
                r = int(rng.integers(seen))
                if r < keep:
                    del kept[sorted(kept)[r]]
                    kept[j] = out
            del out
        if events is not None:
            nbytes = recorder.take_bytes()
            k3_n = recorder.kernels.launches["seg_sum_fixed"] - k3_0
            try:
                trace.require_records(events, f"traced solve {j}", ts)
                red = trace.reduce_session(events, ts)
                if red["k1_launches"] != len(nbytes[0]):
                    raise trace.LostRecords(
                        f"traced solve {j}: {red['k1_launches']} K1 kernels "
                        f"in the trace, {len(nbytes[0])} launches recorded")
                if k3_n != len(nbytes[1]):
                    # a K3 call that bypassed the recorder's wrapper
                    raise trace.LostRecords(
                        f"traced solve {j}: {k3_n} K3 launches counted by "
                        f"the program, {len(nbytes[1])} recorded")
                sessions.append(dict(red, bytes=nbytes, solve=j))
            except trace.LostRecords as exc:
                log(f"{exc}; profiling the next solve instead")
                traced = False
        solves.append(dict(index=j, start=start, end=end, wall=end - start,
                           ok=ok, flag=flag, traced=traced,
                           repeated=j >= len(pool),
                           timing=dict(getattr(solver, "_last_timing", {}))))
        j += 1
        if end - t_first >= seconds:
            return solves, kept, sessions


class Run:
    """What a per-layer reader reads: the cell's entries, the window's solve
    records (`wall`, `traced`, `timing`: the solver's host phases, seconds)
    and the traced sessions (`wall_s`, `busy_s`, `kernels`, `k1_s`,
    `k3_s`, `gaps`, `bytes`: the K1 and K3 launches' least bytes)."""

    def __init__(self, cell, config, mix, solves, sessions):
        self.cell, self.config, self.mix = cell, config, mix
        self.solves, self.sessions = solves, sessions

    def host_solves(self) -> list[dict]:
        """The window's solves that ran outside the profiler (all of them
        if none did)."""
        plain = [s for s in self.solves if not s["traced"] and s["ok"]]
        return plain or [s for s in self.solves if s["ok"]]


def breakdown(sessions: list[dict]) -> dict:
    ops, gaps = {}, []
    for s in sessions:
        for k, v in s["kernels"].items():
            ops[k] = ops.get(k, 0.0) + v
        gaps += s["gaps"]
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ops=[[k, v] for k, v in top],
                idle_gaps=[[k, v] for k, v in
                           sorted(gaps, key=lambda g: -g[1])[:10]])


# --- the check --------------------------------------------------------------

def check(cfg: dict, sets: list, outs: list, device: str) -> dict:
    """The largest of each compared number over the sampled solves: the
    program's fused maps against the float64 reference's of the same
    sets."""
    from benchmark import compare, reference
    worst = {}
    for maps, out in zip(sets, outs):
        want = reference.solve_tree(maps, cfg["datatype"], np.float64,
                                    device=device)
        for k, v in compare.gaps(out, want).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name starts with the JAX package's)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             trace_on: bool, device: str = "cuda", solver_factory=None):
    """One run of a cell on `device`; returns (result dict, the lines of
    compared numbers). The result's metrics are the cell's end-to-end ones,
    or with trace_on its per-layer ones. `solver_factory(datatype,
    method, device)` replaces the port's solver (the tests' faults)."""
    import torch
    from benchmark import compare
    from linearsfm_tpu_torch.ops import kernels
    cell = bench.cell(workload)
    cfg, mix = bench.config(cell["config"]), bench.mix(cell["traffic"])
    if cfg["executor"] != "device":
        raise ValueError(f"{cell['config']}: executor {cfg['executor']!r}; "
                         f"the harness runs the device executor only")
    age0, p0 = process_age(), time.perf_counter()
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)
        kernels.build()
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    t_cuda = time.perf_counter()
    pool, warm = pool_sets(cfg, mix, seed)
    t_pool = time.perf_counter()
    if solver_factory is None:
        from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
        solver_factory = DeviceTreeSolver
    solver = solver_factory(cfg["datatype"], method=cfg["method"],
                            device=device)
    solver.run(warm)
    sync()
    recorder = None
    if trace_on:
        from benchmark import trace
        recorder = trace.Recorder(solver)
        trace.profile_solve(recorder, lambda: sync())   # the profiler's own
        recorder.take_bytes()                            # first start
    t_warm = time.perf_counter()
    # the pool and the rest of set-up live on: the collector need not
    # walk them again in the window
    gc.collect()
    gc.freeze()
    setup_s = age0 + time.perf_counter() - p0
    log(f"set-up {setup_s:.1f} s: start to CUDA and kernels "
        f"{t_cuda - p0 + age0:.1f} s, pool {t_pool - t_cuda:.1f} s, solver "
        f"and warm solve {t_warm - t_pool:.1f} s")
    # the check's sample: solves drawn from the seed
    k = max(1, CHECK_MAPS // cfg["maps"])
    rng = np.random.default_rng(gen.set_seed(seed, -2))
    h0, t0 = host_sample(), time.perf_counter()
    solves, kept, sessions = run_window(solver, pool, seconds, sync, k, rng,
                                        recorder)
    log(host_line(h0, host_sample(), time.perf_counter() - t0))
    gc.unfreeze()
    for s in solves:
        flag = s.pop("flag")
        if flag is not None:
            s["ok"] = s["ok"] and bool(flag)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    n_done = len(solves)
    repeated = any(s["repeated"] for s in solves)
    print(f"solves {n_done} repeated {str(repeated).lower()} pool "
          f"{len(pool)} sets of {cfg['maps']} maps", flush=True)
    log(f"solve walls (s): {[round(s['wall'], 4) for s in solves]}")
    failed = sum(1 for s in solves if not s["ok"])
    # the program's state is freed before the reference runs
    picked = sorted(kept)
    got = [compare.program_map(kept[i]) for i in picked]
    sets = [pool[i % len(pool)] for i in picked]
    del kept, solver
    if recorder is not None:
        recorder.solver = None
    if cuda:
        torch.cuda.empty_cache()
    limits = cfg["limits"]
    t = time.perf_counter()
    worst = check(cfg, sets, got, device) if got else {}
    log(f"check: {len(got)} solve(s) of {cfg['maps']} maps by the reference "
        f"in {time.perf_counter() - t:.1f} s")
    # a number that could not be read (no sample, a non-finite gap) is
    # null, and fails
    checks = {}
    for k, v in limits.items():
        x = worst.get(k)
        checks[k] = {"value": x if x is not None and math.isfinite(x)
                     else None, "limit": v}
    correct = (bool(got) and failed == 0
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    if trace_on:
        run = Run(cell, cfg, mix, solves, sessions)
        metrics = {}
        for m in bench.metrics(workload, True):
            v = bench.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = end_to_end(solves, cfg["maps"])
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench.metrics(workload, False)}
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(device) if cuda else "cpu",
               count=1, memory_peak_bytes=int(peak))
    result = dict(correct=correct, attempted=n_done, failed=failed,
                  metrics=metrics, device=dev)
    if trace_on and sessions:
        dev["busy_s"] = sum(s["busy_s"] for s in sessions)
        dev["window_s"] = sum(s["wall_s"] for s in sessions)
        result["breakdown"] = breakdown(sessions)
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    bench = Bench()
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {card()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    result, lines = run_cell(bench, args.workload, args.seed, args.seconds,
                             bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"JAX or the JAX package was loaded: {bad}")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
