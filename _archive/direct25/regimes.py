"""Where the RS468 solves' two speeds come from: a window of a cell as
`benchmark/run.py` runs it (the same pool, warm solve and frozen
collector), and for every solve its wall, the solver's `_last_timing`
phases, the caching allocator's counter deltas, this process's CPU
seconds and context switches, the collector's passes, and two fixed probes
of the host's speed run between solves: a pure-Python loop and a CPU torch
sort on the default threads. The solves are then split at the walls'
median into fast and slow halves and each column's mean printed for both.

    python3 _archive/direct25/regimes.py --cell rs468_mono.chain
        [--seed N] [--seconds S] [--json OUT]
"""
import argparse
import gc
import json
import os
import resource
import statistics as st
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

ALLOC = ("num_device_alloc", "num_device_free", "num_alloc_retries",
         "num_sync_all_streams", "num_ooms")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="rs468_mono.chain")
    ap.add_argument("--seed", type=int, default=9250040001)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--json")
    args = ap.parse_args()
    import torch
    from benchmark import run
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.ops import kernels
    if args.threads:
        torch.set_num_threads(args.threads)
    print("torch threads", torch.get_num_threads(), "cores",
          sorted(os.sched_getaffinity(0)), flush=True)
    cuda = args.device == "cuda"
    if cuda:
        torch.empty(1, device="cuda")
        kernels.build()
    bench = run.Bench(args.root)
    w = bench.cell(args.cell)
    cfg, mix = bench.config(w["config"]), bench.mix(w["traffic"])
    pool, warm = run.pool_sets(cfg, mix, args.seed)
    solver = DeviceTreeSolver(cfg["datatype"], method=cfg["method"],
                              device=args.device)
    stats = torch.cuda.memory_stats if cuda else dict
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    solver.run(warm)
    sync()
    gc.collect()
    gc.freeze()
    gcs = []
    gc.callbacks.append(lambda phase, info: gcs.append(
        (phase, info["generation"], time.perf_counter())))
    xs = torch.randint(0, 1 << 30, (200_000,))

    def probes():
        t = time.perf_counter()
        s = 0
        for i in range(100_000):
            s += i * i
        t1 = time.perf_counter()
        torch.sort(xs)
        return t1 - t, time.perf_counter() - t1

    rows, j, t_first = [], 0, time.perf_counter()
    while True:
        py_s, sort_s = probes()
        a = stats()
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        n_gc = len(gcs)
        t = time.perf_counter()
        solver.run(pool[j % len(pool)])
        sync()
        end = time.perf_counter()
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        b = stats()
        g = gcs[n_gc:]
        gc_s = sum(t2 - t1 for (p1, _, t1), (p2, _, t2) in zip(g[::2],
                                                                g[1::2]))
        tm = solver._last_timing
        rows.append(dict(
            wall=end - t, py_probe=py_s, sort_probe=sort_s,
            cpu=(ru1.ru_utime + ru1.ru_stime) - (ru0.ru_utime + ru0.ru_stime),
            user=ru1.ru_utime - ru0.ru_utime, sys=ru1.ru_stime - ru0.ru_stime,
            nvcsw=ru1.ru_nvcsw - ru0.ru_nvcsw,
            nivcsw=ru1.ru_nivcsw - ru0.ru_nivcsw,
            minflt=ru1.ru_minflt - ru0.ru_minflt,
            gc_passes=len(g) // 2, gc_s=gc_s,
            **{k: b.get(k, 0) - a.get(k, 0) for k in ALLOC},
            **{k: v for k, v in tm.items()
               if isinstance(v, (int, float))}))
        j += 1
        if end - t_first >= args.seconds:
            break
    gc.unfreeze()
    walls = [r["wall"] for r in rows]
    med = st.median(walls)
    fast = [r for r in rows if r["wall"] <= med]
    slow = [r for r in rows if r["wall"] > med]
    print(f"{args.cell} seed {args.seed}: {len(rows)} solves, "
          f"{(cfg['maps'] - 1) * len(rows) / (end - t_first):.2f} maps/s, "
          f"wall median {med:.4f}", flush=True)
    print("walls", [round(x, 4) for x in walls])
    print("py_probe ms", [round(1e3 * r["py_probe"], 2) for r in rows])
    print(f"{'column':24s} {'fast mean':>12s} {'slow mean':>12s} "
          f"{'slow/fast':>9s}")
    for k in rows[0]:
        f = st.mean(r[k] for r in fast)
        s = st.mean(r[k] for r in slow)
        print(f"{k:24s} {f:12.6g} {s:12.6g} "
              f"{(s / f if f else float('nan')):9.3f}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(rows, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
