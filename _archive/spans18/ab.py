"""This tree's solver against the parent's, in one process on one card:
solves alternate between the two (the order flips every pair) over the
same sets, so drift of the host falls on both alike. Prints each side's
solve walls and host phases, the paired differences, and the cost of the
per-level calls the spans add (a CUDA timing event, the allocator's
count).

    python3 _archive/spans18/ab.py --parent DIR --cell CELL --pairs N
        [--sets K] [--seed S]

DIR: the parent's tree (its `linearsfm_tpu_torch` is imported under the
name `lsfm_parent`, through a symbolic link in a temporary directory).
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def quart(v):
    q = statistics.quantiles(v, n=4)
    return f"median {statistics.median(v):.4f} q1 {q[0]:.4f} q3 {q[2]:.4f}"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--pairs", type=int, default=20)
    ap.add_argument("--sets", type=int, default=6)
    ap.add_argument("--seed", type=int, default=9180000041)
    args = ap.parse_args()
    link = tempfile.mkdtemp()
    os.symlink(os.path.join(os.path.abspath(args.parent),
                            "linearsfm_tpu_torch"),
               os.path.join(link, "lsfm_parent"))
    sys.path.insert(0, ROOT)
    sys.path.insert(0, link)
    import torch
    from benchmark import gen
    import linearsfm_tpu_torch.core.device_tree as C
    import linearsfm_tpu_torch.ops.kernels as CK
    import lsfm_parent.core.device_tree as P
    import lsfm_parent.ops.kernels as PK
    assert P.__file__ != C.__file__
    CK.build()
    PK.build()
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}",
          flush=True)
    n = 2000
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        torch.cuda.memory_allocated(torch.device("cuda", 0))
    ma = (time.perf_counter() - t) / n
    t = time.perf_counter()
    for _ in range(n):
        torch.cuda.Event(enable_timing=True).record()
    ev = (time.perf_counter() - t) / n
    torch.cuda.synchronize()
    print(f"per call: memory_allocated {ma * 1e6:.2f} us, timing event "
          f"record {ev * 1e6:.2f} us", flush=True)

    name = args.cell.split(".")[0]
    with open(os.path.join(ROOT, "benchmark", "configs",
                           f"{name}.json")) as fh:
        cfg = json.load(fh)
    with open(os.path.join(ROOT, "benchmark", "traffic", "covis.json")) as fh:
        mix = json.load(fh)
    sets = [gen.make_set(cfg, mix, args.seed, j)
            for j in range(-1, args.sets)]
    warm, pool = sets[0], sets[1:]
    solvers = {s: m.DeviceTreeSolver(cfg["datatype"], method=cfg["method"],
                                     device="cuda")
               for s, m in (("parent", P), ("change", C))}
    for s in solvers.values():
        s.run(warm)
        torch.cuda.synchronize()
    walls = {"parent": [], "change": []}
    phases = {"parent": {}, "change": {}}
    for i in range(args.pairs):
        maps = pool[i % len(pool)]
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            t = time.perf_counter()
            solvers[side].run(maps)
            torch.cuda.synchronize()
            walls[side].append(time.perf_counter() - t)
            for k, v in solvers[side]._last_timing.items():
                phases[side].setdefault(k, []).append(v)
    for side in ("parent", "change"):
        print(f"{args.cell} {side}: solve walls {quart(walls[side])}",
              flush=True)
        print(f"{args.cell} {side}: phase medians "
              f"{ {k: round(statistics.median(v), 5) for k, v in phases[side].items()} }",
              flush=True)
    d = [c - p for c, p in zip(walls["change"], walls["parent"])]
    print(f"{args.cell}: change - parent per pair (s): {quart(d)}; change "
          f"faster in {sum(x < 0 for x in d)} of {len(d)} pairs; median "
          f"ratio {statistics.median(walls['change']) / statistics.median(walls['parent']):.4f}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
