"""The plan cache of `ops/segment.fixed_plan` on and off.

`fixed_plan` kept the plans of the last 16 index tensors summed inside
`deterministic()`. This measurement found no gain and the cache was
removed, so the script runs only on a tree that still has it.

Direct mono in the fixed order on the device executor
(`DeviceTreeSolver("mono", method="direct")`, chip_smoke.py's 2,048-map
covis set) and on the host executor (`TreeSolver("mono",
method="direct")`, phase 12e's 512-map set): a warm-up run of each mode,
then --reps pairs, the cache on first in the even pairs and off first in
the odd ones. Off, every sum sorts its index list afresh
(`kernels.seg_plan`). Prints each run's wall (synchronised), K3 launches
and plans sorted, the median, min and max of the pairs' off / on wall
ratios, and whether every run's poses equal the first run's (the plan
decides no order, so they must). Run from the repo root on one GPU:

    python3 _archive/k3_plan_ab.py [--reps 10] [--out FILE.json]
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

from synth import generate as gen  # noqa: E402
from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver  # noqa
from linearsfm_tpu_torch.core.tree import TreeSolver  # noqa: E402
from linearsfm_tpu_torch.ops import kernels, segment  # noqa: E402

K3 = "seg_sum_fixed"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    cached = segment.fixed_plan
    sort = kernels.seg_plan
    sorts = [0]

    def counted(idx, num):
        sorts[0] += 1
        return sort(idx, num)

    def fresh(idx, num):
        return kernels.seg_plan(idx, num)
    kernels.seg_plan = counted

    def run(solver, maps, mode):
        segment.fixed_plan = cached if mode == "on" else fresh
        sorts[0] = 0
        kernels.launches[K3] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = solver.run(maps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        segment.fixed_plan = cached
        p = out.poses
        p = p.clone() if torch.is_tensor(p) else torch.as_tensor(np.array(p))
        return wall, kernels.launches[K3], sorts[0], p

    record = {}
    for name, n, make in (
            ("device mono 2048", 2048,
             lambda: DeviceTreeSolver("mono", method="direct")),
            ("host mono 512", 512,
             lambda: TreeSolver("mono", method="direct"))):
        maps, _, _ = gen.make_dataset(n, "mono", noise=0.005, seed=7,
                                      covis_radius=6.0, covis_max=6)
        solver = make()
        first = run(solver, maps, "on")[3]
        run(solver, maps, "off")
        walls = {"on": [], "off": []}
        ratios, same = [], True
        for k in range(args.reps):
            pair = {}
            for mode in (("on", "off") if k % 2 == 0 else ("off", "on")):
                wall, launches, nsort, poses = run(solver, maps, mode)
                same &= torch.equal(poses, first)
                pair[mode] = wall
                walls[mode].append(wall)
                print(f"{name} pair {k} cache {mode}: wall {wall:.4f} s, K3 "
                      f"{launches} launches, {nsort} plans sorted",
                      flush=True)
            ratios.append(pair["off"] / pair["on"] - 1)
        rec = dict(walls=walls, ratios=ratios, poses_equal=same,
                   median=statistics.median(ratios),
                   median_on=statistics.median(walls["on"]),
                   median_off=statistics.median(walls["off"]))
        record[name] = rec
        print(f"{name}: cache off vs on, median pair ratio "
              f"{rec['median']:+.2%} (min {min(ratios):+.2%}, max "
              f"{max(ratios):+.2%}; median walls {rec['median_on']:.4f} -> "
              f"{rec['median_off']:.4f} s); every run's poses equal the "
              f"first's: {same}", flush=True)
        del maps, solver, first
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0 if all(r["poses_equal"] for r in record.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
