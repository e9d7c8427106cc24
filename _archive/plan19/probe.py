"""The exact tree planner on the CPU: the JAX package's set planner (node
by node in Python sets) against the port's array planner (one batch a
level), on the benchmark generator's sets of both configurations. Prints
each set's seconds, split into the shadows (`sym_of_stacked`) and the
tree (`plan_tree_exact`), best of --reps, and asserts that the two plans
are equal in every field.

    JAX_PLATFORMS=cpu python3 _archive/plan19/probe.py [--sets 2]
        [--seed 2147483651] [--reps 3]
"""

import argparse
import dataclasses
import json
import os
import platform
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from benchmark import gen  # noqa: E402
from linearsfm_tpu.core import plan as jplan  # noqa: E402
from linearsfm_tpu_torch.core import compact  # noqa: E402
from linearsfm_tpu_torch.core import plan as tplan  # noqa: E402

CONFIGS = ("nc3500_stereo", "rs468_mono")


def cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def timed(mod, st, datatype, reps):
    """(best shadow s, best tree s, plan) of one planner on a stack."""
    sym = tree = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        s = mod.sym_of_stacked(st)
        t1 = time.perf_counter()
        tp = mod.plan_tree_exact(s, datatype, 16, 64)
        t2 = time.perf_counter()
        sym, tree = min(sym, t1 - t0), min(tree, t2 - t1)
    return sym, tree, tp


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seed", type=int, default=2147483651)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    print(f"CPU: {cpu_name()}, {os.cpu_count()} cores, "
          f"python {platform.python_version()}", flush=True)
    with open(os.path.join(ROOT, "benchmark/traffic/covis.json")) as f:
        mix = json.load(f)
    for name in CONFIGS:
        with open(os.path.join(ROOT, f"benchmark/configs/{name}.json")) as f:
            cfg = json.load(f)
        for j in range(args.sets):
            st = compact.compact_stack(gen.make_set(cfg, mix, args.seed, j),
                                       16, 64)
            js, jt, want = timed(jplan, st, cfg["datatype"], args.reps)
            ts, tt, got = timed(tplan, st, cfg["datatype"], args.reps)
            assert len(got.levels) == len(want.levels)
            assert all(dataclasses.astuple(a) == dataclasses.astuple(b)
                       for a, b in zip(got.levels, want.levels))
            assert (got.root_regauge, got.root_caps) == (
                want.root_regauge, want.root_caps)
            print(json.dumps(dict(
                config=name, set=j, maps=cfg["maps"],
                sets_planner=dict(shadows_s=round(js, 4),
                                  tree_s=round(jt, 4),
                                  total_s=round(js + jt, 4)),
                array_planner=dict(shadows_s=round(ts, 4),
                                   tree_s=round(tt, 4),
                                   total_s=round(ts + tt, 4)),
                speedup=round((js + jt) / (ts + tt), 1), equal=True)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
