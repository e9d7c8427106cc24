"""Per-level wall-clock profile of the host-driven tree solve.

    python3 -m linearsfm_tpu_torch.tools.profile_tree [NUM_MAPS]
        [stereo|mono] [method] [--cpu]

Counterpart of `tools/profile_tree.py` (defaults 512 maps, stereo, direct;
the data is `synth.generate.make_dataset(NUM, TYPE, noise=0.005,
seed=7)`). Runs the host executor (`core/tree.TreeSolver`) level by level
as its `run` does — the level's joins (`_run_level_batched`, or
`merge_pair` for a single pair), then each output map's re-gauge
(`regauge_to_final`) and compaction (`core/compact.compact`) — cold, then
warm. Each level prints one line: pair count, the join wall, the
re-gauge + compaction wall, the solver's `_last_timing` (prep / device /
get of the last batched join) and `compact.stats` of the level's first
map; the end prints `WARM TOTAL`. Runs on the card unless --cpu is given
(no CUDA and no --cpu: exit 1).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def run_once(solver, lms, t0: float, label: str):
    """One host-executor tree over `lms`, a line per level; returns the
    final map (host form)."""
    from linearsfm_tpu_torch.core import compact as compact_mod
    maps = [compact_mod.compact(lm, solver.bucket, solver.u_bucket)
            for lm in lms]
    count = len(maps)
    level = 0
    while count > 1:
        lt0 = time.perf_counter()
        nxt = (count + 1) // 2
        npair = count // 2
        if npair > 1:
            merged = solver._run_level_batched(
                [maps[2 * i] for i in range(npair)],
                [maps[2 * i + 1] for i in range(npair)])
        else:
            merged = [solver.merge_pair(maps[0], maps[1])]
        jt = time.perf_counter()
        out = []
        for i in range(nxt):
            g = merged[i] if i < npair else maps[2 * i]
            if (i + 1) % 2 == 0:
                g = solver.regauge_to_final(g)
            out.append(compact_mod.compact(g, solver.bucket, solver.u_bucket))
        maps = out
        count = nxt
        level += 1
        st = compact_mod.stats(maps[0])
        print(f"[{time.perf_counter() - t0:8.2f}s] {label} L{level:2d} "
              f"npair={npair:4d} join={jt - lt0:8.4f}s "
              f"regauge+compact={time.perf_counter() - jt:8.4f}s "
              f"timing={solver._last_timing} map0={st}", flush=True)
    g = solver.regauge_to_final(maps[0])
    print(f"[{time.perf_counter() - t0:8.2f}s] {label} done", flush=True)
    return g


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("num", nargs="?", type=int, default=512)
    ap.add_argument("type", nargs="?", choices=("stereo", "mono"),
                    default="stereo")
    ap.add_argument("method", nargs="?", choices=("direct", "refine"),
                    default="direct")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from linearsfm_tpu_torch.tools.common import open_device
    device = open_device(args.cpu, "profile_tree")
    if device is None:
        return 1
    from synth import generate as gen
    from linearsfm_tpu_torch.core.tree import TreeSolver

    t0 = time.perf_counter()
    maps, _, _ = gen.make_dataset(args.num, args.type, noise=0.005, seed=7)
    print(f"[{time.perf_counter() - t0:8.2f}s] dataset ready ({args.num} "
          f"{args.type} maps)", flush=True)
    solver = TreeSolver(args.type, method=args.method, device=device)
    run_once(solver, maps, t0, "cold")
    w0 = time.perf_counter()
    run_once(solver, maps, t0, "warm")
    w = time.perf_counter() - w0
    print(f"WARM TOTAL: {w:.4f}s ({(args.num - 1) / w:.1f} maps/s)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
