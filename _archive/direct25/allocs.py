"""What the caching allocator does in NC3500 direct solves on the card:
after a warm solve, for each of --sets sets of the cell, the solve's wall,
peak bytes and the deltas of the allocator's counters (device mallocs and
frees, retries after a failed malloc, which free the cache and
synchronise the device), and each level's device wall.

    python3 _archive/direct25/allocs.py [--cell CELL] [--sets N]
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

KEYS = ("num_device_alloc", "num_device_free", "num_alloc_retries",
        "num_sync_all_streams", "num_ooms")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="nc3500_stereo_direct.covis")
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seed", type=int, default=9250034001)
    args = ap.parse_args()
    import torch
    from benchmark import gen, run
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.ops import kernels
    kernels.build()
    bench = run.Bench(ROOT)
    w = bench.cell(args.cell)
    cfg, mix = bench.config(w["config"]), bench.mix(w["traffic"])
    solver = DeviceTreeSolver(cfg["datatype"], method=cfg["method"])
    solver.run(gen.make_set(cfg, mix, args.seed, -1))
    torch.cuda.synchronize()
    for j in range(args.sets):
        maps = gen.make_set(cfg, mix, args.seed, j)
        torch.cuda.reset_peak_memory_stats()
        a = torch.cuda.memory_stats()
        t = time.perf_counter()
        solver.run(maps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        b = torch.cuda.memory_stats()
        levels = [round(sp["attrs"]["device_wall"], 4)
                  for sp in solver.last_spans if sp["name"] == "level"]
        print(f"set {j}: wall {wall:.4f} s, peak "
              f"{torch.cuda.max_memory_allocated()}, "
              + ", ".join(f"{k} +{b.get(k, 0) - a.get(k, 0)}" for k in KEYS)
              + f", reserved {b['reserved_bytes.all.current']}; level "
              f"device walls {levels}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
