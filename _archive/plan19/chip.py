"""The planner on the card's host, and the solves it plans: for each cell,
a warm solve, then solves of the benchmark generator's sets (fused maps
saved for a bit-for-bit comparison with another tree's, `same.py`), each
solve's host phases and counts, and the planner alone (`_plan` of the
compacted stack, best of --reps) on the same sets. Then the multi-host
path, four hosts simulated in one process (`run_multihost` with a gather
of every host's `local_stacked`), on a loop of --multihost stereo maps:
its root saved beside the cells' maps, and `common_root_caps` alone,
best of --reps.

    python3 _archive/plan19/chip.py --root TREE --maps-out DIR
        [--seed N] [--reps R] [--multihost N] [--device cpu --maps N]

--root: the tree whose `linearsfm_tpu_torch` runs (the generator and the
configurations come from the same tree). --device cpu --maps N: a
rehearsal on the CPU with N maps a set.
"""

import argparse
import json
import os
import sys
import time

CELLS = (("rs468_mono", "rs468_mono.covis", 3),
         ("nc3500_stereo", "nc3500_stereo.covis", 2))
KEYS = ("compact", "plan", "plan_tree", "upload", "levels", "pcg_sweeps",
        "k1_launches", "k2_launches", "k3_launches")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--maps-out", required=True)
    ap.add_argument("--seed", type=int, default=9190000001)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--maps", type=int, default=0)
    ap.add_argument("--multihost", type=int, default=2048)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.makedirs(args.maps_out, exist_ok=True)
    import torch
    from benchmark import gen
    from linearsfm_tpu_torch import types
    from linearsfm_tpu_torch.core import compact
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.ops import kernels
    cuda = args.device == "cuda"
    print(f"tree {root}; torch {torch.__version__}, CUDA {torch.version.cuda}"
          f", {torch.cuda.get_device_name(0) if cuda else 'CPU'}", flush=True)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        kernels.build()
    with open(os.path.join(root, "benchmark/traffic/covis.json")) as f:
        mix = json.load(f)
    for cfg_name, cell, sets in CELLS:
        with open(os.path.join(root, f"benchmark/configs/{cfg_name}.json")) \
                as f:
            cfg = json.load(f)
        cfg["maps"] = args.maps or cfg["maps"]
        solver = DeviceTreeSolver(cfg["datatype"], method=cfg["method"],
                                  device=args.device)
        solver.run(gen.make_set(cfg, mix, args.seed, -1))
        sync()
        for j in range(sets):
            maps = gen.make_set(cfg, mix, args.seed, j)
            t = time.perf_counter()
            y = solver.run(maps)
            sync()
            wall = time.perf_counter() - t
            torch.save({f: getattr(y, f).cpu() for f in types.MAP_FIELDS},
                       os.path.join(args.maps_out, f"{cell}.{j}.pt"))
            del y
            lt = solver._last_timing
            best = {"compact": float("inf"), "plan": float("inf")}
            for _ in range(args.reps):
                t0 = time.perf_counter()
                st = compact.compact_stack(maps, solver.bucket,
                                           solver.u_bucket)
                t1 = time.perf_counter()
                solver._plan(st)
                t2 = time.perf_counter()
                best["compact"] = min(best["compact"], t1 - t0)
                best["plan"] = min(best["plan"], t2 - t1)
            print(json.dumps(dict(
                cell=cell, set=j, solve_s=round(wall, 4),
                timing={k: (round(lt[k], 6) if isinstance(lt[k], float)
                            else lt[k]) for k in KEYS if k in lt},
                alone_best_s={k: round(v, 5) for k, v in best.items()})),
                flush=True)
        del solver
        if cuda:
            torch.cuda.empty_cache()
    multihost(args, types, sync)
    return 0


def multihost(args, types, sync) -> None:
    import torch
    from synth import generate
    from linearsfm_tpu_torch.parallel import multihost as mh
    maps, _, _ = generate.make_dataset(args.multihost, "stereo", noise=0.005,
                                       seed=7, covis_radius=6.0,
                                       covis_max=6)
    kw = dict(method="direct", device=args.device)
    best = float("inf")
    for _ in range(args.reps):
        t = time.perf_counter()
        caps = mh.common_root_caps(maps, "stereo", 4)
        best = min(best, time.perf_counter() - t)
    t = time.perf_counter()
    stacks = [mh.local_stacked(maps, "stereo", 4, h, kw) for h in range(4)]
    y = mh.run_multihost(maps, "stereo", n_hosts=4, host_id=0,
                         gather=lambda _mine: stacks, solver_kw=kw)
    sync()
    wall = time.perf_counter() - t
    torch.save({f: getattr(y, f).cpu() for f in types.MAP_FIELDS},
               os.path.join(args.maps_out, "multihost.pt"))
    print(json.dumps(dict(multihost=args.multihost, hosts=4,
                          common_root_caps=list(caps),
                          common_root_caps_best_s=round(best, 5),
                          solve_s=round(wall, 4))), flush=True)


if __name__ == "__main__":
    sys.exit(main())
