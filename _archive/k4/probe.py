"""Solves of the benchmark's cells through `DeviceTreeSolver.run` on the
card (copied from _archive/mono20/probe.py; --hold holds every K4 call of
the warm solve in situ with chip_smoke's `_K4InSitu` and times its root
launch; set 0 is solved twice and the two fused maps compared bit for
bit), with the level rows a solve leaves: for each cell, a warm solve, then
--sets sets of the cell's generator (fused maps saved under --maps-out for
a bit-for-bit comparison with another tree's), each solve's wall, host
phases and counts, one row per level (lanes, joined poses, device wall,
live bytes, PCG sweeps and escalations, the largest residual, non-finite
residuals), the peak bytes and whether every state is finite.

    python3 _archive/mono20/probe.py --root TREE --maps-out DIR
        --cells CELL:SETS,... [--seed N] [--device cpu --maps N]
"""

import argparse
import json
import math
import os
import sys
import time

KEYS = ("compact", "plan", "upload", "levels", "join", "mono_gauge",
        "transform", "sync", "regauge_compact", "pcg_sweeps",
        "pcg_escalations", "syncs", "k1_launches", "k2_launches",
        "k3_launches", "k4_launches")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--maps-out", required=True)
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seed", type=int, default=9200000001)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--maps", type=int, default=0)
    ap.add_argument("--hold", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.makedirs(args.maps_out, exist_ok=True)
    import numpy as np
    import torch
    from benchmark import compare, gen, run
    from linearsfm_tpu_torch import types
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.utils.metrics import LevelMetrics
    cuda = args.device == "cuda"
    print(f"tree {root}; torch {torch.__version__}, CUDA {torch.version.cuda}"
          f", {torch.cuda.get_device_name(0) if cuda else 'CPU'}", flush=True)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        kernels.build()
    bench = run.Bench(root)
    for item in args.cells.split(","):
        cell, sets = item.split(":")
        w = bench.cell(cell)
        cfg, mix = bench.config(w["config"]), bench.mix(w["traffic"])
        cfg["maps"] = args.maps or cfg["maps"]
        solver = DeviceTreeSolver(cfg["datatype"], method=cfg["method"],
                                  device=args.device)
        t = time.perf_counter()
        if args.hold:
            import chip_smoke
            with chip_smoke._K4InSitu() as k4:
                solver.run(gen.make_set(cfg, mix, args.seed, -1))
            k4.report(f"{cell} warm solve")
            k4.time_root(f"{cell} warm solve")
            del k4
        else:
            solver.run(gen.make_set(cfg, mix, args.seed, -1))
        sync()
        print(f"{cell}: warm solve {time.perf_counter() - t:.3f} s",
              flush=True)
        for j in list(range(int(sets))) + [0]:
            maps = gen.make_set(cfg, mix, args.seed, j)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            m = LevelMetrics()
            t = time.perf_counter()
            y = solver.run(maps, metrics=m, time_levels=True)
            sync()
            wall = time.perf_counter() - t
            fin = bool(compare.finite_flag(y))
            got = {f: getattr(y, f).cpu() for f in types.MAP_FIELDS}
            path = os.path.join(args.maps_out, f"{cell}.{j}.pt")
            if os.path.exists(path):
                first = torch.load(path)
                print(f"{cell} set {j} again: torch.equal on every field "
                      f"{all(torch.equal(got[f], first[f]) for f in got)}",
                      flush=True)
            else:
                torch.save(got, path)
            del y
            lt = solver._last_timing
            spans = solver.last_spans
            rows = []
            for r in m.records:
                lv = r["level"]
                res = solver.last_residuals.get(lv)
                sw = esc = 0
                lvl = [i for i, sp in enumerate(spans)
                       if sp["name"] == "level" and sp["attrs"]["level"] == lv]
                if lvl:
                    from linearsfm_tpu_torch.utils.metrics import subtree
                    under = subtree(spans, lvl[0])
                    sw = sum(spans[i]["attrs"].get("pcg_sweeps", 0)
                             for i in under)
                    esc = sum(spans[i]["attrs"].get("pcg_escalations", 0)
                              for i in under)
                    mem = spans[lvl[0]]["attrs"]["memory_allocated"]
                else:
                    mem = None
                rmax = None
                nonfin = 0
                if res is not None and res.size:
                    nonfin = int((~np.isfinite(res)).sum())
                    with np.errstate(invalid="ignore"):
                        rmax = float(np.max(res))
                rows.append(dict(level=lv, joins=r["n_joins"],
                                 join_m=r["join_m"],
                                 device_ms=round(r.get("exec_wall", 0) * 1e3,
                                                 3),
                                 live_mib=None if mem is None else
                                 round(mem / 2**20, 1),
                                 sweeps=sw, esc=esc, res_max=rmax,
                                 res_nonfinite=nonfin))
            rec = dict(cell=cell, set=j, solve_s=round(wall, 4), finite=fin,
                       peak_bytes=int(torch.cuda.max_memory_allocated())
                       if cuda else 0,
                       timing={k: round(lt[k], 6) if isinstance(lt.get(k),
                                                                 float)
                               else lt.get(k) for k in KEYS},
                       levels=rows)
            print(json.dumps(rec), flush=True)
        del solver
        if cuda:
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
