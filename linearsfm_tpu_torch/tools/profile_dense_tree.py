"""Wall-clock profile of the dense planned executor (core/dense_tree.py).

    python3 -m linearsfm_tpu_torch.tools.profile_dense_tree [--maps 2048]
        [--type stereo|mono] [--method refine|direct] [--cpu]

Counterpart of `tools/profile_dense_tree.py`. The data is the bench's
covis set (seed 7, noise 0.005, covis radius 6, at most 6 co-visible
features per map). Prints the card's name and power limit, then a cold, a
warm and a second warm run of `DenseTreeSolver` (wall, maps joined per
second, the solver's host phases `_last_timing`), the second warm run's
per-level device walls (CUDA events; the host clock with --cpu) beside each
level's caps and precision, its kernel launches and the peak device memory.
--cpu runs it on the CPU (use a small --maps there).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--maps", type=int, default=2048)
    ap.add_argument("--type", choices=("stereo", "mono"), default="stereo")
    ap.add_argument("--method", choices=("refine", "direct"), default="refine")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from synth import generate as gen
    from linearsfm_tpu_torch.core.dense_tree import DenseTreeSolver
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.tools.common import open_device
    from linearsfm_tpu_torch.utils.metrics import LevelMetrics

    device = open_device(args.cpu, "profile_dense_tree")
    if device is None:
        return 1

    t0 = time.perf_counter()
    maps, _, _ = gen.make_dataset(args.maps, args.type, noise=0.005, seed=7,
                                  covis_radius=6.0, covis_max=6)
    print(f"[{time.perf_counter() - t0:7.2f}s] dataset ready ({args.maps} "
          f"{args.type})", flush=True)

    solver = DenseTreeSolver(args.type, method=args.method, device=device)
    metrics = None
    for label in ("cold", "warm", "warm2"):
        last = label == "warm2"
        if last:
            metrics = LevelMetrics()
            for k in kernels.launches:
                kernels.launches[k] = 0
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        solver.run(maps, metrics=metrics, time_levels=last)
        w = time.perf_counter() - t1
        print(f"{label}: {w:8.4f} s ({(args.maps - 1) / w:8.1f} maps "
              f"joined/s) timing="
              f"{ {k: round(v, 4) for k, v in solver._last_timing.items()} }",
              flush=True)
    plan = solver._prep[0]
    for r, lp in zip(metrics.records, plan.levels):
        idt, meth = solver._policy(2 * lp.caps_in[0])
        print(f"L{r['level']:2d} count={lp.count:4d} in={lp.caps_in} "
              f"out={lp.caps_out} {str(idt).split('.')[-1]}/{meth}"
              f"{' fused' if r.get('fused') else ''} "
              f"exec_wall={r['exec_wall'] * 1e3:9.3f} ms", flush=True)
    print(f"kernel launches {dict(kernels.launches)}", flush=True)
    if device == "cuda":
        print(f"peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
