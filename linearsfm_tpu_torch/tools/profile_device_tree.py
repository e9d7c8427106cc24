"""Wall-clock breakdown of the device-resident tree solve.

    python3 -m linearsfm_tpu_torch.tools.profile_device_tree [NUM_MAPS]
        [stereo|mono] [method] [--cpu]

Counterpart of `tools/profile_device_tree.py` (defaults 512 maps, stereo,
refine; the data is `synth.generate.make_dataset(NUM, TYPE, noise=0.005,
seed=7)`). Prints a cold, a warm and a second warm run of
`DeviceTreeSolver(TYPE, method=METHOD)` (wall, maps joined per second and
the solver's host phases `_last_timing`: compact / plan / upload / levels
/ get), then the wall of each level run alone, one after the other on the
exact plan the solver makes (`DeviceTreeSolver.prepare`, then `_level`,
synchronised after each). Runs on the card unless --cpu is given (no CUDA
and no --cpu: exit 1).

`profile(solver, maps)` prints the same for other callers' maps.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def profile(solver, maps) -> None:
    """Print the cold, warm and warm2 runs and the per-level walls."""
    from linearsfm_tpu_torch.ops import segment
    from linearsfm_tpu_torch.tools.common import sync

    n = len(maps)
    for label in ("cold", "warm", "warm2"):
        t1 = time.perf_counter()
        solver.run(maps)
        sync(solver.device)
        w = time.perf_counter() - t1
        print(f"{label}: {w:8.4f}s ({(n - 1) / w:8.1f} maps/s) timing="
              f"{ {k: round(v, 4) for k, v in solver._last_timing.items()} }",
              flush=True)
    tp, x = solver.prepare(maps)
    sync(solver.device)
    for li, lp in enumerate(tp.levels, start=1):
        t1 = time.perf_counter()
        with segment.deterministic():   # the solver's order, as in `run`
            x, _ = solver._level(x, lp)
        sync(solver.device)
        print(f"L{li:2d} count={lp.count:4d} in={lp.caps_in} "
              f"out={lp.caps_out} wall={time.perf_counter() - t1:8.4f}s",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("num", nargs="?", type=int, default=512)
    ap.add_argument("type", nargs="?", choices=("stereo", "mono"),
                    default="stereo")
    ap.add_argument("method", nargs="?", choices=("refine", "direct"),
                    default="refine")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from linearsfm_tpu_torch.tools.common import open_device
    device = open_device(args.cpu, "profile_device_tree")
    if device is None:
        return 1
    from synth import generate as gen
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver

    t0 = time.perf_counter()
    maps, _, _ = gen.make_dataset(args.num, args.type, noise=0.005, seed=7)
    print(f"[{time.perf_counter() - t0:7.2f}s] dataset ready ({args.num} "
          f"{args.type})", flush=True)
    profile(DeviceTreeSolver(args.type, method=args.method, device=device),
            maps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
