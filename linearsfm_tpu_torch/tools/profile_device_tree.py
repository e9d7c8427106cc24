"""Wall-clock breakdown of the device-resident tree solve.

    python3 -m linearsfm_tpu_torch.tools.profile_device_tree [NUM_MAPS]
        [stereo|mono] [method] [--cpu]

Counterpart of `tools/profile_device_tree.py` (defaults 512 maps, stereo,
refine; the data is `synth.generate.make_dataset(NUM, TYPE, noise=0.005,
seed=7)`). Prints a cold, a warm and a second warm run of
`DeviceTreeSolver(TYPE, method=METHOD)` (wall, maps joined per second and
the solver's `_last_timing`: the host phases compact / plan / upload /
levels / get, its spans' self seconds and its counts), then one row per
level of the last run, from its spans (`solver.last_spans`): the host
self seconds of its transform / join / mono_gauge / sync /
regauge_compact spans, its device wall, the bytes allocated at its end
(on a card) and its PCG sweeps. Runs on the card unless --cpu is given
(no CUDA and no --cpu: exit 1).

`profile(solver, maps)` prints the same for other callers' maps.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

PARTS = ("transform", "join", "mono_gauge", "sync", "regauge_compact")


def profile(solver, maps) -> None:
    """Print the cold, warm and warm2 runs and the last one's levels."""
    from linearsfm_tpu_torch.tools.common import sync
    from linearsfm_tpu_torch.utils.metrics import self_seconds, subtree

    n = len(maps)
    for label in ("cold", "warm", "warm2"):
        t1 = time.perf_counter()
        solver.run(maps)
        sync(solver.device)
        w = time.perf_counter() - t1
        print(f"{label}: {w:8.4f}s ({(n - 1) / w:8.1f} maps/s) timing="
              f"{ {k: round(v, 4) for k, v in solver._last_timing.items()} }",
              flush=True)
    spans = solver.last_spans
    for i, sp in enumerate(spans):
        if sp["name"] != "level":
            continue
        a, under = sp["attrs"], subtree(spans, i)
        own = self_seconds(spans, under)
        mem = a["memory_allocated"]
        print(f"L{a['level']:2d} count={a['count']:4d} mode={a['mode']} "
              + " ".join(f"{k}={own.get(k, 0.0) * 1e3:8.3f}ms" for k in PARTS)
              + f" device={a['device_wall'] * 1e3:8.3f}ms live="
              + ("-" if mem is None else f"{mem / 2**20:.1f}MiB")
              + " sweeps=" + str(sum(spans[j]["attrs"].get("pcg_sweeps", 0)
                                     for j in under)), flush=True)


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
