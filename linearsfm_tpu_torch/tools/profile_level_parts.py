"""Split one device-tree level's wall into transform / join+solve / compact.

    python3 -m linearsfm_tpu_torch.tools.profile_level_parts [NUM_MAPS]
        [LEVEL] [stereo|mono] [--cpu]

Counterpart of `tools/profile_level_parts.py` (defaults 512 maps, level 8,
stereo; the data is `synth.generate.make_dataset(NUM, TYPE, noise=0.005,
seed=7)`). Runs the real tree (`DeviceTreeSolver._level`) up to LEVEL-1 on
the input `DeviceTreeSolver.prepare` builds, then times three programs on
that level's input: (T) the lane-batched gauge transform only
(`ops/congruence.transform_map_stereo`/`_mono` over the pair lanes), (TJ)
transform + join/solve (`DeviceTreeSolver._merge`), (full) the level as the
solver runs it (`_level`: adds the odd carry, the re-gauge and
`dcompact`). Each takes one warm call, then the least wall of 3
synchronised calls; differences attribute the wall to each stage. Runs on
the card unless --cpu is given (no CUDA and no --cpu: exit 1).

`level_parts(solver, maps, levels=None)` does the timing for other
callers: the tree runs once and every level of `levels` (default: every
level of the plan) is split on the way.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

LABELS = {"T": "T   (transform)", "TJ": "TJ  (transform+join/solve)",
          "full": "full (level program)"}


def _programs(solver, lp):
    """The three programs of level `lp`, each a function of its input x:
    T and TJ split the pair lanes themselves, as the level does."""
    from linearsfm_tpu_torch import types
    from linearsfm_tpu_torch.ops import congruence

    cfg = solver._level_cfg(lp)
    npair = lp.count // 2

    def split(x):
        return (types.lanes(x, slice(0, 2 * npair, 2)),
                types.lanes(x, slice(1, 2 * npair, 2)))

    def prog_T(x):
        g, m = split(x)
        if solver.datatype == "stereo":
            return congruence.transform_map_stereo(
                g, m.gauge.ref, info_dtype=cfg.info_dtype)
        return congruence.transform_map_mono(
            g, m.gauge.ref, m.gauge.scap, m.gauge.fix,
            info_dtype=cfg.info_dtype)

    return {"T": prog_T,
            "TJ": lambda x: solver._merge(*split(x), cfg)[0],
            "full": lambda x: solver._level(x, lp)[0]}


def level_parts(solver, maps, levels=None) -> dict:
    """{level: dict(count, caps_in, caps_out, T, TJ, full, poses)} for each
    1-based level of `levels` (None: every level of the plan): the three programs' least walls in ms (one
    warm call, then 3 synchronised calls) on that level's input as
    `solver.run` builds it, and, as host numpy, the poses [lanes, M, 6]
    each program's last call returned. The tree runs once, up to the
    largest level asked for."""
    from linearsfm_tpu_torch.ops import segment

    # the solver's fixed order (`DeviceTreeSolver.run`)
    with segment.deterministic():
        return _level_parts(solver, maps, levels)


def _level_parts(solver, maps, levels):
    from linearsfm_tpu_torch.tools.common import best_ms

    tp, x = solver.prepare(maps)
    want = set(range(1, len(tp.levels) + 1) if levels is None else levels)
    out = {}
    for li, lp in enumerate(tp.levels, start=1):
        if li in want:
            rec = dict(count=lp.count, caps_in=lp.caps_in,
                       caps_out=lp.caps_out, poses={})
            for name, prog in _programs(solver, lp).items():
                ms, res = best_ms(lambda: prog(x), solver.device)
                rec[name] = ms
                rec["poses"][name] = res.poses.cpu().numpy()
                del res
            out[li] = rec
        if li >= max(want):
            break
        x, _ = solver._level(x, lp)
    return out


def print_parts(li: int, rec: dict) -> None:
    print(f"L{li}: count={rec['count']} in={rec['caps_in']} "
          f"out={rec['caps_out']}", flush=True)
    for name, label in LABELS.items():
        print(f"{label:30s} {rec[name]:10.3f} ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("num", nargs="?", type=int, default=512)
    ap.add_argument("level", nargs="?", type=int, default=8)
    ap.add_argument("type", nargs="?", choices=("stereo", "mono"),
                    default="stereo")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from linearsfm_tpu_torch.tools.common import open_device
    device = open_device(args.cpu, "profile_level_parts")
    if device is None:
        return 1
    from synth import generate as gen
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver

    maps, _, _ = gen.make_dataset(args.num, args.type, noise=0.005, seed=7)
    solver = DeviceTreeSolver(args.type, method="refine", device=device)
    parts = level_parts(solver, maps, [args.level])
    if args.level not in parts:
        print(f"profile_level_parts: the {args.num}-map tree has no "
              f"level {args.level}", file=sys.stderr)
        return 1
    print_parts(args.level, parts[args.level])
    return 0


if __name__ == "__main__":
    sys.exit(main())
