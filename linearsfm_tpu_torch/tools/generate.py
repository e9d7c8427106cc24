"""Generate synthetic local-map datasets as text, without JAX.

    python3 -m linearsfm_tpu_torch.tools.generate --out DIR [--num 64]
        [--type stereo|mono] [--noise 0.0] [--feats 4] [--seed 0]
        [--pattern loop|grid] [--covis-radius 0.0] [--covis-max 0]

The command line of `python -m synth.generate`, with the same flags and
defaults: the data comes from `synth.generate.make_dataset` and is written
with the port's writer (`io/localmap.write_dataset`), so the files are the
same bytes; `gt_poses.txt` holds the ground-truth poses (id, then the
pose). It runs no device code, so it has no `--cpu`.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Generate synthetic local-map datasets")
    ap.add_argument("--num", type=int, default=64)
    ap.add_argument("--type", choices=["stereo", "mono"], default="stereo")
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--feats", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pattern", choices=["loop", "grid"], default="loop")
    ap.add_argument("--covis-radius", type=float, default=0.0,
                    help="loop-closure co-visibility radius (world units)")
    ap.add_argument("--covis-max", type=int, default=0,
                    help="max extra co-visible features per map")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    from synth import generate as gen
    from linearsfm_tpu_torch.io import localmap as lio

    maps, poses_gt, _ = gen.make_dataset(args.num, args.type, args.feats,
                                         args.noise, args.seed,
                                         pattern=args.pattern,
                                         covis_radius=args.covis_radius,
                                         covis_max=args.covis_max)
    lio.write_dataset(maps, args.out)
    np.savetxt(os.path.join(args.out, "gt_poses.txt"),
               np.concatenate([np.arange(len(poses_gt))[:, None], poses_gt],
                              axis=1))
    print(f"wrote {len(maps)} {args.type} maps to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
