"""One rank of a multi-process solve of a synthetic set (gloo transport).

    python3 -m linearsfm_tpu_torch.tools.multihost_worker COORD NPROC RANK
        OUTDIR [--type stereo|mono] [--device cuda|cpu|cuda:<i>]
        [--maps 8] [--seed 3] [--noise 0.01] [--covis-radius 3.0]
        [--covis-max 4] [--method direct]

COORD is "host:port" of rank 0 (a free port on localhost for ranks of one
machine). Every rank makes the same `synth.generate` set, joins the
process group (`parallel/mesh.init_multihost`), reduces its own blocks,
gathers every block root and runs the top levels
(`parallel/multihost.run_multihost`), then writes the valid pose ids and
poses to OUTDIR/result_<RANK>.npz. The defaults are the 8-map stereo set of
the multi-host tests; ranks may share one card (gloo moves host arrays).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("coord")
    ap.add_argument("nproc", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("outdir")
    ap.add_argument("--type", default="stereo", choices=("stereo", "mono"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--maps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--noise", type=float, default=0.01)
    ap.add_argument("--covis-radius", type=float, default=3.0)
    ap.add_argument("--covis-max", type=int, default=4)
    ap.add_argument("--method", default="direct")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist
    from synth import generate as gen
    from linearsfm_tpu_torch import types
    from linearsfm_tpu_torch.parallel import mesh as mesh_mod
    from linearsfm_tpu_torch.parallel import multihost as MH

    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            print("multihost_worker: no CUDA device", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
    maps, _, _ = gen.make_dataset(args.maps, args.type, noise=args.noise,
                                  seed=args.seed,
                                  covis_radius=args.covis_radius,
                                  covis_max=args.covis_max)
    mesh_mod.init_multihost(args.coord, args.nproc, args.rank)
    try:
        if dist.is_initialized() and dist.get_world_size() != args.nproc:
            raise RuntimeError(f"world size {dist.get_world_size()}, "
                               f"want {args.nproc}")
        final = types.to_numpy(MH.run_multihost(
            maps, args.type,
            solver_kw=dict(method=args.method, device=args.device)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    keep = final.pose_ids >= 0
    os.makedirs(args.outdir, exist_ok=True)
    np.savez(os.path.join(args.outdir, f"result_{args.rank}.npz"),
             ids=final.pose_ids[keep], poses=final.poses[keep])
    print(f"rank {args.rank}: wrote {int(keep.sum())} poses", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
