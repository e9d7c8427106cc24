"""Grid mono 2,048 on the port, for the record (no check, no fix).

    python3 _archive/grid_mono_2048.py [--num 2048] [--out DIR] [--cpu]
        [--pattern grid] [--dir DATA_DIR]

Runs `python3 -m linearsfm_tpu_torch.tools.compare_ate --type mono --num N
--covis --pattern grid --json DIR/ate_<N>_grid_mono.json` in
process (the oracle and the port's device refine path on the same files,
in a temporary directory), then solves the same files twice with
`DeviceTreeSolver("mono", method="refine")`: as the pipeline does, and
with `direct_min_m` set to the root's join size (an f64 direct root). For
each: the non-finite poses, the ATE over the finite ones, res_max per level
and the wall. Last, one `method="direct"` run whose root reduced system
(over its free coordinates) gives the condition number
(`tools/direct_paths._root_condition`). `--pattern loop` runs the same on
the loop set, for comparison; `--dir` keeps the dataset and pose files
there, so the JAX package's tool can solve the same files on the CPU:
`python3 tools/compare_ate.py --cpu --num N --type mono --covis --pattern
grid --dir DATA_DIR --phase tpu [--method direct]`."""
import argparse, json, os, sys, tempfile, time
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import numpy as np
import torch
from linearsfm_tpu_torch import types
from linearsfm_tpu_torch.core import pipeline
from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
from linearsfm_tpu_torch.ops import solve
from linearsfm_tpu_torch.tools import compare_ate
from linearsfm_tpu_torch.tools.direct_paths import _root_condition
from linearsfm_tpu_torch.tools.common import open_device, sync
from linearsfm_tpu_torch.utils.metrics import LevelMetrics

ap = argparse.ArgumentParser()
ap.add_argument("--num", type=int, default=2048)
ap.add_argument("--out", default=".")
ap.add_argument("--cpu", action="store_true")
ap.add_argument("--pattern", default="grid")
ap.add_argument("--dir", default=None)
args = ap.parse_args()
n = args.num
out = args.out
tmp = tempfile.TemporaryDirectory()
d = args.dir or tmp.name
rec = os.path.join(out, f"ate_{n}_{args.pattern}_mono.json")
argv = ["--type", "mono", "--num", str(n), "--covis", "--pattern", args.pattern,
        "--json", rec, "--dir", d] + (["--cpu"] if args.cpu else [])
t0 = time.perf_counter()
rc = compare_ate.main(argv)
print(f"compare_ate exit {rc} in {time.perf_counter() - t0:.1f} s", flush=True)
if os.path.exists(rec):
    print(open(rec).read(), flush=True)
dev = open_device(args.cpu, "grid_mono")
gt = np.load(os.path.join(d, "poses_gt.npy"))
maps = pipeline.load_local_maps(d, n, "mono")
root_m = DeviceTreeSolver("mono", device=dev).prepare(maps)[0].levels[-1].join_m
for label, kw in (("refine", {}), (f"refine, direct_min_m={root_m}",
                                   dict(direct_min_m=root_m))):
    solver = DeviceTreeSolver("mono", method="refine", device=dev, **kw)
    metrics = LevelMetrics()
    t1 = time.perf_counter()
    h = types.host_fields(solver.run(maps, metrics=metrics))
    sync(dev)
    wall = time.perf_counter() - t1
    v = h.pose_ids >= 0
    ids, poses = h.pose_ids[v], h.poses[v]
    fin = np.isfinite(poses).all(axis=1)
    err = np.linalg.norm(poses[fin, :3] - gt[ids[fin], :3], axis=1)
    ate = float(np.sqrt(np.mean(np.square(err)))) if fin.any() else float("nan")
    res = {r["level"]: r.get("res_max") for r in metrics.records}
    print(f"{args.pattern} mono {n} {label}: wall {wall:.3f} s (cold solver), {len(ids)} "
          f"poses, {int((~fin).sum())} non-finite, ATE over the finite "
          f"{ate:.9f}; res_max by level {res}", flush=True)

captured = []
reduced = solve.solve_reduced


def keep(S, E, fixed_mask=None, *a, **k):
    if fixed_mask is not None and (not captured or S.shape[-1]
                                   > captured[0][0].shape[-1]):
        captured[:] = [(S, fixed_mask)]
    return reduced(S, E, fixed_mask, *a, **k)


solve.solve_reduced = keep
try:
    DeviceTreeSolver("mono", method="direct", device=dev).run(maps)
finally:
    solve.solve_reduced = reduced
c = _root_condition(captured[0])
print(f"{args.pattern} mono {n} direct: root reduced system over its {c['dim']} free "
      f"coordinates: eigenvalues {c['eig_min']:.6e} .. {c['eig_max']:.6e}, "
      f"condition number {c['cond']:.6e}", flush=True)
