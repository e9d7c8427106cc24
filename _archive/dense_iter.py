"""chip_smoke.py's phase 10 (the dense executor) without the other phases.

    python3 _archive/dense_iter.py     (one CUDA GPU, from the repo root)

Builds the kernels and both 2,048-map sets, runs phases 6-7 for the device
executor's poses, writes the stereo text set and runs the device CLI on
it, then phase 10; then, for the record, two more configurations of the
dense executor (stereo with mixed_max_m=0, mono with the default 32): one
warm and one timed run each, with the timed run's wall and its ATE and
pose max |diff| against the device executor, or its count of non-finite
poses."""
import os, sys, tempfile, time
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import torch
import chip_smoke as cs
from linearsfm_tpu_torch.ops import kernels

t0 = time.perf_counter()
import subprocess
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(), flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.cuda.set_per_process_memory_fraction(0.5)
kernels.build()
print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
datasets = {d: cs.make_dataset(d) for d in ("stereo", "mono")}
shapes = cs._k2_shapes(datasets)
single = {}
for d, (maps, gt, tp) in datasets.items():
    _, single[d], _ = cs.phase_main_path(d, maps, gt, tp, shapes)
with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
    os.makedirs(os.path.join(tmp, "stereo"))
    from linearsfm_tpu_torch.io import localmap as lio
    lio.write_dataset(datasets["stereo"][0], os.path.join(tmp, "stereo"))
    cli = {}
    cli["stereo"], _ = cs._cli_subprocess("entry cli stereo", os.path.join(tmp, "stereo"), "stereo", 2048, datasets["stereo"][1], tmp)
    print(cs.phase_dense(datasets, single, tmp, cli), flush=True)
print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
# extra configurations, for the record
from linearsfm_tpu_torch.core.dense_tree import DenseTreeSolver
import numpy as np
for d, mm in (("stereo", 0), ("mono", 32)):
    maps, gt, _ = datasets[d]
    s = DenseTreeSolver(d, method="refine", mixed_max_m=mm, device="cuda")
    s.run(maps)
    torch.cuda.synchronize(); t1 = time.perf_counter()
    out = s.run(maps)
    w = time.perf_counter() - t1
    p = cs._poses_by_id(out)
    fin = all(np.isfinite(v).all() for v in p.values())
    nfin = sum(1 for v in p.values() if not np.isfinite(v).all())
    msg = f"ATE {cs._ate_of(p, gt):.9f} diff vs device {cs._max_diff('x', p, single[d]):.3e}" if fin else f"{nfin} non-finite poses"
    print(f"extra dense {d} mixed_max_m={mm}: {w:.4f} s, {msg}", flush=True)
