"""First look at kernel K3 on the card: ptxas's report, the build, phase
4b of chip_smoke.py at the mono plan's shapes, and direct mono at 2,048
maps through DeviceTreeSolver twice (fixed order: equal poses) with K3's
launches. Run from the repo root: python3 _archive/k3_check.py"""
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from linearsfm_tpu_torch.ops import kernels  # noqa: E402

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip(), flush=True)
src = os.path.join(kernels._PKG, "csrc", "segment_sum.cu")
with tempfile.TemporaryDirectory() as tmp:
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas",
                        "-v", "-c", "-o", os.path.join(tmp, "k3.o"), src],
                       capture_output=True, text=True)
print("ptxas:", r.returncode, r.stderr[-3000:], flush=True)
t0 = time.perf_counter()
kernels.build()
print(f"build {time.perf_counter() - t0:.2f} s", flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
maps, gt, tp = cs.make_dataset("mono")
shapes = cs._k2_shapes({"mono": (maps, gt, tp)})
t0 = time.perf_counter()
times = cs.phase_k3(shapes)
print(f"phase 4b {time.perf_counter() - t0:.2f} s {times}", flush=True)
from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver  # noqa
solver = DeviceTreeSolver("mono", method="direct")
poses = []
for k in range(3):
    out, counts, wall = cs._counted(lambda: solver.run(maps))
    poses.append(out.poses.clone())
    print(f"direct mono run {k}: wall {wall:.4f} s, launches {counts}, ATE "
          f"{cs._ate_of(cs._poses_by_id(out), gt):.12f}", flush=True)
print("equal:", [torch.equal(poses[0], p) for p in poses[1:]], flush=True)
