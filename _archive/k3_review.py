"""K3's holds on the card: phase 4b of chip_smoke.py (every case against
the plain version and the CPU's `index_add_` on the raw index list) at the
mono plan's shapes, and direct mono on the host executor at 512 maps
(phase 12e's set) twice, the second run held in situ (`_held_counted`:
every K1, K2 and K3 call against its plain version, every K3 plan against
the CPU's), the two runs' poses `torch.equal`. Run from the repo root on
one GPU: python3 _archive/k3_review.py"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from synth import generate as gen  # noqa: E402
from linearsfm_tpu_torch.core.tree import TreeSolver  # noqa: E402
from linearsfm_tpu_torch.ops import kernels  # noqa: E402

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip(), flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.perf_counter()
kernels.build()
print(f"build {time.perf_counter() - t0:.2f} s", flush=True)
maps, gt, tp = cs.make_dataset("mono")
shapes = cs._k2_shapes({"mono": (maps, gt, tp)})
del maps, gt, tp
t0 = time.perf_counter()
err, times = cs.phase_k3(shapes)
print(f"phase 4b {time.perf_counter() - t0:.2f} s, max err {err}", flush=True)
mono512, _, _ = gen.make_dataset(512, "mono", noise=0.005, seed=7,
                                 covis_radius=6.0, covis_max=6)
solver = TreeSolver("mono", method="direct")
first, counts, wall = cs._counted(lambda: solver.run(mono512))
t0 = time.perf_counter()
out, held, wall2 = cs._held_counted("host mono 512 direct",
                                    lambda: solver.run(mono512), fixed=True)
same = torch.equal(torch.as_tensor(first.poses), torch.as_tensor(out.poses))
print(f"host mono 512 direct: walls {wall:.4f} s, {wall2:.4f} s in situ; "
      f"launches {counts}, {held}; poses torch.equal {same}; in-situ max "
      f"err {cs._K3InSitu.worst}", flush=True)
sys.exit(0 if same else 1)
