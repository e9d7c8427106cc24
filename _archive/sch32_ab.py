"""Both 2,048-map main paths (chip_smoke.py phases 6-7: a warm and a timed
run each) of the tree at ROOT, for a parent/change comparison in one call.

    python3 _archive/sch32_ab.py ROOT     (one CUDA GPU)

Run it on the parent and the change in turns (parent, change, change,
parent); each process builds its tree's kernels."""
import os, subprocess, sys, time
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import torch
import chip_smoke as cs
from linearsfm_tpu_torch.ops import kernels
print(f"tree {root}", flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(), flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.cuda.set_per_process_memory_fraction(0.5)
kernels.build()
datasets = {d: cs.make_dataset(d) for d in ("stereo", "mono")}
shapes = cs._k2_shapes(datasets)
for d, (maps, gt, tp) in datasets.items():
    cs.phase_main_path(d, maps, gt, tp, shapes)
