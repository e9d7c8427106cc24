"""chip_smoke.py's phase 11 and phase 10a's timings without the other phases.

    python3 _archive/tools_iter.py     (one CUDA GPU, from the repo root)

Builds the kernels and both 2,048-map sets, runs phases 6-7 (the device
executor's poses, which phase 10a compares with), phase 10a's dense paths
(with K1 at level 0 timed alone) and the dense root's K2 times, then phase
11 (the tools and scale)."""
import os, sys, subprocess, time
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import torch
import chip_smoke as cs
from linearsfm_tpu_torch.ops import kernels

t0 = time.perf_counter()
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
caps = {}
for d, kw in (("stereo", {}), ("mono", dict(mixed_max_m=0))):
    maps, gt, _ = datasets[d]
    _, caps[d] = cs._dense_main_path(d, maps, gt, single[d], **kw)
cs._dense_k2_cost(*caps["stereo"])
t1 = time.perf_counter()
print(cs.phase_tools(datasets), flush=True)
print(f"phase 11 {time.perf_counter() - t1:.1f} s; total {time.perf_counter() - t0:.1f} s", flush=True)
