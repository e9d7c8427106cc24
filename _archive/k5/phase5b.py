"""chip_smoke's phase 5b alone (K5 held in situ and timed at the RS468 and
NC3500 first sets' level-1 and root calls), then one solve of each cell's
first set traced: K5's emission launch's device time a solve."""
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from linearsfm_tpu_torch.ops import kernels
torch.backends.cuda.matmul.allow_tf32 = False
kernels.build()
print(json.dumps({k: {w: round(t["ms"], 4) for w, t in v.items()}
                  for k, v in (cs.phase_k5() and cs.K5_TIMES).items()}))
from benchmark import gen
from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
from torch.profiler import ProfilerActivity, profile
mix = json.load(open("benchmark/traffic/covis.json"))
for cell in ("nc3500_stereo", "mono3499_refine", "rs468_mono"):
    cfg = json.load(open(f"benchmark/configs/{cell}.json"))
    maps = gen.make_set(cfg, mix, 0, 0)
    s = DeviceTreeSolver(cfg["datatype"], method=cfg["method"])
    s.run(maps); torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s.run(maps); torch.cuda.synchronize()
    gc = {}
    for e in prof.key_averages():
        if "gc_" in e.key:
            name = e.key.split("::")[1].split("<")[0]
            gc[name] = gc.get(name, 0.0) + e.device_time_total / 1e3
    print(cell, "K5 device ms a solve by launch:", gc, flush=True)
