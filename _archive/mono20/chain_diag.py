"""Where a mix's gap comes from: on sets of a configuration under a
traffic mix (files of the benchmark, by name), the float64 reference
against the program's refine path and its direct path (f64 Cholesky of
each reduced system), with the largest residual of every refine level,
on the card.

    python3 _archive/mono20/chain_diag.py CONFIG MIX SEED [SEED ...]
"""
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")
from benchmark import compare, gen, reference, run  # noqa: E402
from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver  # noqa: E402
from linearsfm_tpu_torch.ops import kernels  # noqa: E402

b = run.Bench()
cfg, mix = b.config(sys.argv[1]), b.mix(sys.argv[2])
cell = f"{sys.argv[1]}.{sys.argv[2]}"
kernels.build()
solvers = {m: DeviceTreeSolver(cfg["datatype"], method=m, device="cuda")
           for m in ("refine", "direct")}
for seed in (int(s) for s in sys.argv[3:]):
    maps = gen.make_set(cfg, mix, seed, 0)
    t = time.perf_counter()
    want = reference.solve_tree(maps, cfg["datatype"], np.float64,
                                device="cuda")
    print(f"{cell} seed {seed}: reference {time.perf_counter() - t:.1f} s",
          flush=True)
    for m, s in solvers.items():
        y = s.run(maps)
        torch.cuda.synchronize()
        g = compare.gaps(compare.program_map(y), want)
        res = {lv: float(np.max(r)) for lv, r in s.last_residuals.items()
               if r.size and np.isfinite(r).all()}
        print(f"  {m}: {g}; sweeps {s._last_timing['pcg_sweeps']} "
              f"escalations {s._last_timing['pcg_escalations']}; res_max by "
              f"level {res}", flush=True)
        del y
    torch.cuda.empty_cache()
