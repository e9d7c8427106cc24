"""K5 against the plain transform on the card: CUDA-event walls of one call
(host issue included) at random lanes of the cells' level-1 shapes and a
root-like lane, and end-to-end solves of one RS468 set."""
import json, os, statistics, sys, time
sys.path.insert(0, os.getcwd())
import torch
from linearsfm_tpu_torch.ops import congruence, kernels, segment
sys.path.insert(0, "tests")
from test_torch_kernels import _k5_map

def wall(fn, n=20):
    ts = []
    for _ in range(n + 2):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter(); a.record(); fn(); b.record(); b.synchronize()
        ts.append((a.elapsed_time(b), (time.perf_counter() - t0) * 1e3))
    ts = ts[2:]
    return statistics.median(t[0] for t in ts), statistics.median(t[1] for t in ts)

torch.backends.cuda.matmul.allow_tf32 = False
# (P, M, N, KU, KW): RS468 level 1 (captured on the CPU), NC3500-like level
# 1 and a root-like lane
for name, mono, shape in (("rs468 L1", True, (233, 16, 32, 64, 64)),
                          ("nc3500 L1-like", False, (1749, 8, 32, 64, 64)),
                          ("root-like mono", True, (1, 480, 1872, 5440, 57856))):
    lm = _k5_map(3, *shape, mono, device="cuda")
    if mono:
        P = shape[0]
        new = (lm.pose_ids[:, 3].clone(), lm.pose_ids[:, 4].clone(),
               torch.ones(P, dtype=torch.int64, device="cuda"))
        k = lambda: congruence.transform_map_mono(lm, *new)
        p = lambda: congruence.transform_map_mono_ref(lm, *new)
    else:
        new = (lm.pose_ids[:, 3].clone(),)
        k = lambda: congruence.transform_map_stereo(lm, *new)
        p = lambda: congruence.transform_map_stereo_ref(lm, *new)
    with segment.deterministic():
        kd, kh = wall(k)
        pd, ph = wall(p, 5)
    print(f"{name} {shape}: K5 {kd:.3f} ms (host {kh:.3f}), plain {pd:.3f} ms (host {ph:.3f})", flush=True)
    nbytes = kernels.gauge_congruence_bytes(*shape, mono, 8)
    print(f"   bytes bound {nbytes / 3.35e12 * 1e3:.4f} ms", flush=True)

from benchmark import gen
from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
cfg = json.load(open("benchmark/configs/rs468_mono.json"))
mix = json.load(open("benchmark/traffic/covis.json"))
sets = [gen.make_set(cfg, mix, 123456789, j) for j in range(4)]
s = DeviceTreeSolver("mono", method="direct")
s.run(sets[0]); torch.cuda.synchronize()
saved = kernels.gauge_congruence
for label in ("K5", "plain", "K5", "plain"):
    if label == "plain":
        kernels.gauge_congruence = lambda lm, mono, new, i=None: congruence.transform_map_mono_ref(lm, *new, i)
    else:
        kernels.gauge_congruence = saved
    ws = []
    for m in sets:
        torch.cuda.synchronize(); t0 = time.perf_counter(); s.run(m); torch.cuda.synchronize()
        ws.append(time.perf_counter() - t0)
    t = s._last_timing
    print(f"RS468 {label}: solves {[round(w, 4) for w in ws]} s, transform {t['transform']:.4f} regauge_compact {t['regauge_compact']:.4f} join {t['join']:.4f} k5 {t['k5_launches']}", flush=True)
kernels.gauge_congruence = saved
