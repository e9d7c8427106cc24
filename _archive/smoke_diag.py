"""chip_smoke.main() with every torch.profiler trace of _device_ms kept
under chiprun_out/traces/, a failing device-time read reported, not
raised, and each _device_ms call also timed by CUDA events behind a spin
(the host's launches hidden), printed beside it."""
import os, shutil, sys, itertools, statistics
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import torch
import chip_smoke as cs
from linearsfm_tpu_torch.tools import profile_k1

out = os.path.join(HERE, "chiprun_out", "traces")
os.makedirs(out, exist_ok=True)
seq = itertools.count()
kept = []
orig_by_range = profile_k1.device_events_by_range


def keep(trace, prefix):
    kept.append(os.path.join(out, f"trace_{next(seq):02d}.json"))
    shutil.copy(trace, kept[-1])
    return orig_by_range(trace, prefix)


profile_k1.device_events_by_range = keep
orig = cs._device_ms


def event_ms(fns, reps=10):
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    res = {}
    for name, fn in fns.items():
        ts = []
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            ts.append(s.elapsed_time(e))
        res[name] = round(statistics.median(ts), 5)
    return res


def tolerant(fns, reps=10):
    try:
        got = orig(fns, reps)
    except AssertionError as e:
        print(f"DIAG device_ms failed ({kept[-1]}): {e}", flush=True)
        got = {k: float("nan") for k in fns}
    print(f"DIAG profiler {({k: round(v, 5) for k, v in got.items()})} "
          f"events {event_ms(fns, reps)} ({kept[-1]})", flush=True)
    return got


cs._device_ms = tolerant
sys.exit(cs.main())
