"""k3_roofline_pct: kernel K3 (`seg_sum_fixed`, csrc/segment_sum.cu, two
kernels a launch) against its memory roofline over the traced solves: the
sum over its launches of their least bytes (`roofline.k3_bytes`) over the
HBM rate, over the profiler's summed device time of its kernels. Bytes
only: the latency of one add chain is a measured floor, not a peak."""

from benchmark import roofline


def read(run):
    launches = [b for s in run.sessions for b in s["bytes"][1]]
    device_s = sum(s["k3_s"] for s in run.sessions)
    if not launches or device_s <= 0:
        return None
    return 100.0 * sum(launches) / roofline.HBM_BYTES_PER_S / device_s
