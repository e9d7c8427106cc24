"""k1_roofline_pct: kernel K1 (`blockcoo_to_dense`, csrc/blockcoo_dense.cu)
against its memory roofline over the traced solves: the sum over its
launches of their least bytes (`roofline.k1_bytes`) over the HBM rate,
over the profiler's summed device time of its kernel."""

from benchmark import roofline


def read(run):
    launches = [b for s in run.sessions for b in s["bytes"][0]]
    device_s = sum(s["k1_s"] for s in run.sessions)
    if not launches or device_s <= 0:
        return None
    return 100.0 * sum(launches) / roofline.HBM_BYTES_PER_S / device_s
