"""schur_f64_roofline_pct: the float64 Schur assembly against its memory
roofline: the least bytes of the window's assemblies (`roofline_schur`,
from the shapes the solver sums over its `schur_f64` spans in
`_last_timing`) over the HBM rate, over their device walls
("schur_f64_s", CUDA events), over the solves that ran outside the
profiler. None where the solver records no such span."""

from benchmark import roofline, roofline_schur


def read(run):
    solves = [(s, roofline_schur.timing_bytes(s["timing"]))
              for s in run.host_solves()]
    solves = [(s, b) for s, b in solves if b is not None]
    device_s = sum(s["timing"].get("schur_f64_s", 0.0) for s, _ in solves)
    if device_s <= 0:
        return None
    nbytes = sum(b for _, b in solves)
    return 100.0 * nbytes / roofline.HBM_BYTES_PER_S / device_s
