"""schur_f64_pct: the share of the window's solve walls that the float64
Schur assembly keeps the card busy (`ops/schur._assemble_schur_dense`'s
float64 branch: A's densify, K1 of W and Y, the dense product and E): the
device walls of the solver's `schur_f64` spans, from CUDA events, summed
per solve in its `_last_timing` "schur_f64_s", over the solve walls of the
solves that ran outside the profiler. None where the solver records no
such span (a refine solve, or a program without it)."""


def read(run):
    solves = run.host_solves()
    wall = sum(s["wall"] for s in solves)
    part = sum(s["timing"].get("schur_f64_s", 0.0) for s in solves)
    return 100.0 * part / wall if wall > 0 and part > 0 else None
