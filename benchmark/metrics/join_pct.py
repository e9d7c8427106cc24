"""join_pct: the share of the window's solve walls that the joins take
(`core/join.join_stereo` / `join_mono` and the solve beneath them, less the
blocking reads): the self seconds of the solver's `join` spans, summed per
solve in its `_last_timing` "join" (host clock), over the solves that ran
outside the profiler. None where the solver records no such span."""


def read(run):
    solves = run.host_solves()
    wall = sum(s["wall"] for s in solves)
    part = sum(s["timing"].get("join", 0.0) for s in solves)
    return 100.0 * part / wall if wall > 0 and part > 0 else None
