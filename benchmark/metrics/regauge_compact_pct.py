"""regauge_compact_pct: the share of the window's solve walls that the
re-gauges to the final frame and the compactions take
(`core/dcompact.compact_device`, `DeviceTreeSolver._regauge_compact`): the
self seconds of the solver's `regauge_compact` spans, summed per solve in
its `_last_timing` "regauge_compact" (host clock), over the solves that ran
outside the profiler. None where the solver records no such span."""


def read(run):
    solves = run.host_solves()
    wall = sum(s["wall"] for s in solves)
    part = sum(s["timing"].get("regauge_compact", 0.0) for s in solves)
    return 100.0 * part / wall if wall > 0 and part > 0 else None
