"""mono_gauge_pct: the share of the window's solve walls that the mono
gauge takes in the joins (`core/join.join_mono`: the angle wraparound, the
drop of the reference pose's blocks, the pose identification and the
solve's gauge masks, before the feature matching): the self seconds of the
solver's `mono_gauge` spans, summed per solve in its `_last_timing`
"mono_gauge" (host clock), over the solves that ran outside the profiler.
The span lies inside `join`, whose self time leaves it out. None where the
solver records no such span."""


def read(run):
    solves = run.host_solves()
    wall = sum(s["wall"] for s in solves)
    part = sum(s["timing"].get("mono_gauge", 0.0) for s in solves)
    return 100.0 * part / wall if wall > 0 and part > 0 else None
