"""transform_pct: the share of the window's solve walls that the levels'
gauge transforms take (`ops/congruence` through
`parallel/level.merge_one_stereo` / `merge_one_mono`): the self seconds of
the solver's `transform` spans, summed per solve in its `_last_timing`
"transform" (host clock), over the solves that ran outside the profiler.
None where the solver records no such span."""


def read(run):
    solves = run.host_solves()
    wall = sum(s["wall"] for s in solves)
    part = sum(s["timing"].get("transform", 0.0) for s in solves)
    return 100.0 * part / wall if wall > 0 and part > 0 else None
