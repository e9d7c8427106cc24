"""plan_tree_pct: the share of the window's solve walls that the id-space
planner takes (`core/plan`: `sym_of_stacked` + `plan_tree_exact`, inside
`DeviceTreeSolver._plan`): the self seconds of the solver's `plan_tree`
spans, summed per solve in its `_last_timing` "plan_tree" (host clock), over
the solves that ran outside the profiler. None where the solver records no
such span."""


def read(run):
    solves = run.host_solves()
    wall = sum(s["wall"] for s in solves)
    part = sum(s["timing"].get("plan_tree", 0.0) for s in solves)
    return 100.0 * part / wall if wall > 0 and part > 0 else None
