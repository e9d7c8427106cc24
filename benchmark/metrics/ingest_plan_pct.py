"""ingest_plan_pct: the share of the window's solve walls that the solver's
host ingest and plan take (`core/compact` + `core/plan`: its `_last_timing`
"compact" + "plan", host clock), over the solves that ran outside the
profiler."""


def read(run):
    solves = run.host_solves()
    wall = sum(s["wall"] for s in solves)
    part = sum(s["timing"].get("compact", 0.0) + s["timing"].get("plan", 0.0)
               for s in solves)
    return 100.0 * part / wall if wall > 0 and part > 0 else None
