"""sync_wait_pct: the share of the window's solve walls that the host spends
blocked in reads from the device (the PCG's exit and escalation tests,
`ops/schur.pcg`, and the synchronise that ends the levels): the self seconds
of the solver's `sync` spans, summed per solve in its `_last_timing` "sync"
(host clock), over the solves that ran outside the profiler. None where the
solver records no such span."""


def read(run):
    solves = run.host_solves()
    wall = sum(s["wall"] for s in solves)
    part = sum(s["timing"].get("sync", 0.0) for s in solves)
    return 100.0 * part / wall if wall > 0 and part > 0 else None
