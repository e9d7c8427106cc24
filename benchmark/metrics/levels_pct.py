"""levels_pct: the share of the window's solve walls that the level driver
takes (`core/device_tree` with the joins and kernels beneath it: the
solver's `_last_timing` "upload" + "levels", host clock, the levels' part
ending in the solver's synchronise), over the solves that ran outside the
profiler."""


def read(run):
    solves = run.host_solves()
    wall = sum(s["wall"] for s in solves)
    part = sum(s["timing"].get("upload", 0.0) + s["timing"].get("levels", 0.0)
               for s in solves)
    return 100.0 * part / wall if wall > 0 and part > 0 else None
