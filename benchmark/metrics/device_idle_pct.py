"""device_idle_pct: the share of the traced solves' walls in which no
kernel, fill or copy ran on the card: 100 x (1 - the union of the
profiler's device intervals / the solves' walls)."""


def read(run):
    wall = sum(s["wall_s"] for s in run.sessions)
    if wall <= 0:
        return None
    busy = sum(s["busy_s"] for s in run.sessions)
    return 100.0 * (1.0 - busy / wall)
