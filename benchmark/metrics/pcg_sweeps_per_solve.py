"""pcg_sweeps_per_solve: the mean number of PCG sweeps a solve runs
(`ops/schur.pcg`'s sweeps, escalation sweeps included, counted by the
solver in its `_last_timing` "pcg_sweeps"), over the solves that ran
outside the profiler. None where the solver counts none."""


def read(run):
    sweeps = [s["timing"]["pcg_sweeps"] for s in run.host_solves()
              if "pcg_sweeps" in s["timing"]]
    mean = sum(sweeps) / len(sweeps) if sweeps else 0
    return mean if mean > 0 else None
