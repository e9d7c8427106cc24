"""The readers of the program's own spans and counts (the solver's
`_last_timing` self seconds and `pcg_sweeps`) on fabricated solves."""

import pytest

from benchmark import run

SHARES = {"plan_tree_pct": "plan_tree", "transform_pct": "transform",
          "join_pct": "join", "regauge_compact_pct": "regauge_compact",
          "sync_wait_pct": "sync"}
# what the parent's solver leaves in `_last_timing`: its five host phases
PARENT = dict(compact=0.5, plan=1.5, upload=0.2, levels=1.8, get=0.0)


def _run(solves):
    return run.Run({}, {}, {}, solves, [])


def _solves(key, parts, sweeps=(40, 41, 60)):
    """A traced solve (left out by the readers) and two plain ones."""
    return [dict(wall=w, ok=True, traced=traced,
                 timing=dict(PARENT, **{key: p, "pcg_sweeps": n}))
            for w, p, n, traced in zip((2.0, 4.0, 4.0), parts, sweeps,
                                       (True, False, False))]


@pytest.mark.parametrize("metric", sorted(SHARES))
def test_program_span_shares(metric):
    read = run.Bench().reader(metric)
    # the traced solve is left out: (1 + 3) / 8
    assert read(_run(_solves(SHARES[metric], (2.0, 1.0, 3.0)))) == (
        pytest.approx(50.0))
    # the parent's timings, without the key: no value, never 0
    parent = [dict(wall=4.0, ok=True, traced=False, timing=dict(PARENT))]
    assert read(_run(parent)) is None
    # nothing read: a part of 0, or no solve
    assert read(_run(_solves(SHARES[metric], (0.0, 0.0, 0.0)))) is None
    assert read(_run([])) is None


def test_pcg_sweeps_per_solve():
    read = run.Bench().reader("pcg_sweeps_per_solve")
    # the mean over the plain solves: (41 + 60) / 2
    assert read(_run(_solves("join", (1.0,) * 3))) == pytest.approx(50.5)
    parent = [dict(wall=4.0, ok=True, traced=False, timing=dict(PARENT))]
    assert read(_run(parent)) is None
    assert read(_run(_solves("join", (1.0,) * 3, (0, 0, 0)))) is None
    assert read(_run([])) is None


def test_new_metrics_are_declared():
    """Each reader here is a per-layer metric of BENCHMARK.json, read
    from the program; the sweeps only in the refine cell."""
    spec = {m["name"]: m for m in run.Bench().spec["per_layer"]}
    for name in list(SHARES) + ["pcg_sweeps_per_solve"]:
        assert spec[name]["moves"] == "maps_joined_per_s"
        assert spec[name]["source"].startswith("program_")
    assert spec["pcg_sweeps_per_solve"]["workloads"] == ["nc3500_stereo.covis"]
