"""The mono refine configuration, found by its cell's name in
BENCHMARK.json, the reader of the mono gauge's span on fabricated
solves, and the PCG's sweeps read in the mono refine cell."""

import math

import pytest

from benchmark import run

PARENT = dict(compact=0.5, plan=1.5, upload=0.2, levels=1.8, get=0.0)


def _run(solves):
    return run.Run({}, {}, {}, solves, [])


def test_mono_refine_found_by_name():
    b = run.Bench()
    cfg = b.config(b.cell("mono3499_refine.covis")["config"])
    assert (cfg["maps"], cfg["datatype"], cfg["executor"], cfg["method"]) == (
        3498, "mono", "device", "refine")
    assert cfg["reduced"] == []
    assert set(cfg["limits"]) == {"id_mismatch", "pose_gap", "feat_gap",
                                  "info_gap"}
    assert cfg["limits"]["id_mismatch"] == 0
    covis = b.mix(b.cell("mono3499_refine.covis")["traffic"])
    assert covis["name"] == "covis"
    # the pool: ceil(70,000 / 3,498) = 21 sets
    assert max(2, math.ceil(covis["pool_maps"] / cfg["maps"])) == 21
    assert b.cell("mono3499_refine.covis")["chips"] == 1
    e2e = {m["name"] for m in b.metrics("mono3499_refine.covis", False)}
    assert e2e == {"maps_joined_per_s", "setup_s"}


def test_new_cells_report_the_new_metrics():
    b = run.Bench()
    names = {c: {m["name"] for m in b.metrics(c, True)}
             for c in ("mono3499_refine.covis", "rs468_mono.covis",
                       "nc3500_stereo.covis")}
    assert {"mono_gauge_pct", "pcg_sweeps_per_solve"} <= names[
        "mono3499_refine.covis"]
    assert "mono_gauge_pct" in names["rs468_mono.covis"]
    # the sweeps in the two refine cells; the direct cell runs no PCG
    assert "pcg_sweeps_per_solve" not in names["rs468_mono.covis"]
    assert "pcg_sweeps_per_solve" in names["nc3500_stereo.covis"]
    assert "mono_gauge_pct" not in names["nc3500_stereo.covis"]
    # every accepted per-layer metric without a list of cells
    for m in b.spec["per_layer"]:
        if "workloads" not in m:
            assert m["name"] in names["mono3499_refine.covis"]
    spec = {m["name"]: m for m in b.spec["per_layer"]}
    assert spec["mono_gauge_pct"]["moves"] == "maps_joined_per_s"
    assert spec["mono_gauge_pct"]["layer"] == "level driver"
    assert spec["mono_gauge_pct"]["source"] == "program_span"


def _solves(key, parts, sweeps=(40, 41, 60), esc=(1, 0, 2)):
    """A traced solve (left out by the readers) and two plain ones."""
    return [dict(wall=w, ok=True, traced=traced,
                 timing=dict(PARENT, **{key: p, "pcg_sweeps": n,
                                        "pcg_escalations": e}))
            for w, p, n, e, traced in zip((2.0, 4.0, 4.0), parts, sweeps,
                                          esc, (True, False, False))]


def test_mono_gauge_pct():
    read = run.Bench().reader("mono_gauge_pct")
    # the traced solve is left out: (1 + 3) / 8
    assert read(_run(_solves("mono_gauge", (2.0, 1.0, 3.0)))) == (
        pytest.approx(50.0))
    # the parent's timings, without the span: no value, never 0
    parent = [dict(wall=4.0, ok=True, traced=False, timing=dict(PARENT))]
    assert read(_run(parent)) is None
    # a stereo solve leaves the span's seconds at 0: nothing read
    assert read(_run(_solves("mono_gauge", (0.0, 0.0, 0.0)))) is None
    assert read(_run([])) is None


def test_pcg_sweeps_per_solve_reads_mono_refine_solves():
    """The PCG's sweeps of mono refine solves, escalation sweeps included,
    are read by the stereo cell's reader: the same counter."""
    read = run.Bench().reader("pcg_sweeps_per_solve")
    # the mean over the plain solves: (41 + 60) / 2
    assert read(_run(_solves("mono_gauge", (1.0,) * 3))) == (
        pytest.approx(50.5))
    parent = [dict(wall=4.0, ok=True, traced=False, timing=dict(PARENT))]
    assert read(_run(parent)) is None
    # a direct solve counts no sweep
    assert read(_run(_solves("mono_gauge", (1.0,) * 3, (0, 0, 0)))) is None


@pytest.mark.parametrize("kind", [None, "stale", "half", "altered",
                                  "control"])
def test_faults_make_the_mono_refine_run_incorrect(tiny, kind):
    """The mono refine cell's run on the CPU at a small size: correct, and
    incorrect for each fault and for the float32 reference in the
    program's place (the program's float32 path returns non-finite mono
    states at the cell's size on the card: no number of its own)."""
    import torch
    from benchmark.tests.test_sfmbench_faults import _solver
    torch.set_num_threads(1)
    workload = "mono3499_refine.covis"
    bench = run.Bench(tiny)
    factory = None if kind is None else _solver(kind, workload)
    # a window of 2 s: at least two solves, also on a loaded machine
    res, lines = run.run_cell(bench, workload, 2**31 + 99, 2.0, False,
                              device="cpu", solver_factory=factory)
    assert res["attempted"] >= 2
    assert res["correct"] is (kind is None), (kind, lines)
    assert set(res["checks"]) == set(bench.config("mono3499_refine")[
        "limits"])
