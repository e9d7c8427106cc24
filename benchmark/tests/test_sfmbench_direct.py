"""NC3500 stereo on the direct float64 path, found by name in
BENCHMARK.json, the chain mix beside the covis mix, the readers of the
float64 Schur assembly's span on fabricated solves, its least bytes
counted by hand, and the cell's runs on the CPU at a small size."""

import math

import pytest

from benchmark import control, roofline, roofline_schur, run

CELLS = ("nc3500_stereo_direct.covis",)
METRICS = ("schur_f64_pct", "schur_f64_roofline_pct")
# what the parent's solver leaves in `_last_timing`: no schur_f64 key
PARENT = dict(compact=0.5, plan=1.5, upload=0.2, levels=1.8, get=0.0)
# one root-sized assembly: P, M, N, KU, KW of the NC3500 root
ROOT_SHAPE = dict(P=1, M=4096, N=21440, KU=40000, KW=360000)


def _run(solves):
    return run.Run({}, {}, {}, solves, [])


def test_cells_found_by_name():
    b = run.Bench()
    direct = b.cell("nc3500_stereo_direct.covis")
    assert (direct["config"], direct["traffic"], direct["chips"]) == (
        "nc3500_stereo_direct", "covis", 1)
    cfg = b.config("nc3500_stereo_direct")
    assert (cfg["maps"], cfg["datatype"], cfg["executor"], cfg["method"],
            cfg["reduced"]) == (3499, "stereo", "device", "direct", [])
    spec = {c["name"]: c for c in b.spec["configs"]}
    assert spec["nc3500_stereo_direct"]["source"] == cfg["source"]
    assert spec["nc3500_stereo_direct"]["reduced"] == []
    # the chain mix (no cell runs it yet): covis without loop-closure
    # landmarks, the same pool
    covis, mix = b.mix("covis"), b.mix("chain")
    assert (mix["covis_radius"], mix["covis_max"]) == (0, 0)
    assert {k: v for k, v in mix.items()
            if k not in ("name", "why", "widths", "covis_radius",
                         "covis_max")} == {
        k: v for k, v in covis.items()
        if k not in ("name", "why", "widths", "covis_radius", "covis_max")}
    # 151 sets of 466 maps; 21 of 3,499, as the stereo refine cell's
    assert max(2, math.ceil(mix["pool_maps"] / 466)) == 151
    assert max(2, math.ceil(covis["pool_maps"] / cfg["maps"])) == 21
    for cell in CELLS:
        assert {m["name"] for m in b.metrics(cell, False)} == {
            "maps_joined_per_s", "setup_s"}


def test_metrics_declared_with_their_cells():
    b = run.Bench()
    spec = {m["name"]: m for m in b.spec["per_layer"]}
    for name, layer, better in zip(METRICS, ("level driver", "kernels"),
                                   ("lower", "higher")):
        m = spec[name]
        assert m["workloads"] == ["rs468_mono.covis",
                                  "nc3500_stereo_direct.covis"]
        assert (m["unit"], m["better"], m["layer"], m["moves"]) == (
            "%", better, layer, "maps_joined_per_s")
    names = {c: {m["name"] for m in b.metrics(c, True)}
             for c in CELLS + ("rs468_mono.covis",)}
    assert "mono_gauge_pct" not in names["nc3500_stereo_direct.covis"]
    for c in names:
        assert set(METRICS) <= names[c]
        assert "pcg_sweeps_per_solve" not in names[c]
        # every accepted per-layer metric without a list of cells
        assert {m["name"] for m in b.spec["per_layer"]
                if "workloads" not in m} <= names[c]


def _sums(a):
    """What the solver sums over the lanes of one assembly of shape a."""
    return dict(schur_f64_ku=a["P"] * a["KU"], schur_f64_kw=a["P"] * a["KW"],
                schur_f64_m=a["P"] * a["M"], schur_f64_n=a["P"] * a["N"],
                schur_f64_m2=a["P"] * a["M"] ** 2)


def _solves(parts, shape=ROOT_SHAPE):
    """A traced solve (left out by the readers) and two plain ones, each
    with one assembly of `shape` taking `parts` seconds of the card."""
    return [dict(wall=w, ok=True, traced=traced,
                 timing=dict(PARENT, schur_f64_s=p, **_sums(shape)))
            for w, p, traced in zip((2.0, 4.0, 4.0), parts,
                                    (True, False, False))]


def test_least_bytes_by_hand():
    """One lane of 2 poses, 3 landmarks, 4 U entries, 5 W entries: U 4 x
    (36 x 8 + 2 x 4), W and Y 5 x (2 x 18 x 8 + 2 x 4), eP and E 12 x 8
    each, eF 9 x 8, S 12 x 12 x 8 bytes."""
    want = (4 * 296 + 5 * 296 + 2 * 12 * 8 + 9 * 8 + 144 * 8)
    assert want == 4080
    assert roofline_schur.least_bytes(4, 5, 2, 3, 4) == want
    t = _sums(dict(P=1, M=2, N=3, KU=4, KW=5))
    assert roofline_schur.timing_bytes(t) == want
    # two such lanes, twice the bytes; a solver without the sums, None
    assert roofline_schur.timing_bytes(
        _sums(dict(P=2, M=2, N=3, KU=4, KW=5))) == 2 * want
    assert roofline_schur.timing_bytes(PARENT) is None


def test_schur_f64_pct():
    read = run.Bench().reader("schur_f64_pct")
    # the traced solve is left out: (1 + 3) / 8
    assert read(_run(_solves((2.0, 1.0, 3.0)))) == pytest.approx(50.0)
    parent = [dict(wall=4.0, ok=True, traced=False, timing=dict(PARENT))]
    assert read(_run(parent)) is None
    # a refine solve forms no float64 Schur matrix: nothing read
    assert read(_run(_solves((0.0, 0.0, 0.0)))) is None
    assert read(_run([])) is None


def test_schur_f64_roofline_pct():
    read = run.Bench().reader("schur_f64_roofline_pct")
    a = ROOT_SHAPE
    one = roofline_schur.timing_bytes(_sums(a))
    # S alone: 24,576^2 x 8 bytes
    assert one > (6 * a["M"]) ** 2 * 8
    # two plain solves, one assembly each, 1 + 3 s of the card
    want = 100.0 * 2 * one / roofline.HBM_BYTES_PER_S / 4.0
    assert read(_run(_solves((2.0, 1.0, 3.0)))) == pytest.approx(want)
    parent = [dict(wall=4.0, ok=True, traced=False, timing=dict(PARENT))]
    assert read(_run(parent)) is None
    assert read(_run(_solves((0.0, 0.0, 0.0)))) is None
    assert read(_run([])) is None


@pytest.mark.parametrize("control_run", [False, True],
                         ids=["program", "reference_f32"])
@pytest.mark.parametrize("workload", CELLS)
def test_cells_run_on_the_cpu(tiny, workload, control_run):
    """Each cell's run on the CPU at a small size: correct, and incorrect
    with the float32 reference in the program's place (the direct method
    has no float32 path of its own)."""
    import torch
    torch.set_num_threads(1)
    bench = run.Bench(tiny)
    res, lines = run.run_cell(
        bench, workload, 2**31 + 77, 2.0, False, device="cpu",
        solver_factory=control.ReferenceF32 if control_run else None)
    assert res["attempted"] >= 2
    assert res["correct"] is not control_run, lines
    assert res["failed"] == 0
