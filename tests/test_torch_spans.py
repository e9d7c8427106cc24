"""The spans and counts of a device-executor solve (`utils/metrics`), on
the CPU: the span tree each `DeviceTreeSolver.run` records, the numbers it
leaves in `_last_timing`, and the profiler ranges the spans open only while
a torch.profiler session records (they must not change the fused map)."""

import json
import numbers

import pytest
import torch

from synth import generate as gen
from linearsfm_tpu_torch import types
from linearsfm_tpu_torch.core import pipeline as tpipeline
from linearsfm_tpu_torch.core.device_tree import SELF_TIMED, DeviceTreeSolver
from linearsfm_tpu_torch.io import localmap as tio
from linearsfm_tpu_torch.ops import kernels, segment
from linearsfm_tpu_torch.utils import metrics
from linearsfm_tpu_torch.utils.metrics import LevelMetrics

# one intra-op thread: the suite's workers share the machine's cores
torch.set_num_threads(1)

OLD_KEYS = ("compact", "plan", "upload", "levels", "get")
COUNTS = ("pcg_sweeps", "pcg_escalations", "syncs", "k1_launches",
          "k2_launches", "k3_launches", "k4_launches", "k5_launches",
          "k3_plans", "k3_plan_hits")
# each span name's possible parents (None: the solve itself)
PARENTS = {"ingest_plan": {None}, "plan_tree": {"ingest_plan"},
           "upload": {None}, "levels": {None}, "level": {"levels"},
           "transform": {"level"}, "join": {"level"},
           "sync": {"join", "levels"}, "regauge_compact": {"level", "final"},
           "final": {"levels"}, "mono_gauge": {"join"}}
# spans that only a mono join opens
MONO_ONLY = {"mono_gauge"}
# stereo refine below the top band (fixed trips), stereo refine with the
# top band's early exit and escalation test from 16 joined poses, mono
# direct (no PCG), mono refine with the top band from 16 joined poses (the
# PCG with the scale pin)
CASES = {"stereo_refine": ("stereo", dict(method="refine")),
         "stereo_top": ("stereo", dict(method="refine", top_min_m=16)),
         "mono_direct": ("mono", dict(method="direct")),
         "mono_top": ("mono", dict(method="refine", top_min_m=16))}


def _maps(datatype, n=24):
    return gen.make_dataset(n, datatype, noise=0.01, seed=3,
                            covis_radius=3.0, covis_max=4)[0]


def _solver(case):
    datatype, kw = CASES[case]
    return DeviceTreeSolver(datatype, device="cpu", **kw)


@pytest.fixture(scope="module")
def solved():
    """case -> (solver after one run, its maps, the run's output)."""
    out = {}
    for case, (datatype, _) in CASES.items():
        maps = _maps(datatype)
        s = _solver(case)
        out[case] = (s, maps, s.run(maps))
    return out


def _children(spans, i):
    return [s for s in spans if s["parent"] == i]


@pytest.mark.parametrize("case", sorted(CASES))
def test_span_tree_nests_as_documented(solved, case):
    s, maps, _ = solved[case]
    spans = s.last_spans
    names = [sp["name"] for sp in spans]
    assert len({sp["solve"] for sp in spans}) == 1
    for sp in spans:
        par = None if sp["parent"] is None else spans[sp["parent"]]
        assert (None if par is None else par["name"]) in PARENTS[sp["name"]]
        assert sp["start"] <= sp["end"]
        if par is not None:
            assert par["start"] <= sp["start"] and sp["end"] <= par["end"]
    # one level span per plan level, in order, each with its attributes
    tp, _ = s.prepare(maps)
    levels = [sp["attrs"] for sp in spans if sp["name"] == "level"]
    assert [a["level"] for a in levels] == list(range(1, len(tp.levels) + 1))
    assert [a["count"] for a in levels] == [lp.count for lp in tp.levels]
    assert [a["join_m"] for a in levels] == [lp.join_m for lp in tp.levels]
    assert all(a["mode"] == "single" and a["device_wall"] > 0
               and a["memory_allocated"] is None for a in levels)
    assert names.count("transform") == names.count("join") == len(levels)
    assert names.count("final") == names.count("plan_tree") == 1
    assert names.count("regauge_compact") >= len(levels) + 1
    # the spans cover the levels: their self times sum to at most levels
    (lv,) = [sp for sp in spans if sp["name"] == "levels"]
    own = metrics.self_seconds(spans)
    assert (sum(own.get(k, 0.0) for k in ("level",) + SELF_TIMED
                if k != "plan_tree")
            <= (lv["end"] - lv["start"]) * 1e-9 + 1e-9)
    # the closing synchronise is the levels span's last child
    assert _children(spans, spans.index(lv))[-1]["name"] == "sync"


@pytest.mark.parametrize("case", sorted(CASES))
def test_last_timing_holds_old_and_new_numbers(solved, case):
    s, _, _ = solved[case]
    t = s._last_timing
    assert set(t) == set(OLD_KEYS) | set(SELF_TIMED) | set(COUNTS)
    assert all(isinstance(v, numbers.Real) and not isinstance(v, bool)
               for v in t.values())
    assert t["plan_tree"] <= t["plan"]
    own = metrics.self_seconds(s.last_spans)
    assert all(t[k] == own.get(k, 0.0) for k in SELF_TIMED)
    assert t["syncs"] == sum(sp["name"] == "sync" for sp in s.last_spans)
    # the CPU launches no kernel, and sums no list through K3's plans
    assert (t["k1_launches"] == t["k2_launches"] == t["k3_launches"]
            == t["k4_launches"] == t["k5_launches"] == 0)
    assert t["k3_plans"] == t["k3_plan_hits"] == 0


def test_pcg_sweeps_are_the_plans_fixed_trips(solved):
    s, maps, _ = solved["stereo_refine"]
    tp, _ = s.prepare(maps)
    assert all(lp.join_m < s.top_min_m for lp in tp.levels)
    # one batched PCG per level, refine_iters sweeps, no read of a flag
    assert s._last_timing["pcg_sweeps"] == s.refine_iters * len(tp.levels)
    assert s._last_timing["pcg_escalations"] == 0
    assert s._last_timing["syncs"] == 1
    joins = [sp for sp in s.last_spans if sp["name"] == "join"]
    assert all(sp["attrs"] == {"pcg_sweeps": s.refine_iters} for sp in joins)
    m, _, _ = solved["mono_direct"]
    assert m._last_timing["pcg_sweeps"] == 0 and m._last_timing["syncs"] == 1


def test_pcg_sweeps_follow_the_exit_tests(solved):
    """Top-band joins read a flag before every sweep and once after the
    last (exit test), then once more (escalation test), and an escalation
    runs top_iters sweeps more."""
    s, maps, _ = solved["stereo_top"]
    spans = s.last_spans
    tp, _ = s.prepare(maps)
    top = sum(lp.join_m >= s.top_min_m for lp in tp.levels)
    assert top >= 1
    total = 0
    for i, sp in enumerate(spans):
        if sp["name"] != "join":
            continue
        reads = sum(c["name"] == "sync" for c in _children(spans, i))
        a = sp["attrs"]
        esc = a.get("pcg_escalations", 0)
        if reads:
            assert a["pcg_sweeps"] == reads - 2 + esc * s.top_iters
        else:
            assert a == {"pcg_sweeps": s.refine_iters}
        total += a["pcg_sweeps"]
    assert s._last_timing["pcg_sweeps"] == total
    assert s._last_timing["syncs"] > 1 + top


@pytest.mark.parametrize("case", sorted(CASES))
def test_mono_gauge_span(solved, case):
    """A mono join opens one `mono_gauge` span, inside it and before its
    solve's first blocking read, whose self seconds `_last_timing` sums;
    a stereo join opens none, and `_last_timing` holds 0 for it."""
    s, _, _ = solved[case]
    spans = s.last_spans
    joins = [i for i, sp in enumerate(spans) if sp["name"] == "join"]
    gauges = [i for i, sp in enumerate(spans) if sp["name"] == "mono_gauge"]
    if CASES[case][0] == "stereo":
        assert gauges == [] and s._last_timing["mono_gauge"] == 0.0
        return
    assert [spans[i]["parent"] for i in gauges] == joins
    for i in gauges:
        assert spans[i]["attrs"] == {}
        kids = _children(spans, spans[i]["parent"])
        assert kids[0] is spans[i]
    own = metrics.self_seconds(spans)
    assert s._last_timing["mono_gauge"] == own["mono_gauge"] > 0
    # the join's self time leaves the gauge's out
    whole = sum(spans[i]["end"] - spans[i]["start"] for i in joins) * 1e-9
    assert own["join"] + own["mono_gauge"] <= whole + 1e-9


def test_k3_plan_counts(monkeypatch):
    """With the K3 route forced on the CPU, every plan `segment._plan`
    builds or reuses is counted, hits and misses apart."""
    monkeypatch.setattr(segment, "_k3", lambda x: segment._fixed > 0
                        and x.is_floating_point())
    built = []
    seg_plan = kernels.seg_plan
    monkeypatch.setattr(kernels, "seg_plan",
                        lambda idx, num: built.append(1) or seg_plan(idx, num))
    calls = []
    plan = segment._plan
    monkeypatch.setattr(segment, "_plan",
                        lambda idx, num: calls.append(1) or plan(idx, num))
    s = _solver("stereo_refine")
    s.run(_maps("stereo", 12))
    t = s._last_timing
    assert t["k3_plans"] == len(built) > 0
    assert t["k3_plans"] + t["k3_plan_hits"] == len(calls)
    assert t["k3_plan_hits"] > 0


def test_two_runs_count_alike_and_keep_apart():
    s = _solver("stereo_top")
    maps = _maps("stereo", 12)
    s.run(maps)
    t1, spans1 = s._last_timing, s.last_spans
    s.run(maps)
    t2, spans2 = s._last_timing, s.last_spans
    assert t1 is not t2 and spans1 is not spans2
    assert {k: t1[k] for k in COUNTS} == {k: t2[k] for k in COUNTS}
    assert [sp["name"] for sp in spans1] == [sp["name"] for sp in spans2]
    assert spans1[0]["solve"] != spans2[0]["solve"]


def test_level_records_read_the_level_spans():
    """time_levels' exec_wall is each level span's device wall."""
    s = _solver("mono_direct")
    m = LevelMetrics()
    s.run(_maps("mono", 12), metrics=m, time_levels=True)
    walls = [sp["attrs"]["device_wall"] for sp in s.last_spans
             if sp["name"] == "level"]
    assert [r["exec_wall"] for r in m.records] == walls
    assert all(r["t"] >= 0 for r in m.records)


def _fields(out):
    return [getattr(out, f) for f in types.MAP_FIELDS]


@pytest.mark.parametrize("case", ["stereo_top", "mono_direct"])
def test_profiler_ranges_only_while_recording(monkeypatch, solved, case):
    """No record_function while no profiler records; inside a CPU session
    one per span, and the fused map bit for bit the same."""
    s, maps, want = solved[case]
    opened = []
    rf = torch.profiler.record_function

    def counted(name, *a, **k):
        opened.append(name)
        return rf(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    plain = s.run(maps)
    assert opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = s.run(maps)
    assert opened == [sp["name"] for sp in s.last_spans]
    for a, b, c in zip(_fields(want), _fields(plain), _fields(traced)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_spans_outside_a_solve_are_a_shared_no_op(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        a, b = metrics.span("join"), metrics.span("level", level=1)
        with a as x:
            metrics.count("pcg_sweeps")
    assert a is b and x is None and opened == []
    with metrics.recording() as rec:
        with metrics.recording() as inner:
            metrics.count("syncs")
        metrics.count("syncs", 2)
    assert inner.counts == {"syncs": 1} and rec.counts == {"syncs": 2}


def test_pipeline_trace_holds_the_program_spans(tmp_path):
    maps = _maps("stereo", 6)
    tio.write_dataset(maps, str(tmp_path / "data"))
    tpipeline.run(str(tmp_path / "data"), 6, "stereo", method="refine",
                  progress=False, executor="device", device="cpu",
                  trace_dir=str(tmp_path / "tr"))
    with open(tmp_path / "tr" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    by_name = {}
    for e in ranges:
        by_name.setdefault(e["name"], []).append(e)
    assert set(PARENTS) - MONO_ONLY <= set(by_name)
    assert not MONO_ONLY & set(by_name)

    def inside(child, parent):
        return (parent["ts"] <= child["ts"] and child["ts"] + child["dur"]
                <= parent["ts"] + parent["dur"])
    for child, parent in (("plan_tree", "ingest_plan"), ("level", "levels"),
                          ("transform", "level"), ("join", "level"),
                          ("final", "levels")):
        assert all(any(inside(c, p) for p in by_name[parent])
                   for c in by_name[child]), (child, parent)
    assert len(by_name["level"]) == 3   # 6 maps: levels of 6, 3 and 2 lanes
