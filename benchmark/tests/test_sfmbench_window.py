"""The window's arithmetic on a fabricated timeline, and the per-layer
readers on fabricated solves and sessions."""

import math
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import run


def _out(bad=False):
    poses = torch.zeros(3, 6)
    if bad:
        poses[1, 2] = float("nan")
    return SimpleNamespace(pose_ids=torch.tensor([0, 1, -1]), poses=poses,
                           feat_ids=torch.tensor([5, -1]),
                           feats=torch.zeros(2, 3))


class FakeSolver:
    """Each run advances the fake clock by the next wall."""

    def __init__(self, clock, walls, bad=()):
        self.clock, self.walls, self.calls = clock, list(walls), []
        self.bad = set(bad)

    def run(self, maps):
        self.calls.append(maps)
        w = self.walls.pop(0)
        self._last_timing = dict(compact=0.1 * w, plan=0.3 * w,
                                 upload=0.05 * w, levels=0.5 * w, get=0.0)
        self.clock[0] += w
        return _out(len(self.calls) - 1 in self.bad)


def _window(solver, pool, seconds, keep=2):
    return run.run_window(solver, pool, seconds, lambda: None, keep,
                          np.random.default_rng(0))


@pytest.fixture
def clock(monkeypatch):
    t = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: t[0])
    return t


def test_window_ends_with_whole_solve(clock):
    walls = [2.0, 3.0, 4.0, 5.0, 6.0]
    s = FakeSolver(clock, walls)
    solves, kept, sessions = _window(s, ["a", "b", "c"], 8.0)
    # 2 + 3 = 5 < 8, 2 + 3 + 4 = 9 >= 8: the third solve ends the window
    assert [x["wall"] for x in solves] == [2.0, 3.0, 4.0]
    assert s.calls == ["a", "b", "c"]
    assert not any(x["repeated"] for x in solves)
    assert sessions == []


def test_window_repeats_a_used_up_pool(clock):
    s = FakeSolver(clock, [1.0] * 5)
    solves, _, _ = _window(s, ["a", "b"], 2.5)
    assert s.calls == ["a", "b", "a"]
    assert [x["repeated"] for x in solves] == [False, False, True]


def test_reservoir_keeps_a_few_and_flags_every_solve(clock):
    s = FakeSolver(clock, [1.0] * 30, bad=(4,))
    solves, kept, _ = _window(s, ["a"], 19.5, keep=3)
    assert len(solves) == 20
    assert len(kept) == 3 and set(kept) <= set(range(20))
    flags = [bool(x["flag"]) for x in solves]
    assert flags == [i != 4 for i in range(20)]


def test_end_to_end_metrics():
    solves = [dict(start=10.0, end=12.0, wall=2.0),
              dict(start=12.5, end=14.0, wall=1.5),
              dict(start=14.0, end=20.0, wall=6.0)]
    e = run.end_to_end(solves, 101)
    # all the work over all the time, gaps between solves included
    assert e["maps_joined_per_s"] == pytest.approx(3 * 100 / 10.0)
    assert e["solve_s_p95"] == 6.0


@pytest.mark.parametrize("n,q,want", [(20, 0.95, 19), (21, 0.95, 20),
                                      (100, 0.95, 95), (1, 0.95, 1),
                                      (10, 0.5, 5)])
def test_nearest_rank(n, q, want):
    assert run.nearest_rank(list(range(n, 0, -1)), q) == want


def _run(solves, sessions=()):
    return run.Run({}, {}, {}, solves, list(sessions))


def test_host_shares():
    b = run.Bench()
    solves = [dict(wall=2.0, ok=True, traced=True,
                   timing=dict(compact=1.0, plan=1.0, upload=0, levels=0)),
              dict(wall=4.0, ok=True, traced=False,
                   timing=dict(compact=0.5, plan=1.5, upload=0.2,
                               levels=1.8)),
              dict(wall=4.0, ok=True, traced=False,
                   timing=dict(compact=0.5, plan=0.5, upload=0.0,
                               levels=3.0))]
    r = _run(solves)
    # the traced solve is left out: (2 + 1) / 8 and (2 + 3) / 8
    assert b.reader("ingest_plan_pct")(r) == pytest.approx(37.5)
    assert b.reader("levels_pct")(r) == pytest.approx(62.5)


def test_device_readers():
    b = run.Bench()
    s1 = dict(wall_s=2.0, busy_s=0.5, k1_s=0.01, k3_s=0.02,
              bytes=([3.35e9, 3.35e9], [3.35e9]))
    s2 = dict(wall_s=2.0, busy_s=1.5, k1_s=0.03, k3_s=0.02,
              bytes=([6.7e9], []))
    r = _run([], [s1, s2])
    assert b.reader("device_idle_pct")(r) == pytest.approx(50.0)
    # 4 ms of least time over 40 ms; 1 ms over 40 ms
    assert b.reader("k1_roofline_pct")(r) == pytest.approx(10.0)
    assert b.reader("k3_roofline_pct")(r) == pytest.approx(2.5)
    # nothing to read: no value, never 0
    empty = _run([], [dict(wall_s=1.0, busy_s=1.0, k1_s=0.0, k3_s=0.0,
                           bytes=([], []))])
    assert b.reader("k1_roofline_pct")(empty) is None
    assert b.reader("k3_roofline_pct")(empty) is None
    assert b.reader("device_idle_pct")(_run([], [])) is None
    assert math.isclose(b.reader("device_idle_pct")(empty), 0.0)


def test_breakdown_orders_and_caps():
    sess = [dict(kernels={f"k{i}": float(i) for i in range(12)},
                 gaps=[("levels", 0.5), ("ingest_plan", 2.0)]),
            dict(kernels={"k0": 20.0}, gaps=[("solve", 1.0)])]
    b = run.breakdown(sess)
    assert b["device_ops"][0] == ["k0", 20.0]
    assert len(b["device_ops"]) == 10
    assert b["idle_gaps"] == [["ingest_plan", 2.0], ["solve", 1.0],
                              ["levels", 0.5]]


class _Recorder:
    def __init__(self, k1_counts):
        self.k1_counts = list(k1_counts)
        self.kernels = SimpleNamespace(launches={"seg_sum_fixed": 0})

    def take_bytes(self):
        return [100] * self.k1_counts.pop(0), [50]


def _events(n_k1, lost=False):
    ev = [{"cat": "user_annotation", "ph": "X", "name": "solve", "ts": 0,
           "dur": 100}]
    for i in range(n_k1):
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": 1 + i, "args": {"correlation": i}})
        if not (lost and i == 0):
            ev.append({"ph": "X", "cat": "kernel",
                       "name": "blockcoo_dense_kernel<float>", "ts": 10 + i,
                       "dur": 1, "args": {"correlation": i}})
    return ev


@pytest.mark.parametrize("case,want", [("ok", [0]), ("lost", [1]),
                                       ("count", [1]), ("k3", [1])])
def test_traced_solve_dropped_when_its_trace_is_short(clock, monkeypatch,
                                                      case, want):
    """A traced solve whose trace lost a device record, whose K1 kernels
    in the trace are not the launches recorded, or whose K3 launches (the
    program's counter) are not those recorded, is dropped and the next
    solve profiled instead."""
    from benchmark import trace
    n = iter([(2, case == "lost", 2 if case == "k3" else 1), (2, False, 1),
              (2, False, 1)])

    def profile(recorder, solve):
        k, lost, k3 = next(n)
        recorder.kernels.launches["seg_sum_fixed"] += k3
        return solve(), _events(k, lost), 0

    monkeypatch.setattr(trace, "profile_solve", profile)
    rec = _Recorder([3 if case == "count" else 2, 2, 2])
    s = FakeSolver(clock, [1.0] * 5)
    solves, _, sessions = run.run_window(s, ["a"], 3.5, lambda: None, 1,
                                         np.random.default_rng(0), rec)
    assert [x["solve"] for x in sessions] == want
    assert [x["traced"] for x in solves] == [i in want for i in range(4)]
    assert sessions[0]["bytes"] == ([100, 100], [50])
    assert sessions[0]["k1_launches"] == 2


def test_host_line_reads_deltas():
    a = dict(cpu_s=1.0, nivcsw=3, cores=[0, 1], ticks=1000, idle=800,
             steal=10, load1=0.5, mhz=2000.0)
    b = dict(a, cpu_s=50.0, nivcsw=5, ticks=2000, idle=1500, steal=30)
    line = run.host_line(a, b, 51.0)
    assert "on the CPU 49.00 s of 51.00 s" in line
    assert "involuntary switches 2" in line
    assert "machine busy 30.0%" in line and "steal 2.00%" in line
    # a host whose /proc/stat cannot be read: those readings left out
    a2 = {k: v for k, v in a.items() if k not in ("ticks", "idle", "steal")}
    assert "steal" not in run.host_line(a2, b, 51.0)
    assert set(run.host_sample()) >= {"cpu_s", "nivcsw", "cores"}
