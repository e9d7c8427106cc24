"""PyTorch port vs the JAX reference: the tools and the dataset writer.

`compact.stats` and the dataset writers against the JAX package's
(`synth.generate.write_dataset` and `python -m synth.generate` write
through it), `compare_ate` against the tracked oracle binary,
`profile_level_parts.level_parts` against the solver's own level and
merge, `bench_root`'s root assembly against the JAX package's
`schur._assemble_schur_dense`, and every tool's command line on the CPU:
exit 0 with its labelled lines with --cpu, exit 1 without CUDA and without
--cpu. Everything runs on the CPU at small sizes.
"""

import hashlib
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import generate as gen
from test_oracle import _ensure_oracle
from linearsfm_tpu.core import compact as jcompact
from linearsfm_tpu.ops import schur as jschur
from linearsfm_tpu_torch import types
from linearsfm_tpu_torch.core import compact as tcompact
from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
from linearsfm_tpu_torch.io import localmap as tio
from linearsfm_tpu_torch.tools import (bench, bench_root, compare_ate,
                                       generate, measure_baseline, microbench,
                                       profile_dense_tree,
                                       profile_device_tree,
                                       profile_level_parts, profile_tree)

# one intra-op thread: the suite's workers share the machine's cores, and
# an oversubscribed thread pool slows the trees' small ops many times over
torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _oracle():
    """The tracked oracle binary; skips where it cannot execute."""
    path = _ensure_oracle()
    if not os.access(path, os.X_OK):
        pytest.skip(f"{path} is not executable")
    return path


def _tree_bytes(d) -> dict:
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


# ---------------------------------------------------------------------------
# compact.stats and the writers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("datatype,n", [("stereo", 13), ("mono", 11)])
def test_compact_stats_matches_reference(datatype, n):
    maps, _, _ = gen.make_dataset(n, datatype, noise=0.01, seed=5)
    for m in maps:
        want = jcompact.stats(jcompact.compact(m.to_local_map()))
        got = tcompact.stats(tcompact.compact(m))
        assert got == want
        assert all(type(v) is int for v in got.values())


@pytest.mark.parametrize("datatype,covis", [("stereo", False),
                                            ("mono", True)])
def test_write_dataset_matches_reference(tmp_path, datatype, covis):
    cov = dict(covis_radius=6.0, covis_max=6) if covis else {}
    maps, _, _ = gen.make_dataset(9, datatype, noise=0.005, seed=7, **cov)
    gen.write_dataset(maps, str(tmp_path / "jax"))
    tio.write_dataset(maps, str(tmp_path / "port"))
    want = _tree_bytes(tmp_path / "jax")
    assert len(want) == 9
    assert _tree_bytes(tmp_path / "port") == want


@pytest.mark.parametrize("flags", [
    ["--num", "7", "--type", "stereo", "--noise", "0.01", "--seed", "3"],
    ["--num", "6", "--type", "mono", "--noise", "0.005", "--seed", "7",
     "--covis-radius", "6", "--covis-max", "6", "--pattern", "grid",
     "--feats", "5"]])
def test_generate_matches_synth_generate(tmp_path, monkeypatch, capsys,
                                         flags):
    monkeypatch.setattr(sys, "argv", ["synth.generate", *flags, "--out",
                                      str(tmp_path / "jax")])
    gen.main()
    want_line = capsys.readouterr().out
    assert generate.main([*flags, "--out", str(tmp_path / "port")]) == 0
    got_line = capsys.readouterr().out
    assert got_line.replace(str(tmp_path / "port"),
                            str(tmp_path / "jax")) == want_line
    want = _tree_bytes(tmp_path / "jax")
    assert "gt_poses.txt" in want
    assert _tree_bytes(tmp_path / "port") == want


# ---------------------------------------------------------------------------
# compare_ate and measure_baseline against the oracle binary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("datatype,split", [("stereo", False),
                                            ("mono", False),
                                            ("stereo", True)])
def test_compare_ate_against_oracle(tmp_path, capsys, datatype, split):
    """32 covis maps through the oracle and the port's device executor
    (refine) on the CPU: the record's ATE within 1e-6 of the oracle's, the
    pose files within 1e-5; also as an oracle phase and a port phase."""
    _oracle()
    rec_path = tmp_path / "rec.json"
    base = ["--num", "32", "--type", datatype, "--covis", "--cpu",
            "--dir", str(tmp_path / "d"), "--json", str(rec_path)]
    if split:
        assert compare_ate.main(base + ["--phase", "oracle"]) == 0
        assert not rec_path.exists()
        assert compare_ate.main(base + ["--phase", "port"]) == 0
    else:
        assert compare_ate.main(base) == 0
    out = capsys.readouterr().out
    for label in ("oracle wall:", "port wall:", "pose diff vs oracle:",
                  "ATE vs gt: oracle"):
        assert label in out
    rec = json.loads(rec_path.read_text())
    assert rec["n_poses"] == (32 if datatype == "stereo" else 34)
    assert rec["nonfinite_port"] == 0 and rec["nonfinite_oracle"] == 0
    assert abs(rec["ate_port"] - rec["ate_oracle"]) <= 1e-6
    assert rec["pose_diff_max"] <= 1e-5
    assert {"port_wall_s", "oracle_wall_s"} <= set(rec)


def test_compare_ate_fails_without_oracle(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(compare_ate, "ORACLE", str(tmp_path / "missing"))
    assert compare_ate.main(["--num", "4", "--cpu", "--dir",
                             str(tmp_path / "d")]) == 1
    assert "did not run" in capsys.readouterr().err


def test_measure_baseline_keys(tmp_path, capsys):
    """Two small covis sizes, both types, into --json; the root
    baseline_measured.json is left as it was."""
    _oracle()
    root = os.path.join(REPO, "baseline_measured.json")
    before = hashlib.sha256(open(root, "rb").read()).hexdigest()
    path = tmp_path / "out" / "bm.json"
    args = ["--covis", "--sizes", "8,16", "--json", str(path)]
    assert measure_baseline.main(args) == 0
    data = json.loads(path.read_text())
    for t in ("stereo", "mono"):
        for n in (8, 16):
            for k in ("maps_per_s", "wall_s", "solve_s"):
                assert data[f"{t}_covis_{k}_{n}"] > 0
    assert measure_baseline.main(args) == 0     # every key is there: skips
    assert capsys.readouterr().out.count("skip ") == 4
    assert hashlib.sha256(open(root, "rb").read()).hexdigest() == before


# ---------------------------------------------------------------------------
# level_parts and the root assembly against what they time
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("datatype", ["stereo", "mono"])
def test_level_parts_match_solver(datatype):
    """(full) is the solver's own level and (TJ) its `_merge`, on the input
    the solver builds: poses within 1e-12."""
    maps, _, _ = gen.make_dataset(16, datatype, noise=0.005, seed=7)
    solver = DeviceTreeSolver(datatype, method="refine", device="cpu")
    parts = profile_level_parts.level_parts(solver, maps, [2, 4])
    assert sorted(parts) == [2, 4]
    tp, x = solver.prepare(maps)
    for li, lp in enumerate(tp.levels, start=1):
        if li in parts:
            rec = parts[li]
            assert rec["count"] == lp.count and rec["caps_in"] == lp.caps_in
            assert all(rec[k] > 0 for k in ("T", "TJ", "full"))
            npair = lp.count // 2
            full = solver._level(x, lp)[0].poses.numpy()
            tj = solver._merge(types.lanes(x, slice(0, 2 * npair, 2)),
                               types.lanes(x, slice(1, 2 * npair, 2)),
                               solver._level_cfg(lp))[0].poses.numpy()
            np.testing.assert_allclose(rec["poses"]["full"], full, rtol=0,
                                       atol=1e-12)
            np.testing.assert_allclose(rec["poses"]["TJ"], tj, rtol=0,
                                       atol=1e-12)
            assert rec["poses"]["T"].shape[0] == npair
        if li == 4:
            break
        x = solver._level(x, lp)[0]


def test_level_parts_every_level_by_default():
    """Without `levels`, every level of the solver's plan is split."""
    maps, _, _ = gen.make_dataset(8, "stereo", noise=0.005, seed=7)
    solver = DeviceTreeSolver("stereo", method="refine", device="cpu")
    parts = profile_level_parts.level_parts(solver, maps)
    nlev = len(solver.prepare(maps)[0].levels)
    assert sorted(parts) == list(range(1, nlev + 1))
    assert all(parts[li]["full"] > 0 for li in parts)


def test_bench_root_assembly_matches_reference(capsys):
    """bench_root's dense Schur assembly at the 32-map stereo root against
    the JAX package's `_assemble_schur_dense` on the same joined map (with
    the JAX inverse and information vector), rtol 1e-10."""
    maps, _, _ = gen.make_dataset(32, "stereo", noise=0.005, seed=7)
    solver = DeviceTreeSolver("stereo", method="refine", device="cpu")
    got = bench_root.root_parts(solver, maps)
    out = capsys.readouterr().out
    for label in ("root caps:", "transform (root, f64)",
                  "join incl solve (root)", "assemble dense S (root, f64)",
                  "solve refine (root)", "solve f32 (root)",
                  "dcompact (root)", "matmul f64 Yd@Wd.T only",
                  "matmul f32 Yd@Wd.T only"):
        assert label in out
    j = types.to_numpy(types.lanes(got["joined"], 0))
    assert j.U.dtype == np.float64
    Vinv = jschur.inv3x3_sym(jnp.asarray(j.V))
    eP, eF = jschur.info_vector(*(jnp.asarray(a) for a in (
        j.poses, j.feats, j.U, j.Uij, j.W, j.Wpf, j.V)))
    S, E = jschur._assemble_schur_dense(
        jnp.asarray(j.U), jnp.asarray(j.Uij), jnp.asarray(j.W),
        jnp.asarray(j.Wpf), Vinv, eP, eF, j.M)
    S, E = np.asarray(S), np.asarray(E)
    tS, tE = got["S"][0].numpy(), got["E"][0].numpy()
    assert tS.shape == S.shape == (6 * j.M, 6 * j.M)
    np.testing.assert_allclose(tS, S, rtol=1e-10,
                               atol=1e-10 * np.abs(S).max())
    np.testing.assert_allclose(tE, E, rtol=1e-10,
                               atol=1e-10 * np.abs(E).max())


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool,argv,labels", [
    (profile_level_parts, ["32", "3", "mono"],
     ["L3: count=", "T   (transform)", "TJ  (transform+join/solve)",
      "full (level program)"]),
    (profile_device_tree, ["24", "stereo", "refine"],
     ["dataset ready (24 stereo)", "cold:", "warm:", "warm2:", "timing=",
      "L 1 count=", "L 5 count="]),
    (profile_tree, ["24", "mono"],
     ["dataset ready (24 mono maps)", "cold L 1 npair=", "warm L 5 npair=",
      "regauge+compact=", "map0={'M':", "warm done", "WARM TOTAL:"]),
    (bench_root, ["20"], ["root caps:", "dcompact (root)"]),
    (microbench, ["8", "8", "8", "16", "16", "4"],
     ["B=8 M=8 N=8 KU=16 KW=16 O=4  (D=48)", "cholesky f64", "cho+2tri f32",
      "S scatter-add f64", "S one-hot einsum f32",
      "group_by_feature+pairprod f64", "segment_sum eP f64",
      "argsort [KW] x B", "congruence einsum f64"]),
])
def test_tool_runs_on_cpu(capsys, tool, argv, labels):
    assert tool.main(argv + ["--cpu"]) == 0
    out = capsys.readouterr().out
    for label in labels:
        assert label in out, (label, out)


@pytest.mark.parametrize("tool,argv", [
    (compare_ate, ["--num", "4"]), (profile_level_parts, ["8", "1"]),
    (profile_device_tree, ["8"]), (profile_tree, ["8"]),
    (bench_root, ["8"]), (microbench, ["2", "2", "2", "4", "4", "2"]),
    (profile_dense_tree, ["--maps", "8"]), (bench, [])])
def test_tool_without_cuda_exits_1(monkeypatch, capsys, tool, argv):
    """Without CUDA and without --cpu a tool exits 1 and never moves to the
    CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(argv) == 1
    captured = capsys.readouterr()
    assert "no CUDA device (pass --cpu)" in captured.err
    assert captured.out == ""


# ---------------------------------------------------------------------------
# the profilers' totals need every device record
# ---------------------------------------------------------------------------

def _trace(tmp_path, events, drop=None):
    """A torch.profiler-style Chrome trace: `events` are (cat, name, ts,
    dur, correlation or None); the device event of correlation `drop` is
    left out, as the profiler loses records, and so is the range named
    `drop`."""
    ev = []
    for cat, name, ts, dur, corr in events:
        if (cat in ("kernel", "gpu_memset") and corr == drop) or name == drop:
            continue
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        ev.append(e)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


_K1_TRACE = [
    ("user_annotation", "level1", 0, 1000, None),
    ("user_annotation", "k1/blockcoo_to_dense_planned", 10, 40, None),
    ("cuda_runtime", "cudaLaunchKernel", 20, 2, 1),
    ("kernel", "blockcoo_dense_kernel<float>", 100, 5, 1),
    ("cuda_runtime", "cudaMemsetAsync", 30, 2, 4),
    ("gpu_memset", "Memset (Device)", 90, 1, 4),
    ("user_annotation", "k2/inv3x3_wy", 60, 20, None),
    ("cuda_runtime", "cudaLaunchKernel", 65, 2, 3),
    ("kernel", "inv3x3_wy_kernel<float>", 150, 3, 3),
    ("user_annotation", "schur/assemble", 200, 200, None),
    ("cuda_runtime", "cuLaunchKernel", 210, 2, 2),
    ("kernel", "gemm", 300, 7, 2),
]


@pytest.mark.parametrize("drop", [None, 2, 4], ids=["complete", "kernel",
                                                    "fill"])
def test_profile_k1_totals_need_every_device_record(tmp_path, monkeypatch,
                                                    drop):
    """`profile_k1._analyse` sums K1, the assembly, the Y sites, the
    wrappers' kernels, busy time and span from a trace in which every
    launch and fill has its device record, and raises, naming both counts,
    when one is missing."""
    from linearsfm_tpu_torch.tools import profile_k1
    monkeypatch.setattr(profile_k1, "_out_bytes", [4096])
    monkeypatch.setattr(profile_k1, "_k2_launches", [dict(
        fn="inv3x3_wy", P=1, N=2, K=3, dtype="float32", bytes=1000,
        level=1)])
    labels = [dict(level=1, operand="A", stripe=None, stripes=0)]
    trace = _trace(tmp_path, _K1_TRACE, drop)
    if drop is not None:
        with pytest.raises(profile_k1.LostRecords,
                           match="4 kernel launches, fills and copies "
                                 "issued, 3 with a device record"):
            profile_k1._analyse(trace, labels)
        return
    rep = profile_k1._analyse(trace, labels)
    assert rep["k1_us"] == 5 and rep["k2_us"] == 3
    assert rep["assembly_us"] == 7
    assert rep["y_sites_us"] == 3                 # K2, before the assembly
    assert [(w["kernel"], w["us"]) for w in rep["wrapper_kernels"]] == [
        ("Memset (Device)", 1)]
    assert rep["busy_us"] == 16 and rep["span_us"] == 217
    assert profile_k1.record_counts(trace) == (4, 4)


_SUM_TRACE = [
    ("cuda_runtime", "cudaLaunchKernel", -20, 1, 16),  # a warm-up fill
    ("kernel", "fill_kernel", -15, 1, 16),
    ("user_annotation", "order/run", 0, 300, None),
    ("cpu_op", "aten::index_add_", 0, 20, None),
    ("cuda_runtime", "cudaLaunchKernel", 5, 1, 10),
    ("kernel", "index_add_kernel", 200, 4, 10),
    ("cpu_op", "aten::sort", 30, 30, None),
    ("cuda_runtime", "cudaLaunchKernel", 40, 1, 11),
    ("kernel", "radix_sort", 210, 6, 11),
    ("user_annotation", "k3/ops/schur.py:82", 70, 20, None),
    ("cuda_runtime", "cudaLaunchKernel", 75, 1, 12),
    ("kernel", "void (anonymous namespace)::seg_sum_direct<double, false>",
     220, 5, 12),
    ("cuda_runtime", "cudaLaunchKernelExC", 77, 1, 15),
    ("kernel", "void (anonymous namespace)::seg_sum_ring<double, false>",
     226, 4, 15),
    ("user_annotation", "k3/ops/schur.py:513", 100, 20, None),
    ("cuda_runtime", "cudaLaunchKernel", 105, 1, 13),
    ("kernel", "void (anonymous namespace)::seg_sum_direct<double, false>",
     240, 11, 13),
    ("cpu_op", "aten::fill_", 130, 10, None),
    ("cuda_runtime", "cudaLaunchKernel", 132, 1, 14),
    ("kernel", "fill_kernel", 260, 2, 14),
]


@pytest.mark.parametrize("drop", [None, 16, 13, "k3/ops/schur.py:513"],
                         ids=["complete", "before the run", "missing",
                              "k3 range missing"])
def test_direct_paths_totals_need_every_device_record(tmp_path, drop):
    """`direct_paths._trace_totals` (the --profile totals) gives each
    sum op's calls, host and device time, K3's device time and each K3
    call site's from a trace in which every launch of the profiled run
    (its "order/run" range on) has its device record, and raises, naming
    both counts, when one is missing; a record lost before the run (the
    session's warm-up fills) does not count. `_k3_census` groups the calls
    by site with their longest segment and byte bound, and raises, naming
    both counts, when a call's "k3/<site>" range is missing."""
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.tools import direct_paths, profile_k1
    trace = _trace(tmp_path, _SUM_TRACE, drop)
    if drop == 13:
        with pytest.raises(profile_k1.LostRecords,
                           match="6 kernel launches, fills and copies "
                                 "issued, 5 with a device record"):
            direct_paths._trace_totals(trace)
        return
    tot = direct_paths._trace_totals(trace)
    idx = torch.tensor([[0, 0, 0, 2, 5], [1, 1, -1, 3, 3]])
    plan = kernels.seg_plan(idx, 4)
    calls = [dict(site=s, P=2, K=5, num=4, tail=(6,), dtype="float64",
                  esz=8, into=False, launched=True, off=plan.off)
             for s in ("ops/schur.py:82", "ops/schur.py:513")]
    if drop == "k3/ops/schur.py:513":
        assert tot["k3_us"] == [9]
        with pytest.raises(profile_k1.LostRecords,
                           match="2 calls of the wrapper, 1 k3/<site> "
                                 "ranges"):
            direct_paths._k3_census(calls, tot["k3_us"])
        return
    assert tot["aten::index_add_"] == dict(calls=1, device_ms=0.004,
                                           cpu_ms=0.02)
    assert tot["aten::sort"]["device_ms"] == pytest.approx(0.006)
    assert tot["aten::fill_"]["device_ms"] == pytest.approx(0.002)
    assert tot["aten::searchsorted"] == dict(calls=0, device_ms=0.0,
                                             cpu_ms=0.0)
    assert tot["K3"] == dict(calls=2, device_ms=pytest.approx(0.020))
    assert tot["k3_us"] == [9, 11]
    census = direct_paths._k3_census(calls, tot["k3_us"])
    r = census["sites"]["ops/schur.py:513"]
    assert r["launches"] == 1 and r["device_ms"] == pytest.approx(0.011)
    assert r["longest"] == 3
    kept = 8                                   # entries of index in [0, 4)
    assert r["bound_ms"] == pytest.approx(kernels.seg_sum_bytes(
        kept, 2, 4, 6, 8) / 3.35e12 * 1e3)
    assert census["worst"]["site"] == "ops/schur.py:513"


def test_order_profile_profiles_again_when_records_are_lost(monkeypatch):
    """`direct_paths._order_profile` profiles the run again when the trace
    lacks device records, at most three times in all, then fails."""
    from linearsfm_tpu_torch.tools import direct_paths, profile_k1
    runs, lost = [], [2]

    def totals(_):
        if lost[0]:
            lost[0] -= 1
            raise profile_k1.LostRecords("lost")
        return {"k3_us": []}
    monkeypatch.setattr(direct_paths, "_order_run",
                        lambda *a: runs.append(a))
    monkeypatch.setattr(direct_paths, "_trace_totals", totals)
    monkeypatch.setitem(direct_paths._run, "device", "cpu")
    out = direct_paths._order_profile(None, [], None)
    assert len(runs) == 3 and out["k3_census"]["worst"] is None
    lost[0] = 3
    with pytest.raises(profile_k1.LostRecords, match="3 profiled runs"):
        direct_paths._order_profile(None, [], None)
