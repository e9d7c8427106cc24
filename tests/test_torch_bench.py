"""PyTorch port vs the JAX reference: the bench.

`linearsfm_tpu_torch.tools.bench.main` against `bench.py`'s own `main`
on the same settings (8 covis maps, device executor, no profiled pass;
stereo refine and mono direct) on the CPU: the same keys, the same
`metric` string (its ATE at 3 digits), the same unit, res_max <= 1e-10
on both where the solve computes one. Then the port alone: `value` and
`vs_baseline` from its logged wall and a baseline file of known content,
every executor and the grid pattern, the profiled pass, and the dense
executor's timed run reusing the warm run's plan.
"""

import contextlib
import io
import json
import re

import pytest
import torch

from linearsfm_tpu_torch.core import compact as tcompact
from linearsfm_tpu_torch.core import layout as tlayout
from linearsfm_tpu_torch.tools import bench

# one intra-op thread: the suite's workers share the machine's cores, and
# an oversubscribed thread pool slows the trees' small ops many times over
torch.set_num_threads(1)

KEYS = {"metric", "value", "unit", "vs_baseline", "res_max", "mfu",
        "achieved_f32_tflops"}
SMALL = {"BENCH_MAPS": "8", "BENCH_PROFILE_LEVELS": "0"}
_JAX_LINES = {}


def _jax_line(datatype, method):
    """bench.py's JSON line at 8 covis maps on the CPU, device executor, no
    profiled pass (its knobs are module globals read at import;
    BENCH_PROFILE_LEVELS is read in main); one run per setting."""
    if (datatype, method) not in _JAX_LINES:
        import bench as jbench
        with pytest.MonkeyPatch.context() as mp:
            for name, value in (("NUM_MAPS", 8), ("METHOD", method),
                                ("DATATYPE", datatype),
                                ("EXECUTOR", "device"), ("COVIS", True),
                                ("PATTERN", "loop")):
                mp.setattr(jbench, name, value)
            mp.setenv("BENCH_PROFILE_LEVELS", "0")
            mp.delenv("BENCH_EXIT_TOL", raising=False)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                jbench.main()
        _JAX_LINES[datatype, method] = json.loads(
            out.getvalue().strip().splitlines()[-1])
    return _JAX_LINES[datatype, method]


def _port(capsys, env):
    """The port's bench on the CPU: (its JSON line, its stderr); stdout
    must hold that line and nothing else."""
    assert bench.main(["--cpu"], env=env) == 0
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1, captured.out
    return json.loads(lines[0]), captured.err


@pytest.mark.parametrize("datatype,method,keys", [
    ("stereo", "refine", KEYS), ("mono", "direct", KEYS - {"res_max"})])
def test_line_matches_bench_py(capsys, datatype, method, keys):
    """The same keys (the direct solve computes no PCG residual: no
    res_max on either side), the same metric string and unit."""
    want = _jax_line(datatype, method)
    got, err = _port(capsys, dict(SMALL, BENCH_TYPE=datatype,
                                  BENCH_METHOD=method))
    assert set(got) == set(want) == keys
    assert got["metric"] == want["metric"]
    assert got["metric"].startswith(f"synthetic {datatype} covis 8-map "
                                    f"hierarchical solve (ATE ")
    assert got["unit"] == want["unit"] == "maps_joined/s"
    if "res_max" in keys:
        assert got["res_max"] <= 1e-10 and want["res_max"] <= 1e-10
    ate = float(re.search(r"ATE (\d\.\d{9}) over \d+ poses", err).group(1))
    assert f"(ATE {ate:.2e})" in got["metric"]
    assert "kernel launches (timed run): {" in err
    assert "peak device memory (timed run): not measured (CPU)" in err


def test_value_and_vs_baseline(tmp_path, monkeypatch, capsys):
    """value = 7 / the logged wall; vs_baseline = value / the file's
    entry under bench.py's key, 0.0 where the file has none."""
    path = tmp_path / "baseline_measured.json"
    path.write_text(json.dumps({"stereo_covis_maps_per_s_8": 2.0,
                                "stereo_maps_per_s_8": 1000.0}))
    monkeypatch.setattr(bench, "BASELINE", str(path))
    got, err = _port(capsys, SMALL)
    wall = float(re.search(r"timed run: (\d+\.\d{4})s", err).group(1))
    assert got["value"] == pytest.approx(7 / wall, rel=1e-3)
    assert got["vs_baseline"] == pytest.approx(got["value"] / 2.0, abs=1e-3)
    assert f"stereo_covis_maps_per_s_8 in {path}" in err
    got, err = _port(capsys, dict(SMALL, BENCH_TYPE="mono"))
    assert got["vs_baseline"] == 0.0
    assert f"no mono_covis_maps_per_s_8 in {path}" in err


@pytest.mark.parametrize("env,metric,keys", [
    (dict(BENCH_TYPE="mono", BENCH_METHOD="direct"), "synthetic mono covis",
     KEYS - {"res_max"}),
    (dict(BENCH_EXEC="dense"), "synthetic stereo covis", KEYS - {
        "res_max", "mfu", "achieved_f32_tflops"}),
    (dict(BENCH_EXEC="host"), "synthetic stereo covis", KEYS - {
        "res_max", "mfu", "achieved_f32_tflops"}),
    (dict(BENCH_TYPE="mono", BENCH_PATTERN="grid"),
     "synthetic mono covis grid", KEYS),
], ids=["mono direct", "dense stereo", "host stereo", "grid mono"])
def test_every_executor_and_pattern(capsys, env, metric, keys):
    got, err = _port(capsys, dict(SMALL, **env))
    assert set(got) == keys
    assert got["metric"].startswith(f"{metric} 8-map hierarchical solve")
    assert got["value"] > 0
    if "res_max" in keys:
        assert got["res_max"] <= 1e-10
    assert "ATE " in err


def test_profiled_pass_logs_every_level(capsys):
    """The third pass (BENCH_PROFILE_LEVELS unset) logs one exec wall per
    level of the model's plan."""
    got, err = _port(capsys, {"BENCH_MAPS": "8", "BENCH_TYPE": "mono"})
    assert set(got) == KEYS
    levels = re.findall(r"  level (\d+) exec \d+\.\d{3}s model ", err)
    assert levels == ["1", "2", "3"]


def test_dense_timed_run_reuses_the_warm_runs_plan(monkeypatch, capsys):
    """The dense executor compacts and plans the set once, in the warm run:
    its timed run reuses that prep, as the JAX package's does."""
    calls = {"compact_stack": 0, "plan_dense_tree": 0}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)
    counted(tcompact, "compact_stack")
    counted(tlayout, "plan_dense_tree")
    _port(capsys, dict(SMALL, BENCH_EXEC="dense"))
    assert calls == {"compact_stack": 1, "plan_dense_tree": 1}
