"""PyTorch port vs the JAX reference: the reference-compatible entry point.

Local-map reading (both tokenizers) and every writer against the JAX
package's; `pipeline.run` and `cli.main` against the JAX package's on one
written dataset, both executors, by their output files; `check_map`; the
golden cases of tests/test_oracle.py through the port's `pipeline.run` and
`TreeSolver` against the compiled reference binary; and, in a subprocess,
that the port's entry modules import no JAX. The datasets repeat
tests/test_pipeline.py's configurations, so the machine-local compile cache
can serve the reference side. Everything runs on the CPU.
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import generate as gen
from test_oracle import _ensure_oracle
from linearsfm_tpu import cli as jcli
from linearsfm_tpu import types as jtypes
from linearsfm_tpu.core import pipeline as jpipeline
from linearsfm_tpu.io import localmap as jio
from linearsfm_tpu.utils import debug as jdebug
from linearsfm_tpu_torch import cli as tcli
from linearsfm_tpu_torch import native as tnative
from linearsfm_tpu_torch import types
from linearsfm_tpu_torch.core import pipeline as tpipeline
from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
from linearsfm_tpu_torch.core.tree import TreeSolver
from linearsfm_tpu_torch.io import localmap as tio
from linearsfm_tpu_torch.ops import segment as tsegment
from linearsfm_tpu_torch.utils import debug as tdebug

# one intra-op thread: the suite's workers share the machine's cores, and
# an oversubscribed thread pool slows the trees' small ops many times over
torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _fields(m) -> dict:
    """A SynthMap as the writers' dict."""
    return dict(pose_ids=m.pose_ids, poses=m.poses, feat_ids=m.feat_ids,
                feats=m.feats, U=m.U, Uij=m.Uij, W=m.W, Wpf=m.Wpf, V=m.V,
                gauge=m.gauge)


_NUM = re.compile(r"nan|-?inf|-?\d+(?:\.\d*)?(?:[eE][-+]?\d+)?")


def _same_text(got_path, want_path, atol=1.5e-6):
    """The same lines with the same layout (numbers aside, byte for byte),
    and numbers within `atol` (printed precision: "%f" rounds to 1e-6)."""
    with open(got_path) as fh:
        got = fh.read().splitlines()
    with open(want_path) as fh:
        want = fh.read().splitlines()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _NUM.sub("#", a) == _NUM.sub("#", b), (a, b)
        np.testing.assert_allclose(np.array(_NUM.findall(a), float),
                                   np.array(_NUM.findall(b), float),
                                   atol=atol, rtol=0, err_msg=a)


# ---------------------------------------------------------------------------
# local-map IO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("datatype", ["stereo", "mono"])
@pytest.mark.parametrize("parser", ["C", "Python"])
def test_read_local_map_matches_reference(tmp_path, monkeypatch, datatype,
                                          parser):
    """A file written by the reference's writer: every field and gauge tag
    of the port's reading equals the reference reader's, exactly."""
    maps, _, _ = gen.make_dataset(3, datatype, noise=0.01, seed=17)
    path = str(tmp_path / "localmap_2.txt")
    maps[1].write(path)
    if parser == "Python":
        monkeypatch.setattr(tnative, "get_fastparse", lambda: None)
    elif tnative.get_fastparse() is None:
        pytest.skip("the C tokenizer did not build (gcc missing)")
    assert tio.parser_name() == parser
    got = tio.read_local_map(path, datatype)
    want = jio.read_local_map(path, datatype)
    for f in types.MAP_FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in types.GAUGE_FIELDS:
        assert int(getattr(got.gauge, f)) == int(getattr(want.gauge, f)), f


def test_python_tokenizer_rejects_truncated_file(tmp_path, monkeypatch):
    maps, _, _ = gen.make_dataset(2, "stereo", noise=0.01, seed=17)
    path = str(tmp_path / "localmap_1.txt")
    tio.write_local_map(path, _fields(maps[0]), "stereo")
    with open(path) as fh:
        text = fh.read()
    with open(path, "w") as fh:
        fh.write(text[:len(text) // 2])
    with pytest.raises(ValueError, match="malformed"):
        tio.read_local_map(path, "stereo")        # the C tokenizer
    monkeypatch.setattr(tnative, "get_fastparse", lambda: None)
    with pytest.raises(ValueError, match="malformed"):
        tio.read_local_map(path, "stereo")


def test_parser_build_failure_warns(monkeypatch, caplog):
    """Where the C tokenizer cannot be built, a WARNING says so and the
    reader parses in Python (the JAX package logs at debug level)."""
    def fail():
        raise RuntimeError("gcc failed")
    monkeypatch.setattr(tnative, "_build", fail)
    with caplog.at_level("WARNING", logger="linearsfm_tpu_torch"):
        assert tnative.get_fastparse.__wrapped__() is None
    assert "parsing in Python" in caplog.text and "gcc failed" in caplog.text


def _odd_values(rng, shape):
    """Random values with the cases a formatter can get wrong."""
    v = rng.standard_normal(shape).ravel()
    specials = [-0.0, 0.0, 5e-324, 1e300, -1e-300, 123456789.125, 0.1,
                1 / 3, -2.5e-7, 1e16, np.nan]
    v[:len(specials)] = specials[:len(v)]
    return v.reshape(shape)


WRITERS = ["local map stereo", "local map mono", "poses", "features",
           "state"]


@pytest.mark.parametrize("writer", WRITERS)
def test_writers_match_reference(tmp_path, writer):
    """Every writer gives the reference writer's bytes: "%.17g" local maps
    (W regrouped by feature, FBlock -1 for an unobserved feature), "%f"
    pose, feature and state files with the reference's spacing, on values
    that include -0, a denormal, huge and tiny magnitudes and NaN."""
    rng = np.random.default_rng(3)
    a, b = str(tmp_path / "port.txt"), str(tmp_path / "reference.txt")
    if writer.startswith("local map"):
        datatype = writer.split()[-1]
        maps, _, _ = gen.make_dataset(3, datatype, noise=0.01, seed=4)
        d = _fields(maps[1])
        d["poses"] = _odd_values(rng, d["poses"].shape)
        d["U"] = _odd_values(rng, d["U"].shape)
        order = rng.permutation(len(d["Wpf"]))     # W not grouped yet
        d["W"], d["Wpf"] = d["W"][order], d["Wpf"][order]
        # one more feature, observed by nobody
        d["feat_ids"] = np.append(d["feat_ids"], 99999)
        d["feats"] = np.vstack([d["feats"], [1.0, -0.0, 2.5]])
        d["V"] = np.concatenate([d["V"], np.eye(3)[None]])
        tio.write_local_map(a, d, datatype)
        jio.write_local_map(b, d, datatype)
    else:
        ids = rng.permutation(40)[:17]             # unsorted ids
        vals = _odd_values(rng, (17, 3 if writer == "features" else 6))
        if writer == "poses":
            tio.write_poses(a, ids, vals)
            jio.write_poses(b, ids, vals)
        elif writer == "features":
            tio.write_features(a, ids, vals)
            jio.write_features(b, ids, vals)
        else:
            fids = rng.permutation(90)[:11] + 1000
            fvals = _odd_values(rng, (11, 3))
            tio.write_state(a, ids, vals, fids, fvals)
            jio.write_state(b, ids, vals, fids, fvals)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


# ---------------------------------------------------------------------------
# pipeline and CLI against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", ["host", "device"])
def test_cli_matches_reference(tmp_path, capsys, executor):
    """`cli.main` with the reference flags on a written stereo set
    (tests/test_pipeline.py: 8 maps, noise 0.01): both CLIs pass --check;
    pose, feature and state files have the reference CLI's layout and its
    values at printed precision."""
    maps, _, _ = gen.make_dataset(8, "stereo", noise=0.01, seed=0)
    data = str(tmp_path / "data")
    tio.write_dataset(maps, data)
    outs = {}
    for name, main in (("port", tcli.main), ("reference", jcli.main)):
        files = {k: str(tmp_path / f"{k}_{name}.txt")
                 for k in ("p", "f", "st")}
        rc = main(["-path", data, "-num", "8", "-type", "Stereo",
                   "-p", files["p"], "-f", files["f"], "-st", files["st"],
                   "--exec", executor, "--cpu", "--quiet", "--check"])
        assert rc == 0
        assert "LinearSFM Check: OK" in capsys.readouterr().out
        outs[name] = files
    for k in ("p", "f", "st"):
        _same_text(outs["port"][k], outs["reference"][k])


@pytest.mark.parametrize("executor", ["host", "device"])
def test_pipeline_run_matches_reference(tmp_path, executor):
    """`pipeline.run` on a written mono set (tests/test_pipeline.py: 7
    maps, noise 0.005): the returned maps agree (ids exact, states 1e-9)
    and so do the written files."""
    maps, _, _ = gen.make_dataset(7, "mono", noise=0.005, seed=0)
    data = str(tmp_path / "data")
    tio.write_dataset(maps, data)
    paths = {name: {k: str(tmp_path / f"{k}_{name}.txt")
                    for k in ("pose", "feat", "st")}
             for name in ("port", "reference")}
    got, _ = tpipeline.run(
        data, 7, "mono", st_path=paths["port"]["st"],
        pose_path=paths["port"]["pose"], feat_path=paths["port"]["feat"],
        progress=False, executor=executor, device="cpu")
    want, _ = jpipeline.run(
        data, 7, "mono", st_path=paths["reference"]["st"],
        pose_path=paths["reference"]["pose"],
        feat_path=paths["reference"]["feat"], progress=False,
        executor=executor)
    for f in ("pose_ids", "feat_ids"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)))
    np.testing.assert_allclose(got.poses, np.asarray(want.poses), atol=1e-9)
    np.testing.assert_allclose(got.feats, np.asarray(want.feats), atol=1e-9)
    for k in ("pose", "feat", "st"):
        _same_text(paths["port"][k], paths["reference"][k])


def test_direct_mono_solve_sums_in_fixed_order(tmp_path, monkeypatch):
    """The device and host executors run every solve, direct mono as any
    other, once under `deterministic()` (`ops/segment`, also
    `pipeline.deterministic`): the fixed-order scope, in which the segment
    sums of CUDA tensors run kernel K3. It leaves PyTorch's global
    deterministic mode and CUBLAS_WORKSPACE_CONFIG as they are, and
    `pipeline.run` gets it from the solver. The dense executor
    does not enter it: its default sums already give the same poses on
    every run (`DenseTreeSolver`'s docstring)."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    assert tpipeline.deterministic is tsegment.deterministic
    before = torch.are_deterministic_algorithms_enabled()
    with tpipeline.deterministic():
        assert tsegment._fixed
        assert torch.are_deterministic_algorithms_enabled() == before
        assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    assert not tsegment._fixed
    assert torch.are_deterministic_algorithms_enabled() == before
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    seen = []
    scope = tsegment.deterministic

    def record():
        seen.append(True)
        return scope()
    monkeypatch.setattr(tsegment, "deterministic", record)
    for datatype in ("mono", "stereo"):
        maps, _, _ = gen.make_dataset(3, datatype, noise=0.005, seed=0)
        data = str(tmp_path / datatype)
        tio.write_dataset(maps, data)
        for method in ("direct", "refine"):
            for executor in ("device", "host", "dense"):
                seen.clear()
                tpipeline.run(data, 3, datatype, method=method,
                              progress=False, executor=executor,
                              device="cpu")
                assert seen == ([True] if executor != "dense" else []), (
                    datatype, method, executor)


@pytest.mark.parametrize("caller", [(False, False), (True, False),
                                    (True, True)])
def test_device_tree_run_restores_deterministic_settings(caller,
                                                         monkeypatch):
    """`DeviceTreeSolver.run` of direct mono, called with no pipeline,
    sums in a fixed order and leaves the caller's deterministic settings
    (mode, warn-only) and CUBLAS_WORKSPACE_CONFIG as it found them."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    maps, _, _ = gen.make_dataset(3, "mono", noise=0.005, seed=0)
    inside = []
    scope = tsegment.deterministic

    def record():
        inside.append(True)
        return scope()
    monkeypatch.setattr(tsegment, "deterministic", record)
    torch.use_deterministic_algorithms(caller[0], warn_only=caller[1])
    try:
        DeviceTreeSolver("mono", method="direct", device="cpu").run(maps)
        assert inside == [True]
        assert (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled()
                ) == caller
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def test_cli_arguments_and_device(tmp_path, capsys):
    """The reference CLI's messages and exit codes; without --cpu and
    without a CUDA device the CLI stops (exit 1) and does not solve on the
    CPU; the help offers the dense executor, and an unknown executor is
    refused."""
    assert tcli.main(["-help"]) == 0
    out = capsys.readouterr().out
    assert "-path" in out and "dense" in out and "not ported" not in out
    assert tcli.main(["-num", "2", "-type", "Stereo"]) == 1
    assert "Please Input Right File Path" in capsys.readouterr().out
    assert tcli.main(["-path", "x", "-num", "2", "-type", "Bad"]) == 1
    assert "Please Set Data Type" in capsys.readouterr().out
    assert tcli.main(["-bogus", "1"]) == 1
    assert "unknown flag -bogus" in capsys.readouterr().out
    if not torch.cuda.is_available():
        assert tcli.main(["-path", str(tmp_path), "-num", "2", "-type",
                          "Stereo"]) == 1
        assert "no CUDA device" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown executor"):
        tpipeline.run(str(tmp_path), 2, "stereo", executor="fused",
                      device="cpu")


# ---------------------------------------------------------------------------
# check_map
# ---------------------------------------------------------------------------

def _breakages(lm):
    """(name, host-form map) pairs: healthy and broken in one way each."""
    def with_(**kw):
        return dataclasses.replace(lm, **kw)
    V = lm.V.copy()
    V[0, 0, 0] = np.nan
    Uij = lm.Uij.copy()
    Uij[0, 0] = 99
    Wpf = lm.Wpf.copy()
    Wpf[0, 1] = -1
    Va = lm.V.copy()
    Va[1, 0, 2] += 1.0
    ids = lm.pose_ids.copy()
    ids[1] = ids[0]
    return {"healthy": lm, "NaN in V": with_(V=V),
            "U out of range": with_(Uij=Uij), "W out of range": with_(Wpf=Wpf),
            "V asymmetric": with_(V=Va), "duplicate ids": with_(pose_ids=ids),
            "no scap": with_(gauge=dataclasses.replace(
                lm.gauge, scap=np.int32(777)))}


CHECKS = ["healthy", "NaN in V", "U out of range", "W out of range",
          "V asymmetric", "duplicate ids", "no scap"]


@pytest.mark.parametrize("case", CHECKS)
def test_check_map_matches_reference(case):
    """The problems found equal the reference's, on a host-form map and on
    a one-lane torch stack of it."""
    maps, _, _ = gen.make_dataset(2, "mono", noise=0.0, seed=20)
    m = maps[0]
    lm = types.make_local_map(m.pose_ids, m.poses, m.feat_ids, m.feats, m.U,
                              m.Uij, m.W, m.Wpf, m.V,
                              types.Gauge.mono(m.gauge["ref"],
                                               m.gauge["scap"],
                                               m.gauge["fix"],
                                               m.gauge["sign"]))
    bad = _breakages(lm)[case]
    want = jdebug.check_map(jtypes.LocalMap(
        **{f: jnp.asarray(getattr(bad, f)) for f in types.MAP_FIELDS},
        gauge=jtypes.Gauge(**{f: jnp.asarray(getattr(bad.gauge, f))
                              for f in types.GAUGE_FIELDS})))
    assert (want == []) == (case == "healthy")
    assert tdebug.check_map(bad) == want
    lane = types.stack([types.to_torch(bad, "cpu")])
    assert tdebug.check_map(lane) == want


# ---------------------------------------------------------------------------
# golden cases against the compiled reference binary
# ---------------------------------------------------------------------------

GOLDEN = {
    # tests/test_oracle.py:67-77, with TreeSolver's default pin "sign"
    "stereo golden": ("stereo", 10, 0.01, 21, 1e-5, {}),
    "stereo larger": ("stereo", 17, 0.005, 22, 1e-5, {}),
    "mono golden": ("mono", 8, 0.005, 23, 1e-4, {}),
    # the same mono case with the reference binary's own gauge handling,
    # pin "zero" (the column dropped). Measured on the CPU: every case,
    # this one included, gives pose and feature files equal to the
    # binary's digit for digit (max error 0.0 at "%f" precision)
    "mono golden pin zero": ("mono", 8, 0.005, 23, 1e-4, dict(pin="zero")),
}


@pytest.mark.parametrize("case", list(GOLDEN))
def test_oracle_golden_through_port(tmp_path, case):
    """The port's pipeline.run + TreeSolver(device="cpu") against the
    reference binary on the same written dataset, pose by pose and
    feature by feature (stereo atol 1e-5, mono 1e-4)."""
    datatype, num, noise, seed, atol, kw = GOLDEN[case]
    maps, _, _ = gen.make_dataset(num, datatype, noise=noise, seed=seed)
    tio.write_dataset(maps, str(tmp_path))
    oracle = _ensure_oracle()
    typ = "Stereo" if datatype == "stereo" else "Monocular"
    r = subprocess.run(
        [oracle, "-path", str(tmp_path), "-num", str(num), "-type", typ,
         "-p", str(tmp_path / "pose_ref.txt"),
         "-f", str(tmp_path / "feat_ref.txt")],
        capture_output=True, timeout=300)
    assert r.returncode == 0, r.stdout.decode()[-500:]
    tpipeline.run(str(tmp_path), num, datatype,
                  pose_path=str(tmp_path / "pose_port.txt"),
                  feat_path=str(tmp_path / "feat_port.txt"), progress=False,
                  solver=TreeSolver(datatype, device="cpu", **kw),
                  device="cpu")
    for what, read in (("pose", tio.read_poses), ("feat", tio.read_features)):
        ids_r, vals_r = read(str(tmp_path / f"{what}_ref.txt"))
        ids_t, vals_t = read(str(tmp_path / f"{what}_port.txt"))
        np.testing.assert_array_equal(ids_r, ids_t)
        err = np.abs(vals_r - vals_t).max()
        assert err < atol, f"{what} divergence vs the oracle: {err}"


# ---------------------------------------------------------------------------
# no JAX in the port
# ---------------------------------------------------------------------------

def test_entry_modules_import_no_jax():
    """In a fresh interpreter, the port's entry point and everything it
    imports bring in neither jax nor the JAX package."""
    code = (
        "import sys\n"
        "import linearsfm_tpu_torch.cli, linearsfm_tpu_torch.version\n"
        "from linearsfm_tpu_torch.core import pipeline, tree\n"
        "from linearsfm_tpu_torch.core import dense_tree, layout\n"
        "from linearsfm_tpu_torch.io import localmap\n"
        "from linearsfm_tpu_torch.ops import dense\n"
        "from linearsfm_tpu_torch.parallel import level\n"
        "from linearsfm_tpu_torch.utils import checkpoint, debug, flops\n"
        "from linearsfm_tpu_torch.tools import profile_dense_tree\n"
        "from linearsfm_tpu_torch import native\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'linearsfm_tpu' or m.startswith('linearsfm_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
