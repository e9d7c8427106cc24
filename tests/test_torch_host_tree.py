"""PyTorch port vs the JAX reference: the host executor and its solves.

The grouped Schur assembly (`group_by_feature`, `assemble_schur`), the
reduced-system solves (`solve_reduced`, `cholesky_solve_refine`), the host
executor `TreeSolver` on the configurations of tests/test_pipeline.py (so
the machine-local compile cache can serve the reference side), and
checkpoint/resume of both executors. Everything runs on the CPU, where the
port's kernels take their plain versions.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers as H
from synth import generate as gen
from linearsfm_tpu.core.tree import TreeSolver as JaxTree
from linearsfm_tpu.ops import schur as jschur
from linearsfm_tpu.ops import solve as jsolve
from linearsfm_tpu.utils import checkpoint as jckpt
from linearsfm_tpu_torch import types
from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
from linearsfm_tpu_torch.core.tree import TreeSolver
from linearsfm_tpu_torch.ops import schur as tschur
from linearsfm_tpu_torch.ops import solve as tsolve
from linearsfm_tpu_torch.utils import checkpoint as tckpt
from linearsfm_tpu_torch.utils.metrics import LevelMetrics

# one intra-op thread: the suite's workers share the machine's cores, and
# an oversubscribed thread pool slows the trees' small ops many times over
torch.set_num_threads(1)

CPU = torch.device("cpu")


def lanes(*arrays, dtype=None):
    """numpy arrays of equal shape -> one torch tensor with a lane axis."""
    return torch.as_tensor(np.stack(arrays), dtype=dtype)


# ---------------------------------------------------------------------------
# grouped Schur assembly
# ---------------------------------------------------------------------------

def _blocks(seed, M, N, obs, extra=0, KU=40, KW=70):
    """Random SPD block lists (tests/helpers.py) padded with zero entries
    at (0, 0), as compaction pads them, to KU / KW entries; `extra` more
    observations of feature 0 (poses 0, 1, ...) come first."""
    rng = np.random.default_rng(seed)
    U, Uij, W, Wpf, V = H.random_info_blocks(rng, M, N, obs_per_feat=obs)
    if extra:
        W = np.concatenate([rng.standard_normal((extra, 6, 3)), W])
        Wpf = np.concatenate([np.stack([np.arange(extra),
                                        np.zeros(extra, int)], 1), Wpf])

    def pad(x, k):
        return np.concatenate([x, np.zeros((k - len(x),) + x.shape[1:],
                                           x.dtype)])
    eP = rng.standard_normal((M, 6))
    eF = rng.standard_normal((N, 3))
    return pad(U, KU), pad(Uij, KU), pad(W, KW), pad(Wpf, KW), V, eP, eF


def test_group_by_feature_matches_reference():
    """Entries per feature in list order, validity and the overflow flag
    equal the reference's, two lanes (exact); an undersized max_obs flags
    only the lane that overflows."""
    a = _blocks(1, 5, 9, 3)
    b = _blocks(2, 5, 9, 3, extra=2)      # feature 0: 5 observations
    for max_obs, over in ((8, [False, False]), (4, [False, True])):
        e, v, o = tschur.group_by_feature(
            lanes(a[3], b[3], dtype=torch.int64), 9, max_obs,
            entry_valid=lanes(np.any(a[2] != 0, axis=(1, 2)),
                              np.any(b[2] != 0, axis=(1, 2))))
        assert o.tolist() == over
        for k, blk in enumerate((a, b)):
            ej, vj, oj = jschur.group_by_feature(
                jnp.asarray(blk[3]), 9, max_obs,
                entry_valid=jnp.asarray(np.any(blk[2] != 0, axis=(1, 2))))
            np.testing.assert_array_equal(v[k].numpy(), np.asarray(vj))
            np.testing.assert_array_equal(
                np.where(v[k].numpy(), e[k].numpy(), 0),
                np.where(np.asarray(vj), np.asarray(ej), 0))
            assert bool(o[k]) == bool(oj)


@pytest.mark.parametrize("case", ["grouped f64", "grouped f32",
                                  "dense f64", "grouped overflow"])
def test_assemble_schur_matches_reference(case):
    """S and E of two lanes against the reference's assemble_schur on each
    (which forms Y = W Vinv[wf] from its own Vinv, where the port takes Y
    from K2's plain version): float64 to 1e-12 (grouped and forced dense),
    float32 to rtol 1e-5 (plus 1e-5 of the largest magnitude). With
    max_obs too small for lane 1 (feature 0 has 5 observations there, at
    most 3 elsewhere), lane 1 is all NaN in both packages and lane 0 is
    unchanged."""
    dt = np.float32 if "f32" in case else np.float64
    M, N = 6, 11
    a = [x.astype(dt) if x.dtype.kind == "f" else x
         for x in _blocks(11, M, N, 3)]
    b = [x.astype(dt) if x.dtype.kind == "f" else x
         for x in _blocks(12, M, N, 3, extra=2)]
    max_obs = 4 if case == "grouped overflow" else 8
    dense = case.startswith("dense")
    U, Uij, W, Wpf, V, eP, eF = (lanes(x, y, dtype=torch.int64)
                                 if x.dtype.kind == "i" else lanes(x, y)
                                 for x, y in zip(a, b))
    _, Y = tschur.inv3x3_wy(V, W, Wpf)
    S, E = tschur.assemble_schur(U, Uij, W, Wpf, Y, eP, eF, M, max_obs,
                                 force_dense=dense)
    for k, blk in enumerate((a, b)):
        Uj, Uijj, Wj, Wpfj, Vj, ePj, eFj = (jnp.asarray(x) for x in blk)
        Sj, Ej = jschur.assemble_schur(Uj, Uijj, Wj, Wpfj,
                                       jschur.inv3x3_sym(Vj), ePj, eFj, M,
                                       max_obs, force_dense=dense)
        Sj, Ej = np.asarray(Sj), np.asarray(Ej)
        if case == "grouped overflow" and k == 1:
            assert np.isnan(Sj).all() and torch.isnan(S[k]).all()
            continue
        if dt == np.float64:
            np.testing.assert_allclose(S[k].numpy(), Sj, atol=1e-12)
            np.testing.assert_allclose(E[k].numpy(), Ej, atol=1e-12)
        else:
            for got, want in ((S[k], Sj), (E[k], Ej)):
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                           atol=1e-5 * np.abs(want).max())


def _spd(rng, d, cond_scale=1.0):
    A = rng.standard_normal((d, d))
    return A @ A.T + cond_scale * d * np.eye(d)


@pytest.mark.parametrize("method", ["direct", "refine"])
def test_solve_reduced_matches_reference(method):
    """Gauge-masked solves of two lanes: the reference's solve_reduced to
    1e-10 (refine: three sweeps from an f32 factor of a well-conditioned
    system), zeros at the fixed coordinates; a lane whose matrix is not
    positive definite is NaN and leaves the other lane alone."""
    rng = np.random.default_rng(5)
    d = 18
    S = np.stack([_spd(rng, d), _spd(rng, d)])
    E = rng.standard_normal((2, d))
    fixed = np.zeros((2, d), bool)
    fixed[0, 6:12] = True
    fixed[1, 3] = True
    x = tsolve.solve_reduced(torch.as_tensor(S), torch.as_tensor(E),
                             fixed_mask=torch.as_tensor(fixed),
                             method=method, refine_iters=3)
    for k in range(2):
        xj = jsolve.solve_reduced(jnp.asarray(S[k]), jnp.asarray(E[k]),
                                  fixed_mask=jnp.asarray(fixed[k]),
                                  method=method, refine_iters=3)
        np.testing.assert_allclose(x[k].numpy(), np.asarray(xj), atol=1e-10)
        assert (x[k].numpy()[fixed[k]] == 0).all()
    bad = S.copy()
    bad[1] = -bad[1]
    x = tsolve.solve_reduced(torch.as_tensor(bad), torch.as_tensor(E),
                             method=method)
    assert torch.isfinite(x[0]).all() and torch.isnan(x[1]).all()


def test_cholesky_solve_refine_matches_reference():
    """Each sweep moves toward the f64 solution; after three, the
    reference's result to 1e-10 and the exact solution to 1e-10."""
    rng = np.random.default_rng(6)
    d = 30
    S = _spd(rng, d, cond_scale=0.05)
    E = rng.standard_normal(d)
    exact = np.linalg.solve(S, E)
    errs = [np.abs(tsolve.cholesky_solve_refine(
        torch.as_tensor(S[None]), torch.as_tensor(E[None]), it)[0].numpy()
        - exact).max() for it in range(4)]
    assert errs[3] < errs[0] * 1e-3 and errs[3] < 1e-10, errs
    xj = jsolve.cholesky_solve_refine(jnp.asarray(S), jnp.asarray(E), 3)
    got = tsolve.cholesky_solve_refine(torch.as_tensor(S[None]),
                                       torch.as_tensor(E[None]), 3)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(xj), atol=1e-10)


# ---------------------------------------------------------------------------
# TreeSolver vs the reference's
# ---------------------------------------------------------------------------

TREES = {
    # tests/test_pipeline.py's configurations, one option changed at a time
    "stereo 6 level direct": ("stereo", 6, 0.0, {}),
    "stereo 5 serial refine": ("stereo", 5, 0.0,
                               dict(strategy="serial", method="refine")),
    "stereo 8 level refine": ("stereo", 8, 0.01, dict(method="refine")),
    "mono 6 level direct": ("mono", 6, 0.0, {}),
    "mono 7 serial direct pin zero": ("mono", 7, 0.005,
                                      dict(strategy="serial", pin="zero")),
    "mono 7 level refine pin zero": ("mono", 7, 0.005,
                                     dict(method="refine", pin="zero")),
    "mono 6 level refine": ("mono", 6, 0.0, dict(method="refine")),
}


@pytest.mark.parametrize("case", list(TREES))
def test_tree_solver_matches_reference(case):
    """Whole host-executor trees (odd carry, re-gauge, per-level
    compaction, grouped Schur with the exact max_obs): the same ids in the
    same slots, poses and features to 1e-9, one join per merged map, one
    metrics record per level."""
    datatype, n, noise, kw = TREES[case]
    maps, _, _ = gen.make_dataset(n, datatype, noise=noise, seed=0)
    want = JaxTree(datatype, **kw).run([m.to_local_map() for m in maps])
    metrics = LevelMetrics()
    solver = TreeSolver(datatype, device=CPU, **kw)
    got = solver.run(maps, metrics=metrics)
    for f in ("pose_ids", "feat_ids", "n_poses", "n_feats"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.poses, np.asarray(want.poses), atol=1e-9)
    np.testing.assert_allclose(got.feats, np.asarray(want.feats), atol=1e-9)
    for f in types.GAUGE_FIELDS:
        assert int(getattr(got.gauge, f)) == int(getattr(want.gauge, f)), f
    assert solver.join_count == n - 1
    assert [r["level"] for r in metrics.records] == list(
        range(1, len(metrics.records) + 1))
    assert metrics.records[-1]["n_maps"] == 1


def test_tree_solver_rejects_mesh():
    """A mesh must start at the solver's device, where the level stacks
    and the root solve live; one that does is taken (the mesh paths
    themselves: tests/test_torch_mesh.py)."""
    from linearsfm_tpu_torch.parallel.mesh import Mesh
    with pytest.raises(ValueError, match="first device"):
        TreeSolver("stereo", mesh=Mesh(("meta", "cpu")), device=CPU)
    with pytest.raises(ValueError, match="first device"):
        TreeSolver("mono", root_mesh=Mesh(("meta",), "fs"), device=CPU)
    s = TreeSolver("stereo", mesh=Mesh(("cpu",) * 2),
                   root_mesh=Mesh(("cpu",) * 2, "fs"), device=CPU)
    assert s.mesh.size == 2 and s.root_mesh.axis == "fs"


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

def _rewind(src, dst, manifest, content):
    """Copy a checkpoint directory aside and point its manifest at an
    earlier level."""
    shutil.copytree(src, dst)
    with open(os.path.join(dst, manifest), "w") as fh:
        json.dump(content, fh)


def test_host_checkpoint_resume(tmp_path):
    """Host executor (tests/test_checkpoint.py's set): a resumed run, from
    the newest checkpoint and from level 1's, equals the full run."""
    maps, _, _ = gen.make_dataset(8, "stereo", noise=0.01, seed=9)
    ck = str(tmp_path / "ck")
    metrics = LevelMetrics()
    full = TreeSolver("stereo", device=CPU).run(maps, ckpt_dir=ck,
                                               metrics=metrics)
    assert metrics.total_joins == 7 and len(metrics.records) == 3
    level, saved = tckpt.latest(ck)
    assert level == 3 and len(saved) == 1
    newest = TreeSolver("stereo", device=CPU).run([], ckpt_dir=ck,
                                                 resume=True)
    np.testing.assert_allclose(newest.poses, full.poses, atol=1e-12)
    _rewind(ck, str(tmp_path / "early"), "manifest.json",
            dict(level=1, count=4))
    early = TreeSolver("stereo", device=CPU).run(
        [], ckpt_dir=str(tmp_path / "early"), resume=True)
    np.testing.assert_array_equal(early.pose_ids, full.pose_ids)
    np.testing.assert_allclose(early.poses, full.poses, atol=1e-12)
    np.testing.assert_allclose(early.feats, full.feats, atol=1e-12)


def test_device_checkpoint_resume(tmp_path, caplog):
    """Device executor: stacked level boundaries, resumed from the newest
    (only the final re-gauge runs) and from level 2's, equal the full run;
    a checkpoint whose shape the plan does not confirm is refused with a
    warning and the tree starts over."""
    maps, _, _ = gen.make_dataset(8, "stereo", noise=0.01, seed=9)
    ck = str(tmp_path / "ck")
    full = types.to_numpy(DeviceTreeSolver("stereo", device=CPU).run(
        maps, ckpt_dir=ck))
    assert tckpt.latest_stacked(ck)[0] == 3
    newest = types.to_numpy(DeviceTreeSolver("stereo", device=CPU).run(
        maps, ckpt_dir=ck, resume=True))
    np.testing.assert_allclose(newest.poses, full.poses, atol=1e-12)
    _rewind(ck, str(tmp_path / "early"), "stacked_manifest.json",
            dict(level=2))
    solver = DeviceTreeSolver("stereo", device=CPU)
    early = types.to_numpy(solver.run(maps, ckpt_dir=str(tmp_path / "early"),
                                      resume=True))
    assert solver.join_count == 1          # only level 3 ran
    np.testing.assert_array_equal(early.pose_ids, full.pose_ids)
    np.testing.assert_allclose(early.poses, full.poses, atol=1e-12)
    maps16, _, _ = gen.make_dataset(16, "stereo", noise=0.01, seed=9)
    with caplog.at_level("WARNING", logger="linearsfm_tpu_torch"):
        out = DeviceTreeSolver("stereo", device=CPU).run(
            maps16, ckpt_dir=ck, resume=True)
    assert "mismatches plan" in caplog.text
    assert int(out.n_poses) == 16


def test_checkpoints_match_reference_files(tmp_path):
    """The same files, keys and manifests as the reference: the port
    resumes from the reference's level-1 checkpoint to the reference's
    result (1e-9), and the reference's `latest` reads the port's files."""
    maps, _, _ = gen.make_dataset(8, "stereo", noise=0.01, seed=0)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    want = JaxTree("stereo", method="refine").run(
        [m.to_local_map() for m in maps], ckpt_dir=jdir)
    _rewind(jdir, str(tmp_path / "jax1"), "manifest.json",
            dict(level=1, count=4))
    got = TreeSolver("stereo", method="refine", device=CPU).run(
        [], ckpt_dir=str(tmp_path / "jax1"), resume=True)
    np.testing.assert_allclose(got.poses, np.asarray(want.poses), atol=1e-9)

    TreeSolver("stereo", method="refine", device=CPU).run(maps,
                                                          ckpt_dir=tdir)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    level, jmaps = jckpt.latest(tdir)
    tlevel, tmaps = tckpt.latest(tdir)
    assert level == tlevel == 3
    for f in types.MAP_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jmaps[0], f)),
                                      getattr(tmaps[0], f), err_msg=f)
