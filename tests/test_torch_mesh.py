"""PyTorch port vs the JAX reference over a device mesh.

The port's mesh is a tuple of devices driven from one process; here it is
`Mesh(("cpu",) * k)`, and the reference runs on conftest's 8 virtual CPU
devices. Inputs are made once with numpy and go through both. The cases
mirror tests/test_shard_solve.py, tests/test_parallel.py,
tests/test_device_mesh.py and tests/test_mesh.py (same datasets and seeds),
so the machine-local compile cache can serve the reference side.
"""

from functools import partial

import numpy as np
import jax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import helpers as H
from synth import generate as gen
from linearsfm_tpu.core import compact as jcompact
from linearsfm_tpu.core import join as jjoin
from linearsfm_tpu.core.device_tree import DeviceTreeSolver as JaxTree
from linearsfm_tpu.core.tree import TreeSolver as JaxHostTree
from linearsfm_tpu.ops import schur as jschur
from linearsfm_tpu.parallel import level as jlevel
from linearsfm_tpu.parallel import shard_solve as jshard
from linearsfm_tpu_torch import types
from linearsfm_tpu_torch.core import compact as tcompact
from linearsfm_tpu_torch.core import join as tjoin
from linearsfm_tpu_torch.core import plan as tplan
from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver as TorchTree
from linearsfm_tpu_torch.core.tree import TreeSolver as TorchHostTree
from linearsfm_tpu_torch.ops import schur as tschur
from linearsfm_tpu_torch.parallel import level as tlevel
from linearsfm_tpu_torch.parallel import mesh as tmesh
from linearsfm_tpu_torch.parallel import shard_solve as tshard

CPU = torch.device("cpu")


def jax_mesh(nd, axis):
    return JaxMesh(np.array(jax.devices()[:nd]), (axis,))


def cpu_mesh(nd, axis):
    return tmesh.Mesh(("cpu",) * nd, axis)


def lane(x, dtype=None):
    """A numpy array as a one-lane torch tensor (ints as int64)."""
    t = torch.as_tensor(np.asarray(x))
    if not t.is_floating_point() and t.dtype != torch.bool:
        t = t.to(torch.int64)
    return (t if dtype is None else t.to(dtype))[None]


def _system(lm):
    """The reference's information vectors of a random map, and its block
    lists, as numpy."""
    eP, eF = jschur.info_vector(lm.poses, lm.feats, lm.U, lm.Uij, lm.W,
                                lm.Wpf, lm.V)
    return {k: np.asarray(v) for k, v in dict(
        U=lm.U, Uij=lm.Uij, W=lm.W, Wpf=lm.Wpf, V=lm.V, eP=eP,
        eF=eF).items()}


def _mono_pin(lm, M):
    """fixed mask (reference slot, pinned coordinate), fixc, sign of a
    random mono map (tests/helpers.random_mono_map: ref slot 0, scap slot
    1, coordinate 2 pinned at +1)."""
    fixc = 6 * 1 + 2
    fixed = np.zeros(6 * M, bool)
    fixed[0:6] = True
    fixed[fixc] = True
    return fixed, fixc, 1.0


# ---------------------------------------------------------------------------
# the sharded solves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("datatype", ["stereo", "mono"])
def test_sharded_full_mixed_matches_reference(datatype):
    """The feature-sharded PCG on 4 shards: port vs reference to 1e-9, and
    both at the single-device solve's answer; the mono case pins a
    coordinate (fixc, sign)."""
    rng = np.random.default_rng(31)
    if datatype == "stereo":
        lm = H.random_stereo_map(rng, M=6, N=24, pose_id0=1, ref_id=0)
        fixed, fixc, sign = np.zeros(6 * lm.M, bool), None, None
    else:
        lm = H.random_mono_map(rng, M=6, N=20)
        fixed, fixc, sign = _mono_pin(lm, lm.M)
    a, M = _system(lm), lm.M
    kw = dict(iters=16, escalate_iters=4, exit_tol=1e-14)
    jpin = {} if fixc is None else dict(fixc=fixc, sign=sign)
    # jitted, as the reference's levels run it (eager shard_map dispatches
    # every operation on its own)
    jxp, jxf, jres = jax.jit(partial(
        jshard.sharded_full_mixed, M=M, mesh=jax_mesh(4, "fs"), **kw))(
        lm.U, lm.Uij, lm.W, lm.Wpf, lm.V, a["eP"], a["eF"],
        fixed_mask=jax.numpy.asarray(fixed), **jpin)
    t = {k: lane(v) for k, v in a.items()}
    tpin = {} if fixc is None else dict(
        fixc=torch.tensor([fixc]), sign=torch.tensor([sign], dtype=torch.float64))
    xp, xf, res = tshard.sharded_full_mixed(
        t["U"], t["Uij"], t["W"], t["Wpf"], t["V"], t["eP"], t["eF"], M,
        lane(fixed), cpu_mesh(4, "fs"), **tpin, **kw)
    np.testing.assert_allclose(xp[0].numpy(), np.asarray(jxp), atol=1e-9)
    np.testing.assert_allclose(xf[0].numpy(), np.asarray(jxf), atol=1e-9)
    assert float(res[0]) < 1e-10 and float(jres) < 1e-10
    one = tschur.solve_full_mixed(
        t["U"], t["Uij"], t["W"], t["Wpf"], t["V"], t["eP"], t["eF"], M,
        lane(fixed), force_dense=True, **tpin, **kw)
    np.testing.assert_allclose(xp.numpy(), one[0].numpy(), atol=1e-9)
    if fixc is not None:
        assert float(xp.reshape(-1)[fixc]) == sign
    with pytest.raises(ValueError, match="one pair"):
        tshard.sharded_full_mixed(
            *(torch.cat([t[k]] * 2) for k in ("U", "Uij", "W", "Wpf", "V",
                                               "eP", "eF")),
            M, torch.cat([lane(fixed)] * 2), cpu_mesh(4, "fs"), **kw)


@pytest.mark.parametrize("method", ["direct", "refine"])
def test_sharded_schur_solve_matches_reference(method):
    """The grouped feature-sharded assembly and solve (4 shards,
    tests/test_shard_solve.py's map): port vs reference to 1e-9."""
    rng = np.random.default_rng(31)
    lm = H.random_stereo_map(rng, M=6, N=24, pose_id0=1, ref_id=0)
    a, M = _system(lm), lm.M
    jxp, jxf = jax.jit(partial(
        jshard.sharded_schur_solve, M=M, max_obs=8, mesh=jax_mesh(4, "fs"),
        method=method))(lm.U, lm.Uij, lm.W, lm.Wpf, lm.V, a["eP"], a["eF"])
    t = {k: lane(v) for k, v in a.items()}
    xp, xf = tshard.sharded_schur_solve(
        t["U"], t["Uij"], t["W"], t["Wpf"], t["V"], t["eP"], t["eF"], M, 8,
        cpu_mesh(4, "fs"), method=method)
    assert xp.shape == (1, M, 6) and xf.shape == (1, lm.N, 3)
    np.testing.assert_allclose(xp[0].numpy(), np.asarray(jxp), atol=1e-9)
    np.testing.assert_allclose(xf[0].numpy(), np.asarray(jxf), atol=1e-9)


# ---------------------------------------------------------------------------
# map-parallel levels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("datatype,n,seed,noise,max_obs,nd", [
    ("stereo", 8, 3, 0.005, 8, 4), ("mono", 4, 4, 0.0, 12, 2)])
def test_run_level_matches_reference(datatype, n, seed, noise, max_obs, nd):
    """One level's joins split over the pairs (tests/test_parallel.py's
    cases): port vs reference, poses and features to 1e-9, gauges equal."""
    maps, _, _ = gen.make_dataset(n, datatype, noise=noise, seed=seed)
    jl = [jcompact.compact(m.to_local_map()) for m in maps]
    tl = [tcompact.compact(m) for m in maps]
    pairs = lambda lms: ([lms[2 * i] for i in range(n // 2)],  # noqa: E731
                         [lms[2 * i + 1] for i in range(n // 2)])
    want = jlevel.run_level(*pairs(jl), datatype,
                            jjoin.JoinConfig(max_obs=max_obs),
                            jax_mesh(nd, "pairs"))
    cache = {}
    cfg = tjoin.JoinConfig(max_obs=max_obs, method="direct",
                           dense_schur=False)
    got = tlevel.run_level(*pairs(tl), datatype, cfg, cpu_mesh(nd, "pairs"),
                           fn_cache=cache)
    assert len(got) == len(want) == n // 2 and len(cache) == 1
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.poses, np.asarray(w.poses), atol=1e-9)
        np.testing.assert_allclose(g.feats, np.asarray(w.feats), atol=1e-9)
        assert int(g.gauge.ref) == int(w.gauge.ref)
    # 3 pairs on 2 shards: one clone pads the batch and is dropped
    odd = tlevel.run_level(*(p[:3] for p in pairs(tl)), datatype, cfg,
                           cpu_mesh(2, "pairs")) if n >= 6 else got
    for w, g in zip(got, odd):
        np.testing.assert_allclose(g.poses, w.poses, atol=1e-12)
    with pytest.raises(ValueError, match="do not split"):
        tlevel.level_merge_fn(datatype, cfg, cpu_mesh(3, "pairs"))(
            types.to_torch(tlevel.stack_maps(pairs(tl)[0][:2]), CPU),
            types.to_torch(tlevel.stack_maps(pairs(tl)[1][:2]), CPU))


# ---------------------------------------------------------------------------
# the device executor over a mesh
# ---------------------------------------------------------------------------

def _by_id(ids, poses):
    return {int(i): np.asarray(poses)[s]
            for s, i in enumerate(np.asarray(ids)) if i >= 0}


MESH_TREES = {
    # dp levels, tests/test_device_mesh.py
    "dp 16 stereo": ("stereo", 16, 3, 1 << 30, 1e-9),
    "dp 11 stereo odd counts": ("stereo", 11, 9, 1 << 30, 1e-9),
    # the feature-sharded root (and a carry under a mesh, mono 9)
    "tp 8 stereo": ("stereo", 8, 5, 0, 1e-8),
    "tp 9 mono": ("mono", 9, 5, 0, 1e-8),
}


@pytest.mark.parametrize("case", list(MESH_TREES))
def test_device_tree_mesh_matches_reference(case):
    """DeviceTreeSolver on a 2-shard mesh: the same level modes as the
    reference's, poses to the case's tolerance (1e-9 dp, 1e-8 tp), and the
    port with the mesh equal to the port without one to 1e-12."""
    datatype, n, seed, shard_min, atol = MESH_TREES[case]
    maps, _, _ = gen.make_dataset(n, datatype, noise=0.01, seed=seed)
    jsolver = JaxTree(datatype, mesh=jax_mesh(2, "pairs"),
                      root_shard_min=shard_min)
    a = jsolver.run([m.to_local_map() for m in maps])
    solver = TorchTree(datatype, mesh=cpu_mesh(2, "pairs"),
                       root_shard_min=shard_min, device=CPU)
    stacked = tcompact.compact_stack(maps, solver.bucket, solver.u_bucket)
    tp = tplan.plan_tree_exact(tplan.sym_of_stacked(stacked), datatype,
                               solver.bucket, solver.u_bucket)
    from linearsfm_tpu.core import compact as jc, plan as jp
    jst = jc.compact_stack([m.to_local_map() for m in maps], 16, 64)
    jtp = jp.plan_tree_exact(jp.sym_of_stacked(jst), datatype, 16, 64)
    modes = solver._plan_modes(tp)
    assert modes == jsolver._plan_modes(jtp)
    assert ("tp" in modes) == case.startswith("tp") and "dp" in modes
    b = types.to_numpy(solver.run(maps))
    assert solver.join_count == n - 1
    np.testing.assert_array_equal(b.pose_ids, np.asarray(a.pose_ids))
    np.testing.assert_allclose(b.poses, np.asarray(a.poses), atol=atol)
    single = types.to_numpy(TorchTree(datatype, device=CPU).run(maps))
    np.testing.assert_array_equal(b.pose_ids, single.pose_ids)
    np.testing.assert_allclose(b.poses, single.poses, atol=1e-12)


def test_device_tree_mesh_checkpoint_resume(tmp_path, caplog):
    """Under a mesh the level boundaries stay on the first device: each is
    checkpointed, a run resumed from the newest one and from level 1's
    equals the full run to 1e-12, and time_levels records every level."""
    from linearsfm_tpu_torch.utils.metrics import LevelMetrics
    maps, _, _ = gen.make_dataset(11, "stereo", noise=0.01, seed=9)

    def solver():
        return TorchTree("stereo", mesh=cpu_mesh(2, "pairs"), device=CPU)
    ck = str(tmp_path / "ck")
    metrics = LevelMetrics()
    full = types.to_numpy(solver().run(maps, metrics=metrics, ckpt_dir=ck,
                                       time_levels=True))
    assert [r["level"] for r in metrics.records] == [1, 2, 3, 4]
    assert all(r["exec_wall"] > 0 for r in metrics.records)
    newest = types.to_numpy(solver().run(maps, ckpt_dir=ck, resume=True))
    import json
    import logging
    with open(tmp_path / "ck" / "stacked_manifest.json", "w") as fh:
        json.dump(dict(level=1), fh)
    caplog.set_level(logging.INFO, logger="linearsfm_tpu_torch")
    early = types.to_numpy(solver().run(maps, ckpt_dir=ck, resume=True))
    assert "resuming at level 1" in caplog.text
    for run in (newest, early):
        np.testing.assert_array_equal(run.pose_ids, full.pose_ids)
        np.testing.assert_allclose(run.poses, full.poses, atol=1e-12)


def test_tree_solver_meshes_match_reference():
    """The host executor with a pairs mesh and an fs root mesh (the root
    join sharded from 16 joined poses): port vs reference to 1e-9, and
    equal to the port without meshes to 1e-12."""
    maps, _, _ = gen.make_dataset(8, "stereo", noise=0.01, seed=19)
    a = JaxHostTree("stereo", mesh=jax_mesh(2, "pairs"),
                    root_mesh=jax_mesh(2, "fs"), root_shard_min=16).run(
        [m.to_local_map() for m in maps])
    solver = TorchHostTree("stereo", mesh=cpu_mesh(2, "pairs"),
                           root_mesh=cpu_mesh(2, "fs"), root_shard_min=16,
                           device=CPU)
    sharded = []
    merge = tshard.sharded_schur_solve

    def count(*args, **kw):
        sharded.append(args[7])
        return merge(*args, **kw)
    tshard.sharded_schur_solve = count
    try:
        b = solver.run(maps)
    finally:
        tshard.sharded_schur_solve = merge
    assert sharded, "no join went through the root mesh"
    ga, gb = _by_id(a.pose_ids, a.poses), _by_id(b.pose_ids, b.poses)
    assert ga.keys() == gb.keys()
    for k in ga:
        np.testing.assert_allclose(gb[k], ga[k], atol=1e-9)
    c = TorchHostTree("stereo", device=CPU).run(maps)
    gc = _by_id(c.pose_ids, c.poses)
    for k in gc:
        np.testing.assert_allclose(gb[k], gc[k], atol=1e-12)


def test_auto_solver_and_meshes(monkeypatch):
    """auto_solver builds no mesh on one device; a CUDA device (or a CUDA
    mesh) without CUDA raises; a solver's device must lead its mesh."""
    s = tmesh.auto_solver("stereo", device="cpu", root_shard_min=32)
    assert isinstance(s, TorchTree) and s.mesh is None
    assert s.root_shard_min == 32
    h = tmesh.auto_solver("stereo", executor="host", device="cpu")
    assert isinstance(h, TorchHostTree) and h.mesh is None
    assert h.root_mesh is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: tmesh.auto_solver("stereo", device="cuda"),
                  tmesh.pairs_mesh, tmesh.fs_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    m = cpu_mesh(3, "pairs")
    assert m.size == 3 and tmesh.feature_window(10, 3) == 4
    parts = [torch.tensor([1e16]), torch.tensor([1.0]), torch.tensor([-1e16])]
    assert float(m.psum(parts)) == 0.0     # ((p0 + p1) + p2), in order
    with pytest.raises(ValueError, match="first device"):
        TorchTree("stereo", mesh=tmesh.Mesh(("meta", "cpu")), device=CPU)
    with pytest.raises(ValueError, match="no devices"):
        tmesh.Mesh(())

