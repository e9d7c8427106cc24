"""PyTorch port vs the JAX reference: join, compaction, plan and the tree.

The same synthetic maps (synth/generate.py, tests/helpers.py) go through the
reference and the port on the CPU. The tree cases reuse the configurations of
tests/test_device_tree.py (13 maps seed 5; 9 maps seed 21 in the top band),
so the machine-local compile cache can serve the reference side.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import helpers as H
from synth import generate as gen
from linearsfm_tpu.core import compact as jcompact
from linearsfm_tpu.core import dcompact as jdcompact
from linearsfm_tpu.core import join as jjoin
from linearsfm_tpu.core import plan as jplan
from linearsfm_tpu.core.device_tree import DeviceTreeSolver as JaxTree
from linearsfm_tpu.core.tree import TreeSolver
from linearsfm_tpu_torch import types
from linearsfm_tpu_torch.core import compact as tcompact
from linearsfm_tpu_torch.core import dcompact as tdcompact
from linearsfm_tpu_torch.core import join as tjoin
from linearsfm_tpu_torch.core import plan as tplan
from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver as TorchTree
from linearsfm_tpu_torch.ops import schur as tschur
from linearsfm_tpu_torch.parallel import level as tlevel
from linearsfm_tpu_torch.utils.metrics import LevelMetrics

# one intra-op thread: the suite's workers share the machine's cores, and
# an oversubscribed thread pool slows the trees' small ops many times over
torch.set_num_threads(1)

CPU = torch.device("cpu")


def one_lane(lm):
    return types.stack([types.to_torch(lm, CPU)])


def _by_id(ids, vals):
    return {int(i): np.asarray(vals)[s]
            for s, i in enumerate(np.asarray(ids)) if i >= 0}


def _stereo_pair():
    """Two stereo maps (3 + 3 poses) in one gauge with shared features."""
    rng = np.random.default_rng(10)
    a = H.random_stereo_map(rng, M=3, N=6, pose_id0=1, feat_id0=1000,
                            ref_id=0)
    b = H.random_stereo_map(rng, M=3, N=7, pose_id0=10, feat_id0=1003,
                            ref_id=0)
    return a, b


@pytest.mark.parametrize("method", ["refine", "direct"])
def test_join_stereo_matches_reference(method):
    """Two maps in one gauge with shared features: ids exact, block lists
    exact (concatenations), solved states to 1e-9."""
    a, b = _stereo_pair()
    kw = dict(method=method, refine_iters=4, with_res=True, max_obs=8,
              dense_schur=True)
    want, res_j = jjoin.join_stereo(a, b, jjoin.JoinConfig(**kw))
    got, res_t = tjoin.join_stereo(one_lane(a), one_lane(b),
                                   tjoin.JoinConfig(**kw))
    g = types.to_numpy(types.lanes(got, 0))
    for f in ("pose_ids", "feat_ids", "Uij", "Wpf", "n_poses", "n_feats"):
        np.testing.assert_array_equal(getattr(g, f), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("U", "W", "V"):
        np.testing.assert_array_equal(getattr(g, f), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(g.poses, np.asarray(want.poses), atol=1e-9)
    np.testing.assert_allclose(g.feats, np.asarray(want.feats), atol=1e-9)
    assert int(g.n_feats) == 6 + 7 - 3
    if method == "refine":
        assert float(res_t[0]) < 1e-10 and float(res_j) < 1e-10
    else:
        assert np.isnan(float(res_t[0])) and np.isnan(float(res_j))


def test_join_config_matches_reference():
    """`JoinConfig()` equals the JAX package's field for field, in its
    order (the TPU-only `use_pallas` aside), and `JoinConfig(8)` is
    max_obs, as there."""
    want = jjoin.JoinConfig()._asdict()
    del want["use_pallas"]
    assert tjoin.JoinConfig()._asdict() == want
    assert list(tjoin.JoinConfig._fields) == list(want)
    assert tjoin.JoinConfig(8).max_obs == 8


@pytest.mark.parametrize("form", ["default", "max_obs"])
def test_join_stereo_default_config_is_direct(form, monkeypatch):
    """`join_stereo(a, b)` and `join_stereo(a, b, JoinConfig(max_obs=8))`
    take the JAX package's exact direct solve: no PCG call
    (`schur.solve_full_mixed`), states within 1e-9 of the reference's."""
    a, b = _stereo_pair()
    args = () if form == "default" else (tjoin.JoinConfig(max_obs=8),)
    jargs = () if form == "default" else (jjoin.JoinConfig(max_obs=8),)
    pcg = []
    solve = tschur.solve_full_mixed
    monkeypatch.setattr(tschur, "solve_full_mixed",
                        lambda *a, **k: pcg.append(1) or solve(*a, **k))
    got = types.to_numpy(types.lanes(
        tjoin.join_stereo(one_lane(a), one_lane(b), *args), 0))
    want = jjoin.join_stereo(a, b, *jargs)
    assert not pcg
    np.testing.assert_array_equal(got.pose_ids, np.asarray(want.pose_ids))
    np.testing.assert_allclose(got.poses, np.asarray(want.poses), atol=1e-9)
    np.testing.assert_allclose(got.feats, np.asarray(want.feats), atol=1e-9)


def _mono_pair():
    """Two mono maps in one gauge (ref 0, scap 1, fix 2) with shared
    features, b's other poses renamed."""
    rng = np.random.default_rng(12)
    a = H.random_mono_map(rng, M=4, N=6, pose_id0=0, feat_id0=1000, fix=2)
    b = H.random_mono_map(rng, M=4, N=6, pose_id0=0, feat_id0=1003, fix=2)
    b = dataclasses.replace(b, pose_ids=jax.numpy.asarray(
        np.array([0, 1, 12, 13]), jax.numpy.int32))
    return a, b


# (datatype, method, pin, mesh) -> the solver calls of one join, in order:
# (solver, pinned or the reduced solve's method), then "backsub" and "pin"
# where the join back-substitutes and writes the mono pin
JOIN_ROUTES = {
    ("stereo", "refine", "sign", False): [("solve_full_mixed", False)],
    ("stereo", "refine", "sign", True): [("sharded_full_mixed", False)],
    ("stereo", "direct", "sign", False): [("solve_reduced", "direct"),
                                          "backsub"],
    ("stereo", "direct", "sign", True): [("sharded_schur_solve", "direct")],
    ("stereo", "refine", "other", False): [("solve_full_mixed", False)],
    ("stereo", "other", "sign", False): ValueError,
    ("mono", "refine", "sign", False): [("solve_full_mixed", True)],
    ("mono", "refine", "sign", True): [("sharded_full_mixed", True)],
    ("mono", "refine", "zero", False): [("solve_reduced", "refine"),
                                        "backsub", "pin"],
    ("mono", "refine", "zero", True): [("sharded_schur_solve", "refine"),
                                       "pin"],
    ("mono", "direct", "sign", False): [("solve_reduced", "direct"), "pin",
                                        "backsub"],
    ("mono", "direct", "sign", True): [("sharded_schur_solve", "direct"),
                                       "pin"],
    ("mono", "direct", "zero", False): [("solve_reduced", "direct"),
                                        "backsub", "pin"],
    ("mono", "direct", "zero", True): [("sharded_schur_solve", "direct"),
                                       "pin"],
    ("mono", "other", "sign", False): ValueError,
    ("mono", "refine", "other", True): ValueError,
}


@pytest.mark.parametrize("route", list(JOIN_ROUTES),
                         ids=lambda r: f"{r[0]} {r[1]} pin {r[2]} "
                                       f"{'mesh' if r[3] else 'no mesh'}")
def test_join_routes(route, monkeypatch):
    """Both joins' one router: each (mesh, method, pin) reaches its solver,
    the PCG gets the mono pin (fixc, sign) and stereo none, the pin of
    mono "sign" is written before the back-substitution and that of pin
    "zero" and of the mesh after; an unknown method or mono pin raises
    (stereo has no pin to check). The solvers are recording stand-ins
    that return zeros of the right shapes; the assembly, the
    back-substitution and the pin are the port's."""
    from linearsfm_tpu_torch.ops import solve as tsolve
    from linearsfm_tpu_torch.parallel import shard_solve as tshard
    datatype, method, pin, mesh = route
    a, b = _stereo_pair() if datatype == "stereo" else _mono_pair()
    calls = []

    def pcg(name):
        def fake(U, Uij, W, Wpf, V, eP, eF, M, fixed_mask, *a, **k):
            calls.append((name, k.get("fixc") is not None))
            return (eP.new_zeros((1, M, 6)), torch.zeros_like(eF),
                    eP.new_zeros((1,)))
        return fake

    def sharded_schur_solve(U, Uij, W, Wpf, V, eP, eF, M, *a, **k):
        calls.append(("sharded_schur_solve", k["method"]))
        return eP.new_zeros((1, M, 6)), torch.zeros_like(eF)

    def solve_reduced(S, E, **k):
        calls.append(("solve_reduced", k["method"]))
        return torch.zeros_like(E)

    def recorded(name, fn):
        return lambda *a, **k: calls.append(name) or fn(*a, **k)
    monkeypatch.setattr(tschur, "solve_full_mixed", pcg("solve_full_mixed"))
    monkeypatch.setattr(tshard, "sharded_full_mixed",
                        pcg("sharded_full_mixed"))
    monkeypatch.setattr(tshard, "sharded_schur_solve", sharded_schur_solve)
    monkeypatch.setattr(tsolve, "solve_reduced", solve_reduced)
    monkeypatch.setattr(tschur, "backsub_features",
                        recorded("backsub", tschur.backsub_features))
    monkeypatch.setattr(tschur, "pin_coordinate",
                        recorded("pin", tschur.pin_coordinate))
    cfg = tjoin.JoinConfig(method=method, pin=pin, max_obs=8,
                           mesh=object() if mesh else None)
    join = tjoin.join_stereo if datatype == "stereo" else tjoin.join_mono
    want = JOIN_ROUTES[route]
    if want is ValueError:
        with pytest.raises(ValueError, match="no join solve"):
            join(one_lane(a), one_lane(b), cfg)
        assert not calls
        return
    out = join(one_lane(a), one_lane(b), cfg)
    assert calls == want
    if "pin" in want:
        fixc = int(6 * out.scap_slot()[0] + out.gauge.fix[0])
        assert float(out.poses.reshape(-1)[fixc]) == float(b.gauge.sign)


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_info_dtype_name_equals_torch_dtype(name):
    """`JoinConfig(info_dtype="float32")`, the JAX package's form, gives
    the same bits as `info_dtype=torch.float32`, through the transform and
    the join of `parallel/level.merge_one_stereo`."""
    a, b = _stereo_pair()
    b = dataclasses.replace(b, gauge=dataclasses.replace(
        b.gauge, ref=np.int32(2)))   # a pose of a: the transform runs
    outs = []
    for idt in (name, getattr(torch, name)):
        cfg = tjoin.JoinConfig(max_obs=8, info_dtype=idt)
        outs.append(tlevel.merge_one_stereo(one_lane(a), one_lane(b), cfg))
    for f in ("poses", "feats", "U", "W", "V"):
        assert torch.equal(getattr(outs[0], f), getattr(outs[1], f)), f
    assert outs[0].U.dtype == getattr(torch, name)


def test_graft_entry_merge_matches_reference():
    """The JAX package's single-pair merge as `__graft_entry__.entry` calls
    it, `merge_one_stereo(g, m, JoinConfig(max_obs=8))`, on its two maps:
    ids exact, states within 1e-9."""
    import __graft_entry__ as graft
    fn, (g, m) = graft.entry()
    want = fn(g, m)
    got = types.to_numpy(types.lanes(tlevel.merge_one_stereo(
        one_lane(g), one_lane(m), tjoin.JoinConfig(max_obs=8)), 0))
    for f in ("pose_ids", "feat_ids"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)))
    np.testing.assert_allclose(got.poses, np.asarray(want.poses), atol=1e-9)
    np.testing.assert_allclose(got.feats, np.asarray(want.feats), atol=1e-9)


def test_compact_device_matches_reference():
    """compact_device on a merged map (tests/test_device_tree.py fixture):
    ids, counts and merged blocks agree (blocks to 1e-12)."""
    maps, _, _ = gen.make_dataset(8, "stereo", noise=0.01, seed=3)
    lms = [jcompact.compact(m.to_local_map(), 16, 64) for m in maps]
    raw = jax.device_get(TreeSolver("stereo", strategy="serial").merge_pair(
        lms[0], lms[1]))
    hc = jcompact.compact(raw, 16, 64)
    caps = (hc.M, hc.N, hc.KU, hc.KW)
    want, mo_j = jdcompact.compact_device(raw, *caps)
    got, mo_t = tdcompact.compact_device(one_lane(raw), *caps)
    g = types.to_numpy(types.lanes(got, 0))
    for f in ("pose_ids", "feat_ids", "Uij", "Wpf", "n_poses", "n_feats",
              "n_U", "n_W"):
        np.testing.assert_array_equal(getattr(g, f), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("poses", "feats", "U", "W", "V"):
        np.testing.assert_allclose(getattr(g, f), np.asarray(getattr(want, f)),
                                   atol=1e-12, err_msg=f)
    assert int(mo_t[0]) == int(mo_j)


def test_compact_stack_and_plan_match_reference():
    """Host ingest and the exact capacity plan are the reference's: stacked
    arrays equal, level plans equal."""
    maps, _, _ = gen.make_dataset(13, "stereo", noise=0.01, seed=7)
    lms = [m.to_local_map() for m in maps]
    sj = jcompact.compact_stack(lms, 16, 64)
    st = tcompact.compact_stack(maps, 16, 64)   # SynthMaps directly
    for f in types.MAP_FIELDS:
        np.testing.assert_array_equal(getattr(st, f), np.asarray(getattr(sj, f)),
                                      err_msg=f)
    for f in types.GAUGE_FIELDS:
        np.testing.assert_array_equal(getattr(st.gauge, f),
                                      np.asarray(getattr(sj.gauge, f)))
    pj = jplan.plan_tree_exact(jplan.sym_of_stacked(sj), "stereo", 16, 64)
    pt = tplan.plan_tree_exact(tplan.sym_of_stacked(st), "stereo", 16, 64)
    assert len(pt.levels) == len(pj.levels) == 4
    for lt, lj in zip(pt.levels, pj.levels):
        assert dataclasses.astuple(lt) == dataclasses.astuple(lj)
    assert (pt.root_regauge, pt.root_caps) == (pj.root_regauge, pj.root_caps)


TOP = dict(method="refine", top_min_m=4, top_iters=16)
TREES = {
    # default bands: every level in the low band (3 PCG sweeps)
    "13 maps refine": (13, 5, dict(method="refine"), 1e-9),
    # top band with and without the early exit (tests/test_device_tree.py:82-95)
    "9 maps top band early exit": (9, 21, TOP, 1e-9),
    "9 maps top band fixed trips": (9, 21, dict(TOP, pcg_exit_tol=0.0), 1e-9),
    "13 maps direct": (13, 5, dict(method="direct"), 1e-9),
    # plain f64 Cholesky from 4 joined poses up, PCG below
    "13 maps direct band": (13, 5, dict(method="refine", direct_min_m=4), 1e-9),
    # f32 information up to 4 joined poses (the odd carry is cast to f32):
    # the two packages round the f32 congruences and solves differently and
    # the tree amplifies it (measured 8e-6; the reference bounds this policy
    # at 2e-4 against f64, tests/test_device_tree.py:107-112)
    "13 maps f32 information band": (13, 5, dict(method="refine",
                                                 mixed_max_m=4), 1e-4),
}


@pytest.mark.parametrize("case", list(TREES))
def test_device_tree_matches_reference(case):
    """Whole tree, odd carry and re-gauge lanes included: the same slots in
    the same order, poses and features to the stated tolerance."""
    n, seed, kw, atol = TREES[case]
    maps, _, _ = gen.make_dataset(n, "stereo", noise=0.01, seed=seed)
    a = JaxTree("stereo", **kw).run([m.to_local_map() for m in maps])
    metrics = LevelMetrics()
    solver = TorchTree("stereo", device=CPU, **kw)
    b = types.to_numpy(solver.run(maps, metrics=metrics, time_levels=True))
    np.testing.assert_array_equal(b.pose_ids, np.asarray(a.pose_ids))
    np.testing.assert_array_equal(b.feat_ids, np.asarray(a.feat_ids))
    np.testing.assert_allclose(b.poses, np.asarray(a.poses), atol=atol)
    np.testing.assert_allclose(b.feats, np.asarray(a.feats), atol=atol)
    assert solver.join_count == n - 1
    assert [r["level"] for r in metrics.records] == [1, 2, 3, 4]
    assert all(r["exec_wall"] > 0 for r in metrics.records)
    if (kw["method"] == "refine" and not kw.get("direct_min_m")
            and not kw.get("mixed_max_m")):    # every level ran the PCG
        assert max(r["res_max"] for r in metrics.records) < 1e-10


def test_device_tree_recovers_noise_free_truth():
    """Noise-free maps are consistent, so the linear fusion reproduces the
    ground truth (the reference's exactness property)."""
    maps, poses_gt, _ = gen.make_dataset(11, "stereo", noise=0.0, seed=14)
    out = types.to_numpy(TorchTree("stereo", device=CPU).run(maps))
    got = _by_id(out.pose_ids, out.poses)
    assert sorted(got) == list(range(1, 12))   # pose 0 is the frame itself
    for pid, p in got.items():
        np.testing.assert_allclose(p, poses_gt[pid], atol=1e-6)
