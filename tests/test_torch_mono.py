"""PyTorch port vs the JAX reference: the monocular path.

The same numpy inputs (seeded generators, tests/helpers.py, synth/) go
through a `linearsfm_tpu` function and its `linearsfm_tpu_torch` counterpart
on the CPU: the mono gauge maps, the mono congruence with its
gauge-conditioning projection, `join_mono`, the host ingest and plan, and the
whole mono device tree. The tree cases reuse the configuration of
tests/test_device_tree.py (11 mono maps, seed 5), so the machine-local
compile cache can serve the reference side.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers as H
from synth import generate as gen
from test_torch_ops import _assert_maps_close, one_lane_map
from linearsfm_tpu.core import compact as jcompact
from linearsfm_tpu.core import join as jjoin
from linearsfm_tpu.core import plan as jplan
from linearsfm_tpu.core.device_tree import DeviceTreeSolver as JaxTree
from linearsfm_tpu.ops import congruence as jcong
from linearsfm_tpu.ops import gauge as jgauge
from linearsfm_tpu_torch import types
from linearsfm_tpu_torch.core import compact as tcompact
from linearsfm_tpu_torch.core import join as tjoin
from linearsfm_tpu_torch.core import plan as tplan
from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver as TorchTree
from linearsfm_tpu_torch.ops import congruence as tcong
from linearsfm_tpu_torch.ops import gauge as tgauge
from linearsfm_tpu_torch.ops import schur as tschur
from linearsfm_tpu_torch.utils.metrics import LevelMetrics

# one intra-op thread: the suite's workers share the machine's cores, and
# an oversubscribed thread pool slows the trees' small ops many times over
torch.set_num_threads(1)

CPU = torch.device("cpu")


def ids(*v):
    return torch.tensor(v, dtype=types.INDEX)


def mono_map(seed, M=5, N=7, fix=2):
    """Random mono map: pose ids 0..M-1, ref 0 (slot 0), scap 1 (slot 1)."""
    return H.random_mono_map(np.random.default_rng(seed), M=M, N=N,
                             pose_id0=0, fix=fix)


def slot_of(pose_ids, pid):
    return int(np.argmax(np.asarray(pose_ids) == pid))


# ---------------------------------------------------------------------------
# gauge maps
# ---------------------------------------------------------------------------

def test_mono_batched_matches_reference():
    """The batched map, per-lane `fix` included (1e-12); a pinned coordinate
    at exactly 0 has sign +1."""
    rng = np.random.default_rng(30)
    P, M, N = 3, 5, 7
    poses = rng.standard_normal((P, M, 6))
    feats = rng.standard_normal((P, N, 3)) * 2.0
    g = rng.standard_normal((P, 6))
    s = rng.standard_normal((P, 3)) * 3.0
    fix = np.array([0, 2, 1])
    np_, nf_, sign = tgauge.mono_batched(*(torch.tensor(a) for a in
                                           (poses, feats, g, s, fix)))
    for p in range(P):
        jp, jf, js = jgauge.mono_batched(*(jnp.asarray(a[p]) for a in
                                           (poses, feats, g, s)), int(fix[p]))
        np.testing.assert_allclose(np_[p].numpy(), np.asarray(jp), atol=1e-12)
        np.testing.assert_allclose(nf_[p].numpy(), np.asarray(jf), atol=1e-12)
        assert float(sign[p]) == float(js)
    s0 = np.array([[1.0, 0.0, 2.0]])
    _, _, sg0 = tgauge.mono_batched(torch.tensor(poses[:1]),
                                    torch.tensor(feats[:1]),
                                    torch.zeros(1, 6, dtype=torch.float64),
                                    torch.tensor(s0), torch.tensor([1]))
    _, _, js0 = jgauge.mono_batched(jnp.asarray(poses[0]), jnp.asarray(feats[0]),
                                    jnp.zeros(6), jnp.asarray(s0[0]), 1)
    assert float(sg0[0]) == float(js0) == 1.0


# new gauges (ref, scap, fix) of a map with ref 0 in slot 0 and scap 1 in
# slot 1: r_slot = 0, s_slot = 1 (the old gauge's slots)
GAUGES = {
    "generic": (3, 4, 1),
    "old ref is the new scap (r_slot == p2)": (2, 0, 0),
    "old scap is the new ref (s_slot == p1)": (1, 3, 1),
    "ref and scap swapped": (1, 0, 2),
}


@pytest.mark.parametrize("case", list(GAUGES))
def test_transform_mono_matches_reference(case):
    """State transform and map transform: ids and lists exact, values to
    1e-12 of each array's largest magnitude; the new gauge pin is exact."""
    new_ref, new_scap, new_fix = GAUGES[case]
    lm = mono_map(5)
    x = one_lane_map(lm)
    tp, tf, ts = tgauge.transform_state_mono(
        x.pose_ids, x.poses, x.feats, ids(new_ref), ids(new_scap),
        ids(new_fix))
    jp, jf, js = jgauge.transform_state_mono(lm.pose_ids, lm.poses, lm.feats,
                                             new_ref, new_scap, new_fix)
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp), atol=1e-12)
    np.testing.assert_allclose(tf[0].numpy(), np.asarray(jf), atol=1e-12)
    assert float(ts[0]) == float(js)
    rs, ss = slot_of(lm.pose_ids, new_ref), slot_of(lm.pose_ids, new_scap)
    assert (tp[0, rs] == 0).all()
    assert float(tp[0, ss, new_fix]) == float(ts[0])

    want = jcong.transform_map_mono(lm, new_ref, new_scap, new_fix)
    got = tcong.transform_map_mono(x, ids(new_ref), ids(new_scap),
                                   ids(new_fix))
    _assert_maps_close(types.lanes(got, 0), want, tol=1e-12)


def test_transform_map_mono_lanes_are_independent():
    """One stacked call over lanes of both projection kinds (r_slot == p2,
    s_slot == p1) equals one call per lane, exactly."""
    lms = [mono_map(11), mono_map(12)]
    ku = max(lm.KU for lm in lms)
    kw = max(lm.KW for lm in lms)
    lms = [lm.pad_to(KU=ku, KW=kw) for lm in lms]
    gauges = [GAUGES["old ref is the new scap (r_slot == p2)"],
              GAUGES["old scap is the new ref (s_slot == p1)"]]
    both = tcong.transform_map_mono(
        types.stack([types.to_torch(lm, CPU) for lm in lms]),
        *(ids(*col) for col in zip(*gauges)))
    for k, (lm, gk) in enumerate(zip(lms, gauges)):
        one = tcong.transform_map_mono(one_lane_map(lm),
                                       *(ids(v) for v in gk))
        a, b = types.lanes(both, k), types.lanes(one, 0)
        for f in types.MAP_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        for f in types.GAUGE_FIELDS:
            assert torch.equal(getattr(a.gauge, f), getattr(b.gauge, f)), f


def test_mono_transform_involution():
    """Transforming back restores the state (1e-9) and the gauge-reduced
    information: the transform collapses the 7 gauge dimensions (ref block,
    pinned scale coordinate), which the solver deletes."""
    lm = mono_map(5)
    out = tcong.transform_map_mono(one_lane_map(lm), ids(3), ids(4), ids(1))
    o = types.to_numpy(types.lanes(out, 0))
    np.testing.assert_array_equal(o.poses[slot_of(o.pose_ids, 3)], 0.0)
    assert abs(abs(o.poses[slot_of(o.pose_ids, 4), 1]) - 1.0) < 1e-12
    back = types.to_numpy(types.lanes(
        tcong.transform_map_mono(out, ids(0), ids(1), ids(2)), 0))
    np.testing.assert_allclose(back.poses, np.asarray(lm.poses), atol=1e-9)
    np.testing.assert_allclose(back.feats, np.asarray(lm.feats), atol=1e-9)
    I0, I2 = H.densify_info(lm), H.densify_info(back)
    keep = np.ones(I0.shape[0], bool)
    keep[0:6] = False          # ref (id 0) in slot 0
    keep[6 + 2] = False        # scap (id 1) in slot 1, fix 2
    np.testing.assert_allclose(I2[np.ix_(keep, keep)], I0[np.ix_(keep, keep)],
                               atol=1e-6, rtol=1e-6)


def test_mono_congruence_matches_dense():
    """I' = J^T I J with J = d(old)/d(new) (jacfwd of the reference's
    whole-state map at the new state with the old gauge) and the
    gauge-conditioning projection applied to J's columns, against the
    emitted blocks."""
    lm = mono_map(6)
    I_old = H.densify_info(lm)
    new_ref, new_scap, new_fix = 2, 3, 0
    out = types.to_numpy(types.lanes(tcong.transform_map_mono(
        one_lane_map(lm), ids(new_ref), ids(new_scap), ids(new_fix)), 0))
    r, s = slot_of(out.pose_ids, 0), slot_of(out.pose_ids, 1)
    x_new = jnp.asarray(H.state_vector(out))
    J = np.array(jax.jacfwd(lambda x: H.full_state_map_mono(
        x, lm.M, lm.N, r, s, 2))(x_new))
    p1, p2 = slot_of(out.pose_ids, new_ref), slot_of(out.pose_ids, new_scap)
    J[:, 6 * p1:6 * p1 + 6] = 0.0
    J[:, 6 * p2 + new_fix] = 0.0
    np.testing.assert_allclose(H.densify_info(out), J.T @ I_old @ J,
                               atol=1e-7, rtol=1e-7)


# ---------------------------------------------------------------------------
# join
# ---------------------------------------------------------------------------

def _join_pair():
    """Two mono maps in one gauge (ref 0, scap 1, fix 2) with shared
    features, b's other poses renamed (tests/test_join.py), and scale-pose
    angles that need the wraparound."""
    rng = np.random.default_rng(12)
    a = H.random_mono_map(rng, M=4, N=6, pose_id0=0, feat_id0=1000, fix=2)
    b = H.random_mono_map(rng, M=4, N=6, pose_id0=0, feat_id0=1003, fix=2)
    pa, pb = np.array(a.poses), np.array(b.poses)
    pa[1, 3] = 3.3             # wraps to 3.3 - 2 pi
    pb[1, 3] = -3.2            # wraps, then shifts back against a's angle
    a = dataclasses.replace(a, poses=jnp.asarray(pa))
    b = dataclasses.replace(b, poses=jnp.asarray(pb),
                            pose_ids=jnp.asarray(np.array([0, 1, 12, 13]),
                                                 jnp.int32))
    return a, b


@pytest.mark.parametrize("method,pin", [("refine", "sign"),
                                        ("direct", "sign"),
                                        ("direct", "zero")])
def test_join_mono_matches_reference(method, pin):
    """Ids and block lists exact, solved states to 1e-9, the pinned
    coordinate exactly at sign, dead slots and counts as the reference's."""
    a, b = _join_pair()
    kw = dict(method=method, pin=pin, refine_iters=4, with_res=True,
              max_obs=8, dense_schur=True)
    want, res_j = jjoin.join_mono(a, b, jjoin.JoinConfig(**kw))
    got, res_t = tjoin.join_mono(one_lane_map(a), one_lane_map(b),
                                 tjoin.JoinConfig(**kw))
    g = types.to_numpy(types.lanes(got, 0))
    for f in ("pose_ids", "feat_ids", "Uij", "Wpf", "n_poses", "n_feats",
              "U", "W", "V"):
        np.testing.assert_array_equal(getattr(g, f),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in types.GAUGE_FIELDS:
        assert int(getattr(g.gauge, f)) == int(getattr(want.gauge, f)), f
    np.testing.assert_allclose(g.poses, np.asarray(want.poses), atol=1e-9)
    np.testing.assert_allclose(g.feats, np.asarray(want.feats), atol=1e-9)
    assert list(g.pose_ids) == [0, 1, 2, 3, -1, -1, 12, 13]
    assert int(g.n_poses) == 4 + 4 - 2
    assert g.poses[1, 2] == 1.0                 # scap (slot 1), fix 2, sign +1
    np.testing.assert_array_equal(g.poses[0], 0.0)   # the reference block
    if method == "refine":
        assert float(res_t[0]) < 1e-10 and float(res_j) < 1e-10
    else:
        assert np.isnan(float(res_t[0])) and np.isnan(float(res_j))


@pytest.mark.parametrize("form", ["default", "max_obs"])
def test_join_mono_default_config_is_direct(form, monkeypatch):
    """`join_mono(a, b)` and `join_mono(a, b, JoinConfig(max_obs=8))` take
    the JAX package's exact direct solve: no PCG call
    (`schur.solve_full_mixed`), states within 1e-9 of the reference's."""
    a, b = _join_pair()
    args = () if form == "default" else (tjoin.JoinConfig(max_obs=8),)
    jargs = () if form == "default" else (jjoin.JoinConfig(max_obs=8),)
    pcg = []
    solve = tschur.solve_full_mixed
    monkeypatch.setattr(tschur, "solve_full_mixed",
                        lambda *a, **k: pcg.append(1) or solve(*a, **k))
    got = types.to_numpy(types.lanes(
        tjoin.join_mono(one_lane_map(a), one_lane_map(b), *args), 0))
    want = jjoin.join_mono(a, b, *jargs)
    assert not pcg
    np.testing.assert_array_equal(got.pose_ids, np.asarray(want.pose_ids))
    np.testing.assert_allclose(got.poses, np.asarray(want.poses), atol=1e-9)
    np.testing.assert_allclose(got.feats, np.asarray(want.feats), atol=1e-9)


def test_local_map_helpers_match_reference():
    """The LocalMap helpers u_mask, w_mask, ref_slot, scap_slot and pad_to
    give the reference's answers (ref 3, scap 4: not the first slots)."""
    lm = H.random_mono_map(np.random.default_rng(4), M=6, N=5, pose_id0=0,
                           ref_id=3, scap_id=4)
    jl = lm.pad_to(M=8, N=9, KU=lm.KU + 3, KW=lm.KW + 2)
    tl = types.host_fields(lm).pad_to(M=8, N=9, KU=lm.KU + 3, KW=lm.KW + 2)
    for f in types.MAP_FIELDS:
        np.testing.assert_array_equal(getattr(tl, f),
                                      np.asarray(getattr(jl, f)), err_msg=f)
    assert types.host_fields(lm).pad_to().M == lm.M
    w = types.to_torch(jl, CPU)
    for f in ("u_mask", "w_mask", "ref_slot", "scap_slot"):
        np.testing.assert_array_equal(getattr(w, f)().numpy(),
                                      np.asarray(getattr(jl, f)()), err_msg=f)
    assert int(w.ref_slot()) == 3 and int(w.scap_slot()) == 4
    st = one_lane_map(jl)
    assert st.u_mask().shape == (1, jl.KU) and st.ref_slot().tolist() == [3]


@pytest.mark.parametrize("dense", [True, False])
def test_join_mono_refine_needs_sign_pin(dense):
    """Refine without the sign pin: the PCG needs pin="sign", so refine
    with pin="zero" solves the reduced system with an f32 factor and
    refinement sweeps (`solve.solve_reduced`), as the reference does; it no
    longer raises. Dense and grouped assembly: states within 1e-9 of the
    reference, no residual (NaN), the pinned coordinate at sign."""
    a, b = _join_pair()
    kw = dict(method="refine", pin="zero", refine_iters=4, with_res=True,
              max_obs=8, dense_schur=dense)
    want, res_j = jjoin.join_mono(a, b, jjoin.JoinConfig(**kw))
    got, res_t = tjoin.join_mono(one_lane_map(a), one_lane_map(b),
                                 tjoin.JoinConfig(**kw))
    g = types.to_numpy(types.lanes(got, 0))
    np.testing.assert_array_equal(g.pose_ids, np.asarray(want.pose_ids))
    np.testing.assert_allclose(g.poses, np.asarray(want.poses), atol=1e-9)
    np.testing.assert_allclose(g.feats, np.asarray(want.feats), atol=1e-9)
    assert g.poses[1, 2] == 1.0
    assert np.isnan(float(res_t[0])) and np.isnan(float(res_j))


# ---------------------------------------------------------------------------
# ingest, plan and the tree
# ---------------------------------------------------------------------------

def test_compact_stack_and_plan_match_reference_mono():
    """11 mono maps (seed 5): stacked arrays, gauge fields and the exact
    level plans equal the reference's."""
    maps, _, _ = gen.make_dataset(11, "mono", noise=0.01, seed=5)
    sj = jcompact.compact_stack([m.to_local_map() for m in maps], 16, 64)
    st = tcompact.compact_stack(maps, 16, 64)
    for f in types.MAP_FIELDS:
        np.testing.assert_array_equal(getattr(st, f),
                                      np.asarray(getattr(sj, f)), err_msg=f)
    for f in types.GAUGE_FIELDS:
        np.testing.assert_array_equal(getattr(st.gauge, f),
                                      np.asarray(getattr(sj.gauge, f)))
    pj = jplan.plan_tree_exact(jplan.sym_of_stacked(sj), "mono", 16, 64)
    pt = tplan.plan_tree_exact(tplan.sym_of_stacked(st), "mono", 16, 64)
    assert len(pt.levels) == len(pj.levels) == 4
    for lt, lj in zip(pt.levels, pj.levels):
        assert dataclasses.astuple(lt) == dataclasses.astuple(lj)
    assert (pt.root_regauge, pt.root_caps) == (pj.root_regauge, pj.root_caps)


MONO_TOP = dict(method="refine", top_min_m=8, top_iters=16)
MONO_TREES = {
    "refine": dict(method="refine"),
    "direct": dict(method="direct"),
    # the top band from 8 joined poses (levels 3-4 of 4): the PCG with the
    # scale pin, its exit and escalation reads, with and without the early
    # exit
    "refine top band early exit": MONO_TOP,
    "refine top band fixed trips": dict(MONO_TOP, pcg_exit_tol=0.0),
}


@pytest.mark.parametrize("method", list(MONO_TREES))
def test_device_tree_mono_matches_reference(method):
    """11 mono maps (seed 5; odd carry at three levels, re-gauge lanes):
    the same slots in the same order, poses and features to 1e-9."""
    n = 11
    kw = MONO_TREES[method]
    maps, _, _ = gen.make_dataset(n, "mono", noise=0.01, seed=5)
    a = JaxTree("mono", **kw).run([m.to_local_map() for m in maps])
    metrics = LevelMetrics()
    solver = TorchTree("mono", device=CPU, **kw)
    b = types.to_numpy(solver.run(maps, metrics=metrics, time_levels=True))
    np.testing.assert_array_equal(b.pose_ids, np.asarray(a.pose_ids))
    np.testing.assert_array_equal(b.feat_ids, np.asarray(a.feat_ids))
    np.testing.assert_allclose(b.poses, np.asarray(a.poses), atol=1e-9)
    np.testing.assert_allclose(b.feats, np.asarray(a.feats), atol=1e-9)
    # every pose id of the set, pose 0 (the frame) an explicit block
    assert sorted(int(i) for i in b.pose_ids if i >= 0) == list(range(n + 2))
    assert solver.join_count == n - 1
    assert [r["level"] for r in metrics.records] == [1, 2, 3, 4]
    if kw["method"] == "refine":
        assert max(r["res_max"] for r in metrics.records) < 1e-10
    if "top_min_m" in kw:        # the band's joins, and only they, read
        top = [lp.join_m >= kw["top_min_m"]
               for lp in solver.prepare(maps)[0].levels]
        assert top == [False, False, True, True]
        spans = solver.last_spans
        joins = [i for i, sp in enumerate(spans) if sp["name"] == "join"]
        reads = [sum(sp["name"] == "sync" and sp["parent"] == i
                     for sp in spans) for i in joins]
        assert [r > 0 for r in reads] == top


@pytest.mark.parametrize("method", ["direct", "refine"])
def test_device_tree_mono_pin_zero_matches_reference(method, monkeypatch):
    """The reference's positional call form with pin="zero" (the reference
    C++ solver's column drop) on the 11-map mono set: every join gets the
    pin, refine solves the reduced system (an f32 factor with refinement
    sweeps, no PCG), and the slots, poses and features are within 1e-9 of
    the JAX package's."""
    n = 11
    maps, _, _ = gen.make_dataset(n, "mono", noise=0.01, seed=5)
    a = JaxTree("mono", method, 3, 16, 64, "zero").run(
        [m.to_local_map() for m in maps])
    pins, pcg = [], []
    join, solve = tjoin.join_mono, tschur.solve_full_mixed
    monkeypatch.setattr(tjoin, "join_mono",
                        lambda e, c, cfg: pins.append(cfg.pin) or join(e, c,
                                                                       cfg))
    monkeypatch.setattr(tschur, "solve_full_mixed",
                        lambda *a, **k: pcg.append(1) or solve(*a, **k))
    solver = TorchTree("mono", method, 3, 16, 64, "zero", device=CPU)
    b = types.to_numpy(solver.run(maps))
    assert set(pins) == {"zero"} and not pcg
    np.testing.assert_array_equal(b.pose_ids, np.asarray(a.pose_ids))
    np.testing.assert_array_equal(b.feat_ids, np.asarray(a.feat_ids))
    np.testing.assert_allclose(b.poses, np.asarray(a.poses), atol=1e-9)
    np.testing.assert_allclose(b.feats, np.asarray(a.feats), atol=1e-9)


def test_device_tree_mono_recovers_noise_free_truth():
    """Noise-free mono maps (5, seed 13, tests/test_solve.py): the fusion
    reproduces the scale-normalised ground truth."""
    maps, poses_gt, _ = gen.make_dataset(5, "mono", noise=0.0, seed=13)
    out = types.to_numpy(TorchTree("mono", device=CPU).run(maps))
    got = {int(i): out.poses[s] for s, i in enumerate(out.pose_ids) if i >= 0}
    assert sorted(got) == list(range(7))
    for pid, p in got.items():
        np.testing.assert_allclose(p, poses_gt[pid], atol=1e-6)
