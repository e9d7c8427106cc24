"""PyTorch port vs the JAX reference: the dense planned executor.

The same numpy inputs (seeded generators, synth/) go through a
`linearsfm_tpu` function and its `linearsfm_tpu_torch` counterpart on the
CPU: the host layout planner (`core/layout`), the single-map densify, the
dense gauge transforms, information vectors and fusion solve (`ops/dense`;
the reference's functions take one map, the port's take lanes, so each lane
is held against its own reference call), the whole `DenseTreeSolver`, the
dense executor through `pipeline.run` and the CLI, and the FLOP model
(`utils/flops`). The tree cases reuse tests/test_dense_tree.py's
configurations, so the machine-local compile cache can serve the reference
side. The `cuda` tests run the solve, one tree level and kernel K2 on a
dense W list on the card.
"""

import logging
import os

import numpy as np
import pytest
import torch

from synth import generate as gen
from linearsfm_tpu_torch import cli as tcli
from linearsfm_tpu_torch.core import compact as tcompact
from linearsfm_tpu_torch.core import dense_tree as tdt
from linearsfm_tpu_torch.core import layout as tlayout
from linearsfm_tpu_torch.core import pipeline as tpipeline
from linearsfm_tpu_torch.core import plan as tplan
from linearsfm_tpu_torch.core.tree import TreeSolver
from linearsfm_tpu_torch.io import localmap as tio
from linearsfm_tpu_torch.ops import dense as tdense
from linearsfm_tpu_torch.ops import kernels
from linearsfm_tpu_torch.utils import flops as tflops
from linearsfm_tpu_torch.utils.metrics import LevelMetrics

# one intra-op thread: the suite's workers share the machine's cores, and
# an oversubscribed thread pool slows the trees' small ops many times over
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture
def reference():
    """The JAX package's modules, as this module's globals. They are
    imported here, not at collection, so that the `cuda` tests run on a
    machine without JAX (`--noconftest -m cuda`)."""
    global jax, jnp, jcompact, jdt, jlayout, jpipeline, jplan, jdense, jflops
    global _same_text
    import jax
    import jax.numpy as jnp
    from test_torch_pipeline import _same_text
    from linearsfm_tpu.core import compact as jcompact
    from linearsfm_tpu.core import dense_tree as jdt
    from linearsfm_tpu.core import layout as jlayout
    from linearsfm_tpu.core import pipeline as jpipeline
    from linearsfm_tpu.core import plan as jplan
    from linearsfm_tpu.ops import dense as jdense
    from linearsfm_tpu.utils import flops as jflops


def _by_id(ids, vals):
    return {int(i): np.asarray(vals)[s]
            for s, i in enumerate(np.asarray(ids)) if i >= 0}


def _max_pose_diff(a, b):
    pa, pb = _by_id(a.pose_ids, a.poses), _by_id(b.pose_ids, b.poses)
    assert set(pa) == set(pb)
    fa, fb = _by_id(a.feat_ids, a.feats), _by_id(b.feat_ids, b.feats)
    assert set(fa) == set(fb)
    return max(max(float(np.abs(pa[k] - pb[k]).max()) for k in pa),
               max(float(np.abs(fa[k] - fb[k]).max()) for k in fa))


# ---------------------------------------------------------------------------
# host layout planner
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("reference")
@pytest.mark.parametrize("typ,n", [("stereo", 13), ("stereo", 88),
                                   ("mono", 11), ("mono", 88)])
def test_plan_dense_tree_matches_reference(typ, n):
    """Every level's bundle arrays, caps and re-gauge flags, the re-gauge
    slots, the per-level input layouts and the root: equal, array for
    array."""
    maps, _, _ = gen.make_dataset(n, typ, noise=0.01, seed=2)
    lms = [jcompact.compact(m.to_local_map(), 1, 1) for m in maps]
    want = jlayout.plan_dense_tree([jlayout.layout_of(lm) for lm in lms],
                                   typ, bucket=16)
    got = tlayout.plan_dense_tree(
        [tlayout.layout_of(tcompact.compact(m, 1, 1)) for m in maps], typ,
        bucket=16)

    def same_layout(a, b):
        np.testing.assert_array_equal(a.pose_ids, b.pose_ids)
        np.testing.assert_array_equal(a.feat_ids, b.feat_ids)
        for f in ("ref", "scap", "fix", "fref", "fscap", "ffix"):
            assert getattr(a, f) == getattr(b, f), f

    assert len(got.levels) == len(want.levels) > 2
    for lg, lw in zip(got.levels, want.levels):
        assert (lg.count, lg.caps_in, lg.caps_out, lg.regauge) == \
            (lw.count, lw.caps_in, lw.caps_out, lw.regauge)
        assert set(lg.bundle) == set(lw.bundle)
        for k in lw.bundle:
            assert lg.bundle[k].dtype == lw.bundle[k].dtype, k
            np.testing.assert_array_equal(lg.bundle[k], lw.bundle[k], k)
        assert (lg.rg_bundle is None) == (lw.rg_bundle is None)
        if lw.rg_bundle is not None:
            np.testing.assert_array_equal(lg.rg_bundle["slots"],
                                          lw.rg_bundle["slots"])
    for lay_g, lay_w in zip(got.layouts, want.layouts):
        for a, b in zip(lay_g, lay_w):
            same_layout(a, b)
    same_layout(got.root, want.root)
    assert (got.root_regauge, got.root_slots) == (want.root_regauge,
                                                 want.root_slots)
    assert any(any(lp.regauge) for lp in got.levels)


@pytest.mark.usefixtures("reference")
@pytest.mark.parametrize("typ", ["stereo", "mono"])
def test_densify_matches_reference(typ):
    """The single-map host densify, exactly, in float64."""
    maps, _, _ = gen.make_dataset(5, typ, noise=0.01, seed=3)
    for m in maps[:3]:
        lm = jcompact.compact(m.to_local_map(), 1, 1)
        Mc, Nc = int(lm.n_poses) + 3, int(lm.n_feats) + 5
        want = jdt.densify(lm, Mc, Nc)
        got = tdt.densify(tcompact.compact(m, 1, 1), Mc, Nc)
        for a, b in zip(got, want):
            assert a.dtype == np.float64
            np.testing.assert_array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# dense transforms, information vectors, solve
# ---------------------------------------------------------------------------

def _random_dense(seed, P=2, M=7, N=9):
    """Lane-stacked random dense maps (numpy): states of moderate size,
    symmetric A, V and dense Wd; mono signs +-1."""
    rng = np.random.default_rng(seed)
    poses = rng.standard_normal((P, M, 6)) * [2, 2, 2, 0.4, 0.4, 0.4]
    feats = rng.standard_normal((P, N, 3)) * 3
    A = rng.standard_normal((P, 6 * M, 6 * M))
    A = (A + A.transpose(0, 2, 1)).reshape(P, M, 6, M, 6)
    Wd = rng.standard_normal((P, M, N, 6, 3))
    V = rng.standard_normal((P, N, 3, 3))
    V = V + V.transpose(0, 1, 3, 2)
    sign = np.array([1.0, -1.0] * P)[:P]
    return dict(poses=poses, feats=feats, A=A, Wd=Wd, V=V, sign=sign)


def _jax_lane(fields, p, idt):
    """Lane p of the fields as the reference's one-map DenseMap."""
    f = {k: jnp.asarray(v[p]) for k, v in fields.items()}
    for k in ("A", "Wd", "V"):
        f[k] = f[k].astype(idt)
    return jdense.DenseMap(**f)


def _close(got, want, dtype):
    want = np.asarray(want)
    if dtype == torch.float64:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    else:
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


# lane 0 and lane 1 take different slots; the mono lanes cover rs == p1 and
# rs == p2 (rs, ss: old ref/scap; p1, p2: new ref/scap; old/new fix)
SLOTS = {"stereo": [(3,), (5,)],
         "mono": [(2, 4, 2, 6, 1, 0), (1, 3, 5, 1, 2, 2)]}


@pytest.mark.usefixtures("reference")
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("typ", ["stereo", "mono"])
def test_transform_dense_matches_reference(typ, dtype):
    """transform_dense_{stereo,mono} on two lanes with different slots
    against the reference's one-map transform vmapped over the lanes, as
    its executor runs it: states and information to 1e-10 in float64,
    rtol 1e-5 in float32."""
    fields = _random_dense(11)
    dm = tdense.DenseMap.from_numpy(fields, CPU)
    slots = torch.tensor(SLOTS[typ])
    idt = jnp.float64 if dtype == torch.float64 else jnp.float32
    if typ == "stereo":
        got = tdense.transform_dense_stereo(dm, slots[:, 0], info_dtype=dtype)
        one = lambda d, s: jdense.transform_dense_stereo(  # noqa: E731
            d, s[0], info_dtype=idt)
    else:
        got = tdense.transform_dense_mono(dm, *slots.unbind(1),
                                          info_dtype=dtype)
        one = lambda d, s: jdense.transform_dense_mono(  # noqa: E731
            d, *(s[k] for k in range(6)), info_dtype=idt)
    want = jax.jit(jax.vmap(one))(
        jdense.DenseMap(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jnp.asarray(SLOTS[typ]))
    for f in ("poses", "feats", "sign"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-12, err_msg=f)
    for f in ("A", "Wd", "V"):
        t = getattr(got, f)
        assert t.dtype == dtype, f
        _close(t.numpy(), getattr(want, f), dtype)


@pytest.mark.usefixtures("reference")
def test_info_vector_dense_matches_reference():
    fields = _random_dense(12)
    eP, eF = tdense.info_vector_dense(tdense.DenseMap.from_numpy(fields, CPU),
                                      torch.float64)
    for p in range(2):
        wP, wF = jdense.info_vector_dense(_jax_lane(fields, p, jnp.float64),
                                          jnp.float64)
        np.testing.assert_allclose(eP[p].numpy(), np.asarray(wP), atol=1e-11)
        np.testing.assert_allclose(eF[p].numpy(), np.asarray(wF), atol=1e-11)


def _spd_system(seed, P=2, M=6, N=10):
    """Positive definite dense systems with a padded last pose slot (zero
    rows and columns, gauge-fixed) and their right-hand sides."""
    rng = np.random.default_rng(seed)
    Wd = rng.standard_normal((P, M, N, 6, 3))
    V = rng.standard_normal((P, N, 3, 3))
    V = V @ V.transpose(0, 1, 3, 2) + 4 * np.eye(3)
    G = rng.standard_normal((P, 6 * M, 6 * M))
    Vi = np.linalg.inv(V)
    YW = np.einsum("pmnif,pnfg,pqnjg->pmiqj", Wd, Vi, Wd).reshape(
        P, 6 * M, 6 * M)
    A = G @ G.transpose(0, 2, 1) + YW + 30 * np.eye(6 * M)
    A = A.reshape(P, M, 6, M, 6)
    A[:, -1], A[:, :, :, -1] = 0.0, 0.0
    Wd[:, -1] = 0.0
    eP = rng.standard_normal((P, M, 6))
    eP[:, -1] = 0.0
    eF = rng.standard_normal((P, N, 3))
    fixed = np.zeros((P, 6 * M), bool)
    fixed[:, -6:] = True
    return A, Wd, V, eP, eF, fixed


@pytest.mark.usefixtures("reference")
@pytest.mark.parametrize("method,pin", [("direct", False), ("refine", False),
                                        ("refine", True), ("direct", True)])
def test_solve_dense_matches_reference(method, pin):
    """solve_dense over two lanes against the reference's per-lane solve:
    direct (float64) to 1e-9, refine (f32 factor, three f64 sweeps) to 1e-9,
    with and without the mono pin (a gauge block and one pinned
    coordinate per lane, pinned to +1 and -1)."""
    A, Wd, V, eP, eF, fixed = _spd_system(21)
    fixc = sign = None
    if pin:
        fixed[:, 0:6] = True                      # the new reference block
        fixc = np.array([6 * 2 + 1, 6 * 3 + 0])
        fixed[np.arange(2), fixc] = True
        sign = np.array([1.0, -1.0])
    t = [torch.as_tensor(a) for a in (A, Wd, V, eP, eF, fixed)]
    xp, xf = tdense.solve_dense(
        *t, method=method, refine_iters=3,
        fixc=None if fixc is None else torch.as_tensor(fixc),
        sign=None if sign is None else torch.as_tensor(sign))
    for p in range(2):
        wp, wf = jdense.solve_dense(
            jnp.asarray(A[p]), jnp.asarray(Wd[p]), jnp.asarray(V[p]),
            jnp.asarray(eP[p]), jnp.asarray(eF[p]), jnp.asarray(fixed[p]),
            method=method, refine_iters=3,
            fixc=None if fixc is None else int(fixc[p]),
            sign=None if sign is None else float(sign[p]))
        np.testing.assert_allclose(xp[p].numpy(), np.asarray(wp), atol=1e-9)
        np.testing.assert_allclose(xf[p].numpy(), np.asarray(wf), atol=1e-9)
        if pin:
            assert float(xp[p].reshape(-1)[fixc[p]]) == sign[p]


@pytest.mark.usefixtures("reference")
def test_dense_map_from_numpy_carries_reference_fields():
    """A reference DenseMap's fields as numpy arrays become a one-lane
    DenseMap of the same values and dtypes."""
    fields = _random_dense(13, P=1)
    one = _jax_lane(fields, 0, jnp.float32)
    dm = tdense.DenseMap.from_numpy({k: np.asarray(v) for k, v in
                                     one._asdict().items()}, CPU)
    assert dm.M == 7 and dm.N == 9 and dm.poses.shape == (1, 7, 6)
    for f in tdense.DenseMap._fields:
        a, b = getattr(dm, f)[0].numpy(), np.asarray(getattr(one, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the whole executor
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("reference")
@pytest.mark.parametrize("typ,n", [("stereo", 8), ("stereo", 13),
                                   ("mono", 11)])
def test_dense_tree_direct_matches_reference(typ, n):
    """DenseTreeSolver(method="direct") against the JAX package's and
    against the port's host executor, poses and features to 1e-9; the odd
    counts exercise the carry."""
    maps, _, _ = gen.make_dataset(n, typ, noise=0.01, seed=5)
    metrics = LevelMetrics()
    solver = tdt.DenseTreeSolver(typ, method="direct", device=CPU)
    got = solver.run(maps, metrics=metrics, time_levels=True)
    want = jdt.DenseTreeSolver(typ, method="direct").run(
        [m.to_local_map() for m in maps])
    assert _max_pose_diff(got, want) < 1e-9
    host = TreeSolver(typ, method="direct", device=CPU).run(maps)
    assert _max_pose_diff(got, host) < 1e-9
    for f in ("ref", "scap", "fix", "fref"):
        assert int(getattr(got.gauge, f)) == int(getattr(want.gauge, f)), f
    assert int(got.n_poses) == int(want.n_poses)
    assert solver.join_count == n - 1
    assert [r["level"] for r in metrics.records] == list(
        range(1, len(metrics.records) + 1))
    assert all(r["fused"] and r["exec_wall"] >= 0 for r in metrics.records)
    assert set(solver._last_timing) == {"prep", "upload", "levels", "get"}


# The smallest tolerances that hold over seeds 9, 10 and 11 (largest port
# vs reference difference measured on the CPU: stereo 5.6e-13 and 1.8e-4,
# mono 7.7e-12 and 1.8e-3, for mixed_max_m 0 and 32)
REFINE_ATOL = {("stereo", 0): 1e-12, ("stereo", 32): 2e-4,
               ("mono", 0): 1e-11, ("mono", 32): 2e-3}


@pytest.mark.usefixtures("reference")
@pytest.mark.parametrize("mixed", [0, 32])
@pytest.mark.parametrize("typ,n", [("stereo", 12), ("mono", 11)])
def test_dense_tree_refine_matches_reference(typ, n, mixed):
    """method="refine" with f64 information everywhere (mixed_max_m=0: f32
    factor, three f64 sweeps) and with the default policy (f32 information
    up to 32 joined poses, whose rounding the two packages' f32 products
    take in different orders) against the JAX package's."""
    maps, _, _ = gen.make_dataset(n, typ, noise=0.01, seed=9)
    got = tdt.DenseTreeSolver(typ, method="refine", mixed_max_m=mixed,
                              device=CPU).run(maps)
    want = jdt.DenseTreeSolver(typ, method="refine", mixed_max_m=mixed).run(
        [m.to_local_map() for m in maps])
    assert _max_pose_diff(got, want) < REFINE_ATOL[typ, mixed]


@pytest.mark.usefixtures("reference")
def test_dense_tree_single_map_and_bad_datatype():
    maps, _, _ = gen.make_dataset(1, "stereo", noise=0.01, seed=5)
    out = tdt.DenseTreeSolver("stereo", device=CPU).run(maps)
    want = jcompact.compact(maps[0].to_local_map(), 1, 1)
    np.testing.assert_array_equal(out.poses, np.asarray(want.poses))
    with pytest.raises(ValueError, match="datatype"):
        tdt.DenseTreeSolver("rgbd", device=CPU)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("reference")
def test_pipeline_and_cli_dense_match_reference(tmp_path, capsys, caplog):
    """`pipeline.run(executor="dense")` and `cli.main([..., "--exec",
    "dense"])` on a written stereo set (8 maps, seed 0): pose, feature and
    state files equal to the JAX pipeline's at printed precision; a
    checkpoint directory is warned about and ignored."""
    maps, _, _ = gen.make_dataset(8, "stereo", noise=0.01, seed=0)
    data = str(tmp_path / "data")
    tio.write_dataset(maps, data)
    files = {name: {k: str(tmp_path / f"{k}_{name}.txt")
                    for k in ("p", "f", "st")}
             for name in ("reference", "pipeline", "cli")}
    jpipeline.run(data, 8, "stereo", st_path=files["reference"]["st"],
                  pose_path=files["reference"]["p"],
                  feat_path=files["reference"]["f"], progress=False,
                  executor="dense")
    ckpt = str(tmp_path / "ckpt")
    with caplog.at_level(logging.WARNING, logger="linearsfm_tpu_torch"):
        tpipeline.run(data, 8, "stereo", st_path=files["pipeline"]["st"],
                      pose_path=files["pipeline"]["p"],
                      feat_path=files["pipeline"]["f"], progress=False,
                      ckpt_dir=ckpt, resume=True, executor="dense",
                      device="cpu")
    assert "ignoring" in caplog.text and not os.path.exists(ckpt)
    rc = tcli.main(["-path", data, "-num", "8", "-type", "Stereo",
                    "-p", files["cli"]["p"], "-f", files["cli"]["f"],
                    "-st", files["cli"]["st"], "--exec", "dense", "--cpu",
                    "--quiet", "--check"])
    assert rc == 0 and "LinearSFM Check: OK" in capsys.readouterr().out
    for name in ("pipeline", "cli"):
        for k in ("p", "f", "st"):
            _same_text(files[name][k], files["reference"][k])


# ---------------------------------------------------------------------------
# the FLOP model
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("reference")
@pytest.mark.parametrize("typ", ["stereo", "mono"])
def test_flops_model_matches_reference(typ):
    """tree_cost and level_cost on the port's plan equal the reference's on
    its plan (88 maps); mfu divides by the H100's f32 peak."""
    maps, _, _ = gen.make_dataset(88, typ, noise=0.01, seed=2)
    tp = tplan.plan_tree_exact(tplan.sym_of_stacked(
        tcompact.compact_stack(maps, 16, 64)), typ, 16, 64)
    jp = jplan.plan_tree_exact(jplan.sym_of_stacked(
        jcompact.compact_stack([m.to_local_map() for m in maps], 16, 64)),
        typ, 16, 64)

    def iters(m):
        return 16 if m >= 64 else 3
    got, want = tflops.tree_cost(tp, typ, iters), jflops.tree_cost(jp, typ,
                                                                    iters)
    names = dict(f32="mxu_f32", f64="vpu_f64", bytes="hbm_bytes")
    assert len(got["levels"]) == len(want["levels"]) > 3
    for k, w in names.items():
        assert got[k] == want[w] > 0
        for a, b in zip(got["levels"], want["levels"]):
            assert a[k] == b[w]
    for lp_t, lp_j in zip(tp.levels, jp.levels):
        a = tflops.level_cost(lp_t, typ, 5)
        b = jflops.level_cost(lp_j, typ, 5)
        assert {k: a[k] for k in names} == {k: b[w] for k, w in names.items()}
    m = tflops.mfu(tp, typ, iters, 2.0)
    assert tflops.PEAK_F32 == 67e12
    assert m["mfu_f32"] == pytest.approx(got["f32"] / 2.0 / 67e12, rel=1e-15)
    assert m["achieved_f32_tflops"] == pytest.approx(got["f32"] / 2e12)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("method,pin", [("direct", False), ("refine", True)])
def test_solve_dense_on_cuda(method, pin):
    """solve_dense on the card against the CPU: one K2 launch; 1e-9."""
    dev = _cuda()
    A, Wd, V, eP, eF, fixed = _spd_system(31)
    kw = {}
    if pin:
        fixed[:, 0:6] = True
        kw = dict(fixc=torch.tensor([13, 18]), sign=torch.tensor([1.0, -1.0]))
        fixed[np.arange(2), kw["fixc"].numpy()] = True
    t = [torch.as_tensor(a) for a in (A, Wd, V, eP, eF, fixed)]
    want = tdense.solve_dense(*t, method=method, **kw)
    n0 = kernels.launches["inv3x3_sym"]
    got = tdense.solve_dense(*(a.to(dev) for a in t), method=method,
                             **{k: v.to(dev) for k, v in kw.items()})
    torch.cuda.synchronize()
    assert kernels.launches["inv3x3_sym"] == n0 + 1
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("typ,n", [("stereo", 13), ("mono", 11)])
def test_dense_tree_on_cuda(typ, n):
    """The whole dense tree on the card (direct) against the CPU, and one
    level of it: K1 three times, K2 once per level; 1e-9."""
    dev = _cuda()
    maps, _, _ = gen.make_dataset(n, typ, noise=0.01, seed=5)
    want = tdt.DenseTreeSolver(typ, method="direct", device=CPU).run(maps)
    n1, n2 = kernels.launches["blockcoo_to_dense"], kernels.launches[
        "inv3x3_sym"]
    s = tdt.DenseTreeSolver(typ, method="direct", device=dev)
    got = s.run(maps)
    nlev = len(s._prep[0].levels)
    assert kernels.launches["blockcoo_to_dense"] == n1 + 3
    assert kernels.launches["inv3x3_sym"] == n2 + nlev
    assert _max_pose_diff(got, want) < 1e-9
    # one level: the upload and level 1 on both devices
    c = tdt.DenseTreeSolver(typ, method="direct", device=CPU)
    plan, st, _, bundles = c._prepare(maps)
    x_c = c._level(plan.levels[0], c._upload(st, plan), bundles[0])
    _, _, _, bundles_g = s._prepare(maps)
    x_g = s._level(plan.levels[0], s._upload(st, plan), bundles_g[0])
    for a, b in zip(x_g, x_c):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_inv3x3_wy_on_dense_w_list_on_cuda(dtype):
    """The fused K2 on a dense W viewed as a block list (`entry_pairs`):
    torch.equal to its plain version, both outputs, one launch."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    P, M, N = 3, 40, 77
    B = torch.randn((P, N, 3, 3), generator=g, device=dev, dtype=dtype)
    V = B @ B.mT + 0.1 * torch.eye(3, device=dev, dtype=dtype)
    V[1, 5] = 0.0
    W = torch.randn((P, M * N, 6, 3), generator=g, device=dev, dtype=dtype)
    Wpf = tdense.entry_pairs(P, M, N, dev)
    n0 = kernels.launches["inv3x3_sym"]
    got = kernels.inv3x3_wy(V, W, Wpf)
    want = kernels.inv3x3_wy_ref(V, W, Wpf)
    torch.cuda.synchronize()
    assert kernels.launches["inv3x3_sym"] == n0 + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
