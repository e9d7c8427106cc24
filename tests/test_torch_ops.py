"""PyTorch port vs the JAX reference: leaf math, congruence and the solve.

The same numpy inputs (seeded generators, tests/helpers.py) go through a
`linearsfm_tpu` function and its `linearsfm_tpu_torch` counterpart on the CPU.
Port functions take lane-stacked operands; single maps enter as one lane.
Tolerances are stated per test: float64 paths agree to rounding (1e-12),
float32 assemblies to rtol 1e-5, PCG solutions to what the solve converges to.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import helpers as H
from linearsfm_tpu.ops import congruence as jcong
from linearsfm_tpu.ops import rotations as jrot
from linearsfm_tpu.ops import schur as jschur
from linearsfm_tpu_torch import types
from linearsfm_tpu_torch.ops import congruence as tcong
from linearsfm_tpu_torch.ops import kernels
from linearsfm_tpu_torch.ops import rotations as trot
from linearsfm_tpu_torch.ops import schur as tschur

# one intra-op thread: the suite's workers share the machine's cores, and
# an oversubscribed thread pool slows the trees' small ops many times over
torch.set_num_threads(1)

CPU = torch.device("cpu")


def t64(x):
    return torch.tensor(np.array(x), dtype=torch.float64)


def lane(x, dtype=None):
    """One-lane tensor [1, ...] from a numpy array."""
    t = torch.tensor(np.array(x))
    return (t if dtype is None else t.to(dtype))[None]


def one_lane_map(lm):
    return types.stack([types.to_torch(lm, CPU)])


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------

def test_rotations_match_reference():
    rng = np.random.default_rng(0)
    abg = rng.uniform(-np.pi, np.pi, size=(200, 3))
    R_j = np.asarray(jrot.euler_to_r(jnp.asarray(abg)))
    R_t = trot.euler_to_r(t64(abg)).numpy()
    np.testing.assert_allclose(R_t, R_j, atol=1e-15)
    np.testing.assert_allclose(trot.r_to_euler(t64(R_j)).numpy(),
                               np.asarray(jrot.r_to_euler(jnp.asarray(R_j))),
                               atol=1e-12)
    np.testing.assert_allclose(trot.r_to_euler_t(t64(R_j)).numpy(),
                               np.asarray(jrot.r_to_euler_t(jnp.asarray(R_j))),
                               atol=1e-12)
    R2 = R_j[::-1].copy()
    np.testing.assert_allclose(
        trot.compose_rrt(t64(R_j), t64(R2)).numpy(),
        np.asarray(jrot.compose_rrt(jnp.asarray(R_j), jnp.asarray(R2))),
        atol=1e-15)


@pytest.mark.parametrize("beta", [np.pi / 2, -np.pi / 2])
def test_r_to_euler_singular_branch(beta):
    """cos(beta) = 0 exactly: alpha = 0, beta = +pi/2 whatever the sign
    (bug-compatible), gamma = atan2(R01, R11) — as the reference."""
    rng = np.random.default_rng(1)
    R = np.zeros((5, 3, 3))
    g = rng.uniform(-2, 2, 5)
    s = np.sign(np.sin(beta))
    R[:, 0, 2] = -s                 # R00 = R01 = 0: cos(beta) == 0
    R[:, 1, 0] = np.sin(g) * s
    R[:, 1, 1] = np.cos(g)
    R[:, 2, 0] = np.cos(g) * s
    R[:, 2, 1] = -np.sin(g)
    got = trot.r_to_euler(t64(R)).numpy()
    want = np.asarray(jrot.r_to_euler(jnp.asarray(R)))
    np.testing.assert_array_equal(got[:, 0], 0.0)
    np.testing.assert_allclose(got[:, 1], np.pi / 2, atol=0)
    np.testing.assert_allclose(got, want, atol=1e-15)
    # derivatives stay finite through the masked branch
    J = torch.func.jacfwd(trot.r_to_euler)(t64(R[0]))
    assert torch.isfinite(J).all()


def test_rotation_jacobian_matches_reference():
    abg0 = np.array([0.2, -0.4, 0.9])
    J_t = torch.func.jacfwd(lambda a: trot.r_to_euler(trot.euler_to_r(a)))(
        t64(abg0)).numpy()
    J_j = np.asarray(jax.jacfwd(
        lambda a: jrot.r_to_euler(jrot.euler_to_r(a)))(jnp.asarray(abg0)))
    np.testing.assert_allclose(J_t, J_j, atol=1e-13)
    np.testing.assert_allclose(J_t, np.eye(3), atol=1e-8)


def test_wrap_angles_match_reference():
    x = np.array([0.0, 3.2, -3.3, 6.0, -6.0, 3.15, -3.14159])
    ref = np.array([0.5, -3.0, 3.0, 1.0, -1.0, -3.1, 3.1])
    np.testing.assert_array_equal(trot.wrap_angle_pi(t64(x)).numpy(),
                                  np.asarray(jrot.wrap_angle_pi(jnp.asarray(x))))
    np.testing.assert_array_equal(
        trot.wrap_angle_diff(t64(x), t64(ref)).numpy(),
        np.asarray(jrot.wrap_angle_diff(jnp.asarray(x), jnp.asarray(ref))))


# ---------------------------------------------------------------------------
# gauge transform + congruence
# ---------------------------------------------------------------------------

def _assert_maps_close(got: types.LocalMap, want, tol):
    """Ids and counts exact; float fields to `tol` relative to each array's
    largest magnitude (float64 rounding of the congruence products)."""
    g = types.to_numpy(got)
    for f in ("pose_ids", "feat_ids", "Uij", "Wpf", "n_poses", "n_feats",
              "n_U", "n_W"):
        np.testing.assert_array_equal(getattr(g, f), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("poses", "feats", "U", "W", "V"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(g, f), w, rtol=0,
                                   atol=tol * max(1.0, np.abs(w).max()),
                                   err_msg=f)
    for f in types.GAUGE_FIELDS:
        assert int(getattr(g.gauge, f)) == int(getattr(want.gauge, f)), f


@pytest.mark.parametrize("new_ref", [1, 3, 5])
def test_transform_map_stereo_matches_reference(new_ref):
    rng = np.random.default_rng(3)
    lm = H.random_stereo_map(rng, M=5, N=7, pose_id0=1, ref_id=0)
    want = jcong.transform_map_stereo(lm, new_ref)
    got = tcong.transform_map_stereo(
        one_lane_map(lm), torch.tensor([new_ref]))
    _assert_maps_close(types.lanes(got, 0), want, tol=1e-12)


def test_transform_map_stereo_lanes_are_independent():
    """Three maps as three lanes, each with its own new reference, equal the
    reference transform of each map alone (1e-12)."""
    rng = np.random.default_rng(8)
    lms = [H.random_stereo_map(rng, M=4, N=6, pose_id0=1 + 10 * k, ref_id=10 * k)
           for k in range(3)]
    ku = max(lm.KU for lm in lms)       # zero-block padding to stack them
    lms = [lm.pad_to(KU=ku) for lm in lms]
    refs = [2, 13, 24]
    got = tcong.transform_map_stereo(
        types.stack([types.to_torch(lm, CPU) for lm in lms]),
        torch.tensor(refs))
    for k, (lm, r) in enumerate(zip(lms, refs)):
        _assert_maps_close(types.lanes(got, k),
                           jcong.transform_map_stereo(lm, r), tol=1e-12)


def test_stereo_transform_involution():
    rng = np.random.default_rng(3)
    lm = H.random_stereo_map(rng, M=5, N=7, pose_id0=1, ref_id=0)
    out = tcong.transform_map_stereo(one_lane_map(lm), torch.tensor([3]))
    assert 0 in out.pose_ids[0].tolist()
    back = types.to_numpy(types.lanes(
        tcong.transform_map_stereo(out, torch.tensor([0])), 0))
    o0 = np.argsort(np.asarray(lm.pose_ids))
    o1 = np.argsort(back.pose_ids)
    np.testing.assert_allclose(back.poses[o1], np.asarray(lm.poses)[o0],
                               atol=1e-9)
    np.testing.assert_allclose(back.feats, np.asarray(lm.feats), atol=1e-9)
    np.testing.assert_allclose(H.densify_info(back), H.densify_info(lm),
                               atol=1e-6, rtol=1e-6)


def test_stereo_congruence_matches_dense():
    """I' = J^T I J with J from the reference's jacfwd of the whole-state
    map (tests/test_transform.py), against the port's emitted blocks."""
    rng = np.random.default_rng(4)
    lm = H.random_stereo_map(rng, M=5, N=7, pose_id0=1, ref_id=0)
    I_old = H.densify_info(lm)
    out = types.to_numpy(types.lanes(
        tcong.transform_map_stereo(one_lane_map(lm), torch.tensor([4])), 0))
    r_slot = int(np.argmax(out.pose_ids == 0))
    x_new = H.state_vector(out)
    J = np.asarray(jax.jacfwd(lambda x: H.full_state_map_stereo(
        x, lm.M, lm.N, r_slot))(jnp.asarray(x_new)))
    np.testing.assert_allclose(H.densify_info(out), J.T @ I_old @ J,
                               atol=1e-7, rtol=1e-7)


# ---------------------------------------------------------------------------
# Schur pieces
# ---------------------------------------------------------------------------

def test_inv3x3_and_info_vector_match_reference():
    rng = np.random.default_rng(40)
    A = rng.standard_normal((50, 3, 3))
    V = A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(3)
    V[7] = 0.0                                  # zero block stays zero
    np.testing.assert_allclose(kernels.inv3x3_sym(t64(V)).numpy(),
                               np.asarray(jschur.inv3x3_sym(jnp.asarray(V))),
                               atol=1e-12, rtol=1e-12)
    M, N = 6, 11
    U, Uij, W, Wpf, V = H.random_info_blocks(rng, M, N)
    poses = rng.standard_normal((M, 6))
    feats = rng.standard_normal((N, 3))
    eP_j, eF_j = jschur.info_vector(*(jnp.asarray(a) for a in
                                      (poses, feats, U, Uij, W, Wpf, V)))
    eP_t, eF_t = tschur.info_vector(
        lane(poses), lane(feats), lane(U), lane(Uij, torch.int64), lane(W),
        lane(Wpf, torch.int64), lane(V))
    np.testing.assert_allclose(eP_t[0].numpy(), np.asarray(eP_j), atol=1e-12)
    np.testing.assert_allclose(eF_t[0].numpy(), np.asarray(eF_j), atol=1e-12)


def _schur_inputs(dtype):
    """The fixture of tests/test_pallas.py (dense assembly, chunked path)."""
    rng = np.random.default_rng(77)
    M, N, KU, KW = 7, 23, 12, 40
    U = rng.standard_normal((KU, 6, 6)).astype(dtype)
    Uij = np.sort(rng.integers(0, M, (KU, 2)), axis=1).astype(np.int32)
    dg = Uij[:, 0] == Uij[:, 1]
    U[dg] = 0.5 * (U[dg] + np.swapaxes(U[dg], 1, 2))
    W = rng.standard_normal((KW, 6, 3)).astype(dtype)
    Wpf = np.stack([rng.integers(0, M, KW),
                    rng.integers(0, N, KW)], axis=1).astype(np.int32)
    Vinv = rng.standard_normal((N, 3, 3)).astype(dtype)
    eP = rng.standard_normal((M, 6)).astype(dtype)
    eF = rng.standard_normal((N, 3)).astype(dtype)
    return U, Uij, W, Wpf, Vinv, eP, eF, M


@pytest.mark.parametrize("mode", ["f32 single-shot", "f32 chunked", "f64",
                                  "f32 fused Y", "f64 fused Y"])
def test_assemble_schur_dense_matches_reference(mode, monkeypatch):
    """The reference forms Y = W Vinv[wf] from Vinv, the port takes Y. The
    first three modes give the port the einsum of the reference's own Vinv
    (random blocks); the "fused Y" modes start from SPD feature blocks V:
    the reference inverts them with its jnp closed form, the port takes Y
    from `schur.inv3x3_wy` (one K2 call). float32: rtol 1e-5 (plus 1e-5 of
    the largest magnitude) — the port assembles A as D + D^T with a
    symmetrised diagonal and sums the block products of the W list (K4's
    plain version) where the reference multiplies dense layouts. "f32
    chunked" holds the port's feature stripes (`schur.schur_stripes` over
    `dense_a32`, which the feature-sharded solve runs) against the
    reference's chunked assembly. float64: 1e-12."""
    dtype = np.float64 if mode.startswith("f64") else np.float32
    U, Uij, W, Wpf, Vinv, eP, eF, M = _schur_inputs(dtype)
    if mode == "f32 chunked":    # ~3 feature stripes in both packages
        budget = 6 * M * 3 * 8 * 4
        monkeypatch.setattr(jschur, "_DENSE_W_BYTES", budget)
        monkeypatch.setenv("LINEARSFM_DENSE_W_BYTES", str(budget))
    if mode.endswith("fused Y"):
        A = np.random.default_rng(78).standard_normal((Vinv.shape[0], 3, 3))
        V = (A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(3)).astype(dtype)
        Vinv = np.asarray(jschur.inv3x3_sym(jnp.asarray(V)))
        Y = tschur.inv3x3_wy(lane(V), lane(W), lane(Wpf, torch.int64))[1]
    else:
        Y = lane(np.einsum("kiz,kzf->kif", W, Vinv[Wpf[:, 1]]))
    S_j, E_j = jschur._assemble_schur_dense(
        *(jnp.asarray(a) for a in (U, Uij, W, Wpf, Vinv, eP, eF)), M)
    if mode == "f32 chunked":
        Wt, Wpft = lane(W), lane(Wpf, torch.int64)
        S_t = tschur.dense_a32(lane(U), lane(Uij, torch.int64), M)
        E_t = tschur.schur_stripes(
            S_t, lane(eP).reshape(1, -1),
            tschur.w_plan(Wt, Wpft, M, eF.shape[0]), Wt, Y, lane(eF), M)
    else:
        S_t, E_t = tschur._assemble_schur_dense(
            lane(U), lane(Uij, torch.int64), lane(W), lane(Wpf, torch.int64),
            Y, lane(eP), lane(eF), M)
    S_j, E_j = np.asarray(S_j), np.asarray(E_j)
    if dtype == np.float64:
        np.testing.assert_allclose(S_t[0].numpy(), S_j, atol=1e-12)
        np.testing.assert_allclose(E_t[0].numpy(), E_j, atol=1e-12)
    else:
        np.testing.assert_allclose(S_t[0].numpy(), S_j, rtol=1e-5,
                                   atol=1e-5 * np.abs(S_j).max())
        np.testing.assert_allclose(E_t[0].numpy(), E_j, rtol=1e-5,
                                   atol=1e-5 * np.abs(E_j).max())


# ---------------------------------------------------------------------------
# solve_full_mixed (tests/test_solve.py fixtures)
# ---------------------------------------------------------------------------

def _system(seed, M, N, obs, fixc=None, sign=None):
    rng = np.random.default_rng(seed)
    U, Uij, W, Wpf, V = H.random_info_blocks(rng, M, N, obs_per_feat=obs)
    d = 6 * M + 3 * N
    x_true = rng.standard_normal(d)
    if fixc is not None:
        x_true[fixc] = sign
    I = np.zeros((d, d))
    for k, (i, j) in enumerate(Uij):
        I[6*i:6*i+6, 6*j:6*j+6] += U[k]
        if i != j:
            I[6*j:6*j+6, 6*i:6*i+6] += U[k].T
    for k, (p, f) in enumerate(Wpf):
        I[6*p:6*p+6, 6*M+3*f:6*M+3*f+3] += W[k]
        I[6*M+3*f:6*M+3*f+3, 6*p:6*p+6] += W[k].T
    for f in range(N):
        I[6*M+3*f:6*M+3*f+3, 6*M+3*f:6*M+3*f+3] += V[f]
    e = I @ x_true
    eP, eF = e[:6*M].reshape(M, 6), e[6*M:].reshape(N, 3)
    return (U, Uij, W, Wpf, V, eP, eF, M), x_true


def _torch_args(sys_, fixed=None):
    U, Uij, W, Wpf, V, eP, eF, M = sys_
    fixed = np.zeros(6 * M, bool) if fixed is None else fixed
    return (lane(U), lane(Uij, torch.int64), lane(W), lane(Wpf, torch.int64),
            lane(V), lane(eP), lane(eF), M, lane(fixed))


def _jax_args(sys_, fixed=None):
    U, Uij, W, Wpf, V, eP, eF, M = sys_
    fixed = np.zeros(6 * M, bool) if fixed is None else fixed
    return (jnp.asarray(U), jnp.asarray(Uij, jnp.int32), jnp.asarray(W),
            jnp.asarray(Wpf, jnp.int32), jnp.asarray(V), jnp.asarray(eP),
            jnp.asarray(eF), M, jnp.asarray(fixed))


def _flat(xp, xf):
    return np.concatenate([np.asarray(xp).ravel(), np.asarray(xf).ravel()])


def test_solve_full_mixed_matches_dense_f64():
    """f32 Schur + f64 PCG recovers the dense f64 solution (1e-9), and
    agrees with the reference's dense-assembly solve to 1e-9."""
    sys_, x_true = _system(52, 12, 30, 4)
    args = _torch_args(sys_)
    xp0, xf0, _ = tschur.solve_full_mixed(*args, force_dense=True, iters=0)
    xp, xf, res = tschur.solve_full_mixed(*args, force_dense=True, iters=4)
    e0 = np.abs(_flat(xp0[0], xf0[0]) - x_true).max()
    er = np.abs(_flat(xp[0], xf[0]) - x_true).max()
    assert er < 1e-9, (e0, er)
    assert er < e0 * 1e-2
    xpj, xfj, resj = jschur.solve_full_mixed(*_jax_args(sys_),
                                             force_dense=True, iters=4)
    np.testing.assert_allclose(_flat(xp[0], xf[0]), _flat(xpj, xfj), atol=1e-9)
    assert float(res[0]) < 1e-10 and float(resj) < 1e-10


def test_solve_full_mixed_pinned_coordinate():
    """The mono scale pin: x[fixc] lands exactly at sign (1e-8 elsewhere)."""
    fixc, sign = 6 * 2 + 1, -1.0
    sys_, x_true = _system(53, 6, 14, 3, fixc=fixc, sign=sign)
    fixed = np.zeros(6 * 6, bool)
    fixed[fixc] = True
    xp, xf, _ = tschur.solve_full_mixed(
        *_torch_args(sys_, fixed), force_dense=True, iters=4,
        fixc=torch.tensor([fixc]),
        sign=torch.tensor([sign], dtype=torch.float64))
    got = _flat(xp[0], xf[0])
    assert got[fixc] == sign
    np.testing.assert_allclose(got, x_true, atol=1e-8)
    xpj, xfj, _ = jschur.solve_full_mixed(*_jax_args(sys_, fixed),
                                          force_dense=True, iters=4,
                                          fixc=fixc, sign=sign)
    np.testing.assert_allclose(got, _flat(xpj, xfj), atol=1e-9)


def test_solve_full_mixed_residual_escalation_and_exit():
    """Residual telemetry, escalation and the early exit, within the port:
    escalation equals running the extra sweeps, and the early exit equals
    the fixed-trip run that stops at the same sweep (bit-identical: same
    recurrence)."""
    sys_, _ = _system(54, 10, 24, 4)
    args = _torch_args(sys_)
    solve = partial(tschur.solve_full_mixed, force_dense=True)
    _, _, r0 = solve(*args, iters=0)
    xp4, xf4, r4 = solve(*args, iters=4)
    assert float(r4[0]) < float(r0[0]) * 1e-3
    assert float(r4[0]) < 1e-10
    _, _, r4j = jschur.solve_full_mixed(*_jax_args(sys_), force_dense=True,
                                        iters=4)
    assert abs(float(r4[0]) - float(r4j)) < 1e-12

    xpe, xfe, re_ = solve(*args, iters=1, escalate_iters=3,
                                            escalate_tol=0.0)
    assert torch.equal(xpe, xp4) and torch.equal(xfe, xf4)
    assert torch.equal(re_, r4)
    xp1, _, r1 = solve(*args, iters=1)
    xps, _, rs = solve(*args, iters=1, escalate_iters=3,
                                         escalate_tol=1e30)
    assert torch.equal(xps, xp1) and torch.equal(rs, r1)

    tol = 1e-10
    xpw, xfw, rw = solve(*args, iters=16, exit_tol=tol)
    runs = [solve(*args, iters=k) for k in range(17)]
    same = [k for k, (xp, xf, _) in enumerate(runs)
            if torch.equal(xp, xpw) and torch.equal(xf, xfw)]
    assert same and same[0] < 16, "the system converges before the cap"
    k = same[0]
    assert torch.equal(runs[k][2], rw)
    assert float(rw[0]) <= tol * (1 + 1e-9)
    assert float(runs[k - 1][2][0]) > tol * (1 - 1e-9)


def test_solve_full_mixed_lanes_freeze_like_vmap():
    """Three systems as three lanes with the early exit: each lane stops at
    its own sweep and is frozen while the others continue — equal to the
    reference's vmapped while_loop (1e-9) and to each lane solved alone
    (1e-12)."""
    systems = [_system(60 + s, 8, 20, 3)[0] for s in range(3)]
    ku = max(s[0].shape[0] for s in systems)   # zero blocks at (0, 0)
    systems = [(np.pad(U, ((0, ku - len(U)), (0, 0), (0, 0))),
                np.pad(Uij, ((0, ku - len(U)), (0, 0)))) + tuple(rest)
               for U, Uij, *rest in [tuple(s) for s in systems]]
    stacked = [torch.cat(parts) for parts in
               zip(*[_torch_args(s)[:7] for s in systems])]
    fixed = torch.zeros((3, 6 * 8), dtype=torch.bool)
    kw = dict(iters=16, exit_tol=1e-13, escalate_iters=16, escalate_tol=1e-8)
    xp, xf, res = tschur.solve_full_mixed(*stacked[:7], 8, fixed,
                                          force_dense=True, **kw)

    jargs = [jnp.stack([jnp.asarray(_jax_args(s)[i]) for s in systems])
             for i in range(7)]
    vm = jax.vmap(lambda U, Uij, W, Wpf, V, eP, eF, fx: jschur.solve_full_mixed(
        U, Uij, W, Wpf, V, eP, eF, 8, fx, force_dense=True, **kw))
    xpj, xfj, resj = vm(*jargs, jnp.zeros((3, 48), bool))
    np.testing.assert_allclose(xp.numpy(), np.asarray(xpj), atol=1e-9)
    np.testing.assert_allclose(xf.numpy(), np.asarray(xfj), atol=1e-9)
    assert (res.numpy() <= 1e-12).all() and (np.asarray(resj) <= 1e-12).all()
    for k, s in enumerate(systems):
        xpk, xfk, _ = tschur.solve_full_mixed(*_torch_args(s),
                                              force_dense=True, **kw)
        np.testing.assert_allclose(xp[k].numpy(), xpk[0].numpy(), atol=1e-12)
        np.testing.assert_allclose(xf[k].numpy(), xfk[0].numpy(), atol=1e-12)


def test_solve_full_mixed_failed_factor_lane_is_nan():
    """A lane whose Schur matrix is not positive definite turns NaN (the
    reference's NaN Cholesky) without aborting its neighbours."""
    good, _ = _system(52, 12, 30, 4)
    U = good[0].copy()
    bad = (-U,) + good[1:]        # negative definite pose information
    stacked = [torch.cat(parts) for parts in
               zip(_torch_args(good)[:7], _torch_args(bad)[:7])]
    fixed = torch.zeros((2, 6 * 12), dtype=torch.bool)
    xp, xf, res = tschur.solve_full_mixed(*stacked, 12, fixed,
                                          force_dense=True, iters=2)
    assert torch.isfinite(xp[0]).all() and float(res[0]) < 1e-6
    assert torch.isnan(res[1])
