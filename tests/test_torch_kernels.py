"""Kernels K1 (`blockcoo_to_dense`), K2 (`inv3x3_sym`), K4
(`schur_pairs`) and K5 (`gauge_congruence`) of the PyTorch port.

* K1's plain PyTorch version against the reference's Pallas kernel in
  interpret mode (the cases of tests/test_pallas.py, K = 0, a lane-folded
  batch), exactly: both sum duplicates in list order;
* K2's plain version against the reference's `schur.inv3x3_sym` and its
  Pallas kernel in interpret mode (tests/test_pallas.py inputs, float32, a
  NaN block, a lane stack); the fused K2's plain version (`inv3x3_wy_ref`:
  Vinv and Y = W Vinv[wf]) against the reference's inverse and its einsum
  on W lists with padding, and its edges (wf outside [0, N), N = 0, K = 0);
* K1's plan (`coo_plan`): every column window gathered through the plan's
  CSR offsets and binary-searched sub-ranges densifies, exactly, to the
  plain version over the masked and clamped list the Schur assembly used to
  build per feature stripe; the planned call on the CPU equals the plain
  version;
* K4's plain version against A - Yd Wd^T and eP - Yd eF in float64 over
  dense layouts (lanes, padding, zero blocks, duplicates, a feature seen
  once and one seen by every pose, an empty lane), bit for bit against a
  sequential loop in the kernel's order, and its fused multiply-add
  (`kernels._fma32`) against exact rational arithmetic;
* the wrappers' dispatch: CPU tensors take the plain version and count no
  launch; a device without a kernel raises instead of falling back; K5's
  wrapper on the CPU is the plain transform (`torch.equal`) in stereo and
  mono, float32 and float64 information, with padded slots and entries,
  every mono projection case and each pinned coordinate 0-5 (3-5 raise in
  both);
* the port imports neither jax nor the reference package;
* on a CUDA card (marker `cuda`), each kernel against its plain version in
  float32 and float64; the fused K2 bit for bit at its tile edges; K1 also
  at tile edges (widths that are not a
  multiple of the tile width, block rows that are not a multiple of the
  tile's, rows whose bytes are not a multiple of 16), on stripe windows of
  one plan, with one launch per planned call; K4 bit for bit its plain
  version on the CPU, and two launches bit for bit each other.

JAX is imported inside the tests that compare with it, so that the `cuda`
test runs where jax is not installed:
    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from linearsfm_tpu_torch.ops import kernels

# one intra-op thread: the suite's workers share the machine's cores, and
# an oversubscribed thread pool slows the trees' small ops many times over
torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _dense_loop(rows, cols, vals, M, N):
    """Sequential numpy scatter-add, the semantics both versions must keep."""
    K, R, C = vals.shape
    out = np.zeros((R * M, C * N), vals.dtype)
    for k in range(K):
        if 0 <= rows[k] < M:
            out[rows[k]*R:(rows[k]+1)*R, cols[k]*C:(cols[k]+1)*C] += vals[k]
    return out


def _case(name):
    rng = np.random.default_rng(41)
    if name == "6x3 padding, duplicates, unsorted":
        M, N, K = 37, 53, 700
        rows = rng.integers(0, M, K).astype(np.int32)
        rows[::13] = -1
        cols = rng.integers(0, N, K).astype(np.int32)
        vals = rng.normal(size=(K, 6, 3)).astype(np.float32)
    elif name == "6x6 sorted rows":
        M, K = 29, 500
        N = M
        rows = np.sort(rng.integers(0, M, K)).astype(np.int32)
        cols = rng.integers(0, M, K).astype(np.int32)
        vals = rng.normal(size=(K, 6, 6)).astype(np.float32)
    else:  # "K = 0"
        M, N = 5, 7
        rows = np.zeros(0, np.int32)
        cols = np.zeros(0, np.int32)
        vals = np.zeros((0, 6, 3), np.float32)
    return rows, cols, vals, M, N


@pytest.mark.parametrize("name", ["6x3 padding, duplicates, unsorted",
                                  "6x6 sorted rows", "K = 0"])
def test_plain_matches_pallas_interpret(name):
    """Exact: the reference kernel and the plain version both add each
    output element's contributions in list order."""
    import jax.numpy as jnp
    from linearsfm_tpu.ops import pallas_kernels as pk

    rows, cols, vals, M, N = _case(name)
    want = np.asarray(pk.blockcoo_to_dense(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals), M, N,
        interpret=True))
    got = kernels.blockcoo_to_dense(torch.from_numpy(rows),
                                    torch.from_numpy(cols),
                                    torch.from_numpy(vals), M, N)
    assert got.shape == (6 * M, vals.shape[2] * N)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  _dense_loop(rows, cols, vals, M, N))


def test_plain_lane_folded_batch_matches_pallas_per_lane():
    """A [P, K] batch gives each lane's own dense matrix (exact)."""
    import jax.numpy as jnp
    from linearsfm_tpu.ops import pallas_kernels as pk

    rng = np.random.default_rng(43)
    P, M, N, K = 4, 11, 9, 120
    rows = rng.integers(0, M, (P, K)).astype(np.int32)
    rows[:, ::7] = -1
    cols = rng.integers(0, N, (P, K)).astype(np.int32)
    vals = rng.normal(size=(P, K, 6, 3)).astype(np.float32)
    got = kernels.blockcoo_to_dense(torch.from_numpy(rows),
                                    torch.from_numpy(cols),
                                    torch.from_numpy(vals), M, N)
    assert got.shape == (P, 6 * M, 3 * N)
    for p in range(P):
        want = np.asarray(pk.blockcoo_to_dense(
            jnp.asarray(rows[p]), jnp.asarray(cols[p]), jnp.asarray(vals[p]),
            M, N, interpret=True))
        np.testing.assert_array_equal(got[p].numpy(), want)


def test_wrapper_dispatch_counts_only_kernel_launches():
    rows, cols, vals, M, N = _case("6x6 sorted rows")
    before = dict(kernels.launches)
    out = kernels.blockcoo_to_dense(torch.from_numpy(rows),
                                    torch.from_numpy(cols),
                                    torch.from_numpy(vals), M, N)
    ref = kernels.blockcoo_to_dense_ref(torch.from_numpy(rows),
                                        torch.from_numpy(cols),
                                        torch.from_numpy(vals), M, N)
    assert torch.equal(out, ref)
    assert kernels.launches == before       # the CPU path launches nothing
    meta = torch.empty((3, 6, 3), device="meta")
    idx = torch.zeros(3, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kernels.blockcoo_to_dense(idx, idx, meta, 2, 2)


# lists as the Schur assembly's W lists: padding (-1), rows past M, many
# duplicate coordinates, unsorted rows, and lanes (name, P, M, N, K, C, dtype)
PLAN_CASES = [("6x3 one lane", 1, 9, 23, 160, 3, np.float32),
              ("6x3 three lanes", 3, 7, 23, 90, 3, np.float32),
              ("6x6 two lanes float64", 2, 5, 11, 70, 6, np.float64)]


def _plan_list(P, M, N, K, C, dtype, seed=47):
    rng = np.random.default_rng(seed)
    rows = rng.integers(-1, M + 1, (P, K))          # -1 padding, M past the end
    cols = rng.integers(0, N, (P, K))
    dup = rng.integers(0, K, K // 4)                # repeat some coordinates
    rows[:, dup[1:]], cols[:, dup[1:]] = rows[:, dup[:-1]], cols[:, dup[:-1]]
    vals = rng.normal(size=(P, K, 6, C)).astype(dtype)
    return rows, cols, vals


def _windows(N):
    """The whole width and stripes as `_assemble_schur_dense` cuts them
    (the last one reaching past N), plus an odd window."""
    Nc = -(-N // 3)
    return [(0, N)] + [(lo, Nc) for lo in range(0, N, Nc)] + [(2, 3)]


def _dense_through_plan(plan, vals, lo, width):
    """Densify window [lo, lo + width) from the plan alone: in each folded
    block row, the entries of the window are the sub-range of the row's CSR
    range found by binary search in the sorted columns; add them in sorted
    order (numpy, no kernel)."""
    perm, scol, ptr = (t.numpy() for t in (plan.perm, plan.scol,
                                            plan.row_ptr))
    R, C = vals.shape[-2:]
    flat = vals.reshape(-1, R, C)
    PM = len(ptr) - 1
    out = np.zeros((PM * R, C * width), vals.dtype)
    for b in range(PM):
        a, e = ptr[b], ptr[b + 1]
        s0 = a + np.searchsorted(scol[a:e], lo)
        s1 = a + np.searchsorted(scol[a:e], lo + width)
        for s in range(s0, s1):
            c = scol[s] - lo
            out[b * R:(b + 1) * R, c * C:(c + 1) * C] += flat[perm[s]]
    return out.reshape(vals.shape[:-3] + (R * plan.M, C * width))


def _masked_stripe(rows, cols, lo, width):
    """The stripe list `_assemble_schur_dense` built before the plan: rows
    outside the window masked to -1, columns shifted and clamped."""
    own = (cols >= lo) & (cols < lo + width)
    return (torch.where(own, rows, -1),
            torch.clamp(cols - lo, 0, width - 1))


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: c[0])
def test_plan_windows_match_masked_lists(case):
    """Exact: each window gathered through the plan equals the plain
    version over the masked and clamped list; the plan is a stable sort by
    (folded row, column) with the skipped entries last."""
    _, P, M, N, K, C, dtype = case
    rows, cols, vals = _plan_list(P, M, N, K, C, dtype)
    rows_t, cols_t = torch.from_numpy(rows), torch.from_numpy(cols)
    plan = kernels.coo_plan(rows_t, cols_t, M, N)
    ok = (rows >= 0) & (rows < M)
    key = np.where(ok, (rows + np.arange(P)[:, None] * M) * N + cols,
                   P * M * N).reshape(-1)
    np.testing.assert_array_equal(plan.perm.numpy(),
                                  np.argsort(key, kind="stable"))
    ptr = plan.row_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == ok.sum() and (np.diff(ptr) >= 0).all()
    assert plan.perm.dtype == plan.scol.dtype == plan.row_ptr.dtype \
        == torch.int32
    for lo, width in _windows(N):
        want = kernels.blockcoo_to_dense_ref(
            *_masked_stripe(rows_t, cols_t, lo, width),
            torch.from_numpy(vals), M, width)
        got = _dense_through_plan(plan, vals, lo, width)
        np.testing.assert_array_equal(got, want.numpy(), err_msg=f"{lo}")


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: c[0])
def test_planned_cpu_matches_plain(case):
    """On the CPU the planned call is the plain version over the window's
    entries (exact), launches nothing, and the one-shot wrapper equals it."""
    _, P, M, N, K, C, dtype = case
    rows, cols, vals = (torch.from_numpy(a) for a in
                        _plan_list(P, M, N, K, C, dtype))
    plan = kernels.coo_plan(rows, cols, M, N)
    before = dict(kernels.launches)
    for lo, width in _windows(N):
        got = kernels.blockcoo_to_dense_planned(plan, vals, lo, width)
        want = kernels.blockcoo_to_dense_ref(
            *_masked_stripe(rows, cols, lo, width), vals, M, width)
        assert got.shape == (P, 6 * M, C * width)
        assert torch.equal(got, want), (lo, width)
    assert torch.equal(kernels.blockcoo_to_dense_planned(plan, vals),
                       kernels.blockcoo_to_dense(rows, cols, vals, M, N))
    assert kernels.launches == before


def _inv3x3_input(name):
    """Symmetric positive definite 3x3 blocks (tests/test_pallas.py) with a
    zero block, in the dtype and layout the case names."""
    rng = np.random.default_rng(40)
    A = rng.standard_normal((300, 3, 3))
    V = A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(3)
    V[7] = 0.0
    if name == "float32":
        return V.astype(np.float32)
    if name == "NaN block":
        V[11, 1, 2] = V[11, 2, 1] = np.nan
    if name == "lane stack [P, N]":
        V = V.reshape(4, 75, 3, 3)
    return V


INV3X3_CASES = ["float64", "float32", "NaN block", "lane stack [P, N]"]


@pytest.mark.parametrize("name", INV3X3_CASES)
def test_inv3x3_plain_matches_reference_and_pallas(name):
    """The plain K2 equals the reference's jnp form and its Pallas kernel
    (interpret mode): 1e-12 in float64, 1e-6 relative in float32 (XLA may
    contract the cofactors into FMAs); NaN where the reference has NaN."""
    import jax.numpy as jnp
    from linearsfm_tpu.ops import pallas_kernels as pk
    from linearsfm_tpu.ops import schur as jschur

    V = _inv3x3_input(name)
    got = kernels.inv3x3_sym_ref(torch.from_numpy(V)).numpy()
    assert got.shape == V.shape and got.dtype == V.dtype
    flat = V.reshape(-1, 3, 3)
    tol = (dict(rtol=1e-6, atol=1e-6) if V.dtype == np.float32
           else dict(rtol=1e-12, atol=1e-12))
    for want in (jschur.inv3x3_sym(jnp.asarray(flat)),
                 pk.inv3x3_sym(jnp.asarray(flat), interpret=True)):
        np.testing.assert_allclose(got.reshape(-1, 3, 3), np.asarray(want),
                                   **tol)
    g = got.reshape(-1, 3, 3)
    assert (g[7] == 0).all()                       # det == 0 -> zero block
    assert np.isnan(g[11]).all() == (name == "NaN block")
    np.testing.assert_array_equal(g, np.swapaxes(g, 1, 2))   # symmetric


def test_inv3x3_dispatch_counts_only_kernel_launches():
    """K2's inverse alone takes the plain version on the CPU (no launch,
    also for a non-contiguous V); a device without a kernel raises."""
    V = torch.from_numpy(_inv3x3_input("lane stack [P, N]"))
    before = dict(kernels.launches)
    assert torch.equal(kernels.inv3x3_sym(V), kernels.inv3x3_sym_ref(V))
    Vt = V.transpose(0, 1)                          # not contiguous
    assert torch.equal(kernels.inv3x3_sym(Vt), kernels.inv3x3_sym_ref(Vt))
    assert kernels.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        kernels.inv3x3_sym(torch.empty((4, 3, 3), device="meta"))


def _wy_lists(V, K, seed=44):
    """A W list over the lane-stacked feature blocks V [P, N, 3, 3]: random
    6x3 blocks at random features, every 7th entry padding (W = 0, wf = 0,
    as the joins pad) and some entries on blocks 7 and 11 (zero and, in the
    NaN case, NaN blocks)."""
    rng = np.random.default_rng(seed)
    P, N = V.shape[:2]
    W = rng.standard_normal((P, K, 6, 3)).astype(V.dtype)
    Wpf = np.stack([rng.integers(0, 16, (P, K)),
                    rng.integers(0, max(N, 1), (P, K))], axis=-1)
    if N > 11:
        Wpf[:, 3::10, 1] = 7
        Wpf[:, 5::10, 1] = 11
    W[:, ::7] = 0.0
    Wpf[:, ::7] = 0
    return W, Wpf


def _nan_equal(a, b):
    """torch.equal, NaN where the other has NaN."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


@pytest.mark.parametrize("name", INV3X3_CASES)
def test_inv3x3_wy_plain_matches_reference(name):
    """The fused K2's plain version against the reference on the same
    numpy inputs (lane-stacked, padding, zero and NaN blocks): Vinv against
    `schur.inv3x3_sym` and the Pallas K2 (interpret mode), Y against
    `einsum("kiz,kzf->kif", W, Vinv[wf])` (the reference's Yb); float64 at
    rtol 1e-12, float32 at rtol 2e-6, both plus that much of the largest
    magnitude (XLA may contract the cofactors and the product into FMAs).
    Its Vinv is `inv3x3_sym_ref` bit for bit."""
    import jax.numpy as jnp
    from linearsfm_tpu.ops import pallas_kernels as pk
    from linearsfm_tpu.ops import schur as jschur

    V = _inv3x3_input(name)
    V = V if V.ndim == 4 else V[None]
    P, N = V.shape[:2]
    W, Wpf = _wy_lists(V, 3 * N // P + 5)
    Vinv, Y = kernels.inv3x3_wy_ref(torch.from_numpy(V), torch.from_numpy(W),
                                    torch.from_numpy(Wpf))
    assert _nan_equal(Vinv, kernels.inv3x3_sym_ref(torch.from_numpy(V)))
    assert Y.shape == W.shape and Y.dtype == Vinv.dtype == torch.from_numpy(
        V).dtype
    rtol = 2e-6 if V.dtype == np.float32 else 1e-12
    flat = jnp.asarray(V.reshape(-1, 3, 3))
    for want in (jschur.inv3x3_sym(flat), pk.inv3x3_sym(flat, interpret=True)):
        want = np.asarray(want)
        np.testing.assert_allclose(Vinv.numpy().reshape(-1, 3, 3), want,
                                   rtol=rtol,
                                   atol=rtol * np.nanmax(np.abs(want)))
    Vinv_j = np.asarray(jschur.inv3x3_sym(flat)).reshape(V.shape)
    G = Vinv_j[np.arange(P)[:, None], Wpf[..., 1]]
    Y_j = np.asarray(jnp.einsum("kiz,kzf->kif", W.reshape(-1, 6, 3),
                                G.reshape(-1, 3, 3))).reshape(W.shape)
    np.testing.assert_allclose(Y.numpy(), Y_j, rtol=rtol,
                               atol=rtol * np.nanmax(np.abs(Y_j)))
    assert np.isnan(Y.numpy()).any() == (name == "NaN block")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_inv3x3_wy_edges_on_cpu(dtype):
    """Entries whose wf lies outside [0, N) give Y = 0 exactly, even with
    non-finite W; in-range entries are the elementwise product in the
    kernel's order; N = 0 gives Y = 0, K = 0 the inverse alone."""
    V = _inv3x3_input("lane stack [P, N]").astype(dtype)     # [4, 75]
    W, Wpf = _wy_lists(V, 40)
    Wpf[:, 1, 1], Wpf[:, 2, 1], Wpf[:, 4, 1] = -1, 75, 1000
    W[:, 4] = np.inf
    V_t, W_t, Wpf_t = (torch.from_numpy(a) for a in (V, W, Wpf))
    Vinv, Y = kernels.inv3x3_wy_ref(V_t, W_t, Wpf_t)
    out = np.zeros(Wpf.shape[:2], bool)
    out[:, [1, 2, 4]] = True
    assert (Y.numpy()[out] == 0).all()
    G = Vinv.numpy()[np.arange(4)[:, None], np.clip(Wpf[..., 1], 0, 74)]
    with np.errstate(invalid="ignore"):     # inf * 0 in the out-of-range rows
        want = (W[..., :, 0:1] * G[..., 0:1, :]
                + W[..., :, 1:2] * G[..., 1:2, :]
                + W[..., :, 2:3] * G[..., 2:3, :])
    np.testing.assert_array_equal(Y.numpy()[~out], want[~out])
    Vinv0, Y0 = kernels.inv3x3_wy_ref(V_t[:, :0], W_t, Wpf_t)
    assert Vinv0.shape == (4, 0, 3, 3) and torch.equal(Y0,
                                                       torch.zeros_like(W_t))
    VinvK, YK = kernels.inv3x3_wy_ref(V_t, W_t[:, :0], Wpf_t[:, :0])
    assert YK.shape == (4, 0, 6, 3) and torch.equal(VinvK, Vinv)


def test_inv3x3_wy_dispatch_counts_only_kernel_launches():
    """schur.inv3x3_wy takes the plain version on the CPU (no launch, also
    for non-contiguous operands); a device without a kernel raises instead
    of falling back."""
    from linearsfm_tpu_torch.ops import schur

    V = torch.from_numpy(_inv3x3_input("lane stack [P, N]"))
    W, Wpf = (torch.from_numpy(a) for a in _wy_lists(V.numpy(), 30))
    before = dict(kernels.launches)
    for args in ((V, W, Wpf),
                 (V.transpose(-1, -2), W.transpose(0, 1).contiguous()
                  .transpose(0, 1), Wpf)):
        got = schur.inv3x3_wy(*args)
        want = kernels.inv3x3_wy_ref(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kernels.launches == before
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in (V, W, Wpf)]
    with pytest.raises(ValueError, match="no kernel"):
        kernels.inv3x3_wy(*meta)


# K4 (`schur_pairs`) cases: (name, P, M, N, K). `_pair_case` adds to each
# padding entries, zero blocks at real coordinates, duplicate (pose,
# feature) entries, a feature seen once, a feature seen by every pose, an
# entry outside [0, M) x [0, N), and an empty last lane; with K >> N each
# pose pair shares many features
PAIR_CASES = [("three lanes", 3, 9, 25, 140),
              ("level-1 lanes of 4 poses", 12, 4, 10, 36),
              ("dense co-visibility", 2, 5, 12, 150)]


def _pair_case(P, M, N, K, seed=53):
    """float32 numpy (A, eP, W, Y, eF, Wpf) of a K4 case: Y = W G[wf] for
    random 3x3 blocks G, so a zero W block has a zero Y, as in the joins."""
    rng = np.random.default_rng(seed + P * 1000 + M * 100 + N)
    wp = rng.integers(0, M, (P, K))
    wf = rng.integers(0, N, (P, K))
    W = rng.normal(size=(P, K, 6, 3)).astype(np.float32)
    wf[:, :M] = 1                       # feature 1: seen by every pose
    wp[:, :M] = np.arange(M)
    wf[:, M] = 0                        # feature 0: seen once
    wf[:, M + 1:][wf[:, M + 1:] == 0] = 2
    wp[:, M + 2], wf[:, M + 2] = wp[:, M + 3], wf[:, M + 3]   # duplicate
    W[:, M + 4] = 0.0                   # a dropped coupling: zero block
    wp[:, M + 5], wf[:, M + 5] = M, N   # outside the lane's poses and features
    W[:, ::9], wp[:, ::9], wf[:, ::9] = 0.0, 0, 0   # padding
    W[-1], wp[-1], wf[-1] = 0.0, 0, 0   # an empty lane
    G = rng.normal(size=(P, N + 1, 3, 3)).astype(np.float32)
    Y = np.einsum("pkij,pkjl->pkil", W, G[np.arange(P)[:, None], wf])
    A = rng.normal(size=(P, 6 * M, 6 * M)).astype(np.float32)
    eP = rng.normal(size=(P, 6 * M)).astype(np.float32)
    eF = rng.normal(size=(P, N, 3)).astype(np.float32)
    return A, eP, W, Y.astype(np.float32), eF, np.stack([wp, wf], -1)


def _pairs_plain(A, eP, W, Y, eF, Wpf, M, N):
    """K4's plain version on a `_pair_case` (copies of A and eP)."""
    from linearsfm_tpu_torch.ops import schur
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (W, Y, eF)]
    Wt = t[0]
    S, E = torch.from_numpy(A.copy()), torch.from_numpy(eP.copy())
    return kernels.schur_pairs(S, E, *t, schur.w_plan(
        Wt, torch.from_numpy(Wpf), M, N))


@pytest.mark.parametrize("case", PAIR_CASES, ids=lambda c: c[0])
def test_schur_pairs_plain_matches_dense_float64(case):
    """K4's plain version against A - Yd Wd^T and eP - Yd eF in float64
    over dense layouts of each lane's list: rtol 1e-5 (plus 1e-5 of the
    largest magnitude) in float32."""
    _, P, M, N, K = case
    A, eP, W, Y, eF, Wpf = _pair_case(P, M, N, K)
    S, E = _pairs_plain(A, eP, W, Y, eF, Wpf, M, N)
    for p in range(P):
        Wd = np.zeros((6 * M, 3 * N))
        Yd = np.zeros((6 * M, 3 * N))
        for k, (i, f) in enumerate(Wpf[p]):
            if 0 <= i < M and 0 <= f < N:
                Wd[6 * i:6 * i + 6, 3 * f:3 * f + 3] += W[p, k]
                Yd[6 * i:6 * i + 6, 3 * f:3 * f + 3] += Y[p, k]
        S64 = A[p].astype(np.float64) - Yd @ Wd.T
        E64 = eP[p].astype(np.float64) - Yd @ eF[p].reshape(-1)
        np.testing.assert_allclose(S[p].numpy(), S64, rtol=1e-5,
                                   atol=1e-5 * np.abs(S64).max())
        np.testing.assert_allclose(E[p].numpy(), E64, rtol=1e-5,
                                   atol=1e-5 * np.abs(E64).max())
    assert np.array_equal(S[-1].numpy(), A[-1])   # the empty lane
    assert np.array_equal(E[-1].numpy(), eP[-1])


@pytest.mark.parametrize("case", PAIR_CASES, ids=lambda c: c[0])
def test_schur_pairs_plain_keeps_the_fixed_order(case):
    """Bit for bit, K4's plain version is a sequential loop in the order
    the kernel keeps: block (p, q) takes, for each entry (p, f) in feature
    order (then list order), each entry (q, f) in pose order (then list
    order), the term y0 w0 + y1 w1 + y2 w2 added to a sum from zero as
    three fused multiply-adds (`kernels._fma32`, held to exact arithmetic
    below), then A - the sum; E[p] the same with eF[f]."""
    _, P, M, N, K = case
    A, eP, W, Y, eF, Wpf = _pair_case(P, M, N, K)
    S, E = _pairs_plain(A, eP, W, Y, eF, Wpf, M, N)
    S0, E0 = torch.zeros(A.shape), torch.zeros(eP.shape)
    Wt, Yt, eFt = (torch.from_numpy(a) for a in (W, Y, eF))

    def fma3(acc, y, w):
        for k in range(3):
            acc = kernels._fma32(y[..., k], w[..., k], acc)
        return acc
    for p in range(P):
        live = [k for k in range(K) if W[p, k].any()
                and 0 <= Wpf[p, k, 0] < M and 0 <= Wpf[p, k, 1] < N]
        by_row = sorted(live, key=lambda k: (Wpf[p, k, 0], Wpf[p, k, 1], k))
        by_feat = sorted(live, key=lambda k: (Wpf[p, k, 1], Wpf[p, k, 0], k))
        for k1 in by_row:
            i, f = (int(x) for x in Wpf[p, k1])
            E0[p, 6 * i:6 * i + 6] = fma3(E0[p, 6 * i:6 * i + 6], Yt[p, k1],
                                          eFt[p, f][None, :])
            for k2 in (k for k in by_feat if Wpf[p, k, 1] == f):
                q = int(Wpf[p, k2, 0])
                blk = S0[p, 6 * i:6 * i + 6, 6 * q:6 * q + 6]
                blk.copy_(fma3(blk, Yt[p, k1][:, None, :],
                               Wt[p, k2][None, :, :]))
    assert torch.equal(S, torch.from_numpy(A) - S0)
    assert torch.equal(E, torch.from_numpy(eP) - E0)


def _fma_exact(a, b, c):
    """The float32 nearest to a b + c (ties to even), from exact rational
    arithmetic."""
    from fractions import Fraction
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    g = np.float32(float(x))
    cands = [g, np.nextafter(g, np.float32(np.inf)),
             np.nextafter(g, np.float32(-np.inf))]
    return min(cands, key=lambda h: (abs(Fraction(float(h)) - x),
                                     int(np.array(h).view(np.int32)) & 1))


def test_fma32_rounds_once():
    """`kernels._fma32`, the plain version's fused multiply-add, equals the
    exactly rounded a b + c on random float32 triples (cancellation,
    magnitudes far apart, subnormal results) and on a case where rounding
    the float64 sum to float32 rounds twice and misses."""
    rng = np.random.default_rng(61)
    n = 3000
    a, b, c = ((rng.normal(size=n) * 2.0 ** rng.integers(-e, e, n)).astype(
        np.float32) for e in (30, 30, 60))
    c[::3] = -(a[::3] * b[::3])                          # cancellation
    a[1::7] = np.float32(1.5e-23)                        # subnormal results
    b[1::7], c[1::7] = np.float32(2e-20), np.float32(1e-45)
    # a b = -2^-24 + 2^-70 and c = 1 + 2^-23: the sum is just above the
    # midpoint 1 + 2^-24; rounded to float64 first it is the midpoint
    a[0] = np.float32(-(2.0 ** -24) * (1 + 2.0 ** -23))
    b[0] = np.float32(1 - 2.0 ** -23)
    c[0] = np.float32(1 + 2.0 ** -23)
    got = kernels._fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    twice = (torch.from_numpy(a[:1]).double() * float(b[0]) + float(c[0]))
    assert float(twice.float()) == 1.0 and float(got[0]) == 1 + 2.0 ** -23


def test_schur_pairs_dispatch_counts_only_kernel_launches():
    """The CPU takes the plain version and counts no launch; the f32 Schur
    assembly runs it and leaves its inputs alone; a device without a kernel
    raises instead of falling back."""
    from linearsfm_tpu_torch.ops import schur
    A, eP, W, Y, eF, Wpf = _pair_case(3, 9, 25, 140)
    before = dict(kernels.launches)
    S, E = _pairs_plain(A, eP, W, Y, eF, Wpf, 9, 25)
    assert kernels.launches == before
    P, M = 3, 9
    U = torch.zeros((P, M, 6, 6))
    Uij = torch.arange(M).expand(P, 2, M).transpose(1, 2).contiguous()
    eP_t, Y_t = torch.from_numpy(eP.reshape(P, M, 6)), torch.from_numpy(Y)
    keep = eP_t.clone(), Y_t.clone()
    S2, E2 = schur._assemble_schur_dense(
        U, Uij, torch.from_numpy(W), torch.from_numpy(Wpf), Y_t, eP_t,
        torch.from_numpy(eF), M)
    assert torch.equal(eP_t, keep[0]) and torch.equal(Y_t, keep[1])
    S1, E1 = _pairs_plain(np.zeros_like(A), eP, W, Y, eF, Wpf, M, 25)
    assert torch.equal(S2, S1) and torch.equal(E2, E1)
    assert kernels.launches == before
    meta = [torch.empty(t.shape, device="meta") for t in (S, E)]
    plan = schur.w_plan(torch.from_numpy(W), torch.from_numpy(Wpf), M, 25)
    with pytest.raises(ValueError, match="no kernel"):
        kernels.schur_pairs(*meta, *(torch.empty(a.shape, device="meta")
                                     for a in (W, Y, eF)), plan)


# K5: lanes whose old gauge is (ref id 10 at slot 0, scap id 11 at slot 1,
# fix 2), and per lane a new mono gauge (ref, scap, fix) that takes each
# projection case: generic, the old ref is the new scap (r == p2), the old
# scap is the new ref (s == p1), ref and scap swapped, the same gauge
K5_MONO_GAUGES = ((13, 14, 1), (12, 10, 0), (11, 13, 1), (11, 10, 2),
                  (10, 11, 2))


def _k5_map(seed, P, M, N, KU, KW, mono, pad=1, device="cpu"):
    """A lane stack with random states and information: pose ids 10..,
    the last `pad` slots of every lane dead (-1), the last 3 U entries
    padding ((0, 0), zero blocks); stereo's old reference (id 3) is no
    slot, as in the tree's maps."""
    rng = np.random.default_rng(seed)
    ids = np.tile(np.arange(M) + 10, (P, 1))
    ids[:, M - pad:] = -1
    poses = rng.standard_normal((P, M, 6))
    poses[..., 3:] *= 0.5
    feats = rng.standard_normal((P, N, 3)) * 2.0
    A = rng.standard_normal((P, KU, 6, 6))
    U = A + A.transpose(0, 1, 3, 2)
    Uij = np.sort(rng.integers(0, M, (P, KU, 2)), axis=-1)
    Uij[:, -3:], U[:, -3:] = 0, 0.0
    W = rng.standard_normal((P, KW, 6, 3))
    Wpf = np.stack([rng.integers(0, M, (P, KW)), rng.integers(0, N, (P, KW))],
                   -1)
    B = rng.standard_normal((P, N, 3, 3))
    V = B @ B.transpose(0, 1, 3, 2)
    full = lambda v: np.full(P, v, np.int64)  # noqa: E731
    if mono:
        gauge = (ids[:, 0].copy(), ids[:, 1].copy(), full(2), full(1),
                 ids[:, 0].copy(), ids[:, 1].copy(), full(2))
    else:
        gauge = (full(3), full(-1), full(-1), full(1), full(3), full(-1),
                 full(-1))
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    from linearsfm_tpu_torch import types
    return types.LocalMap(
        pose_ids=t(ids), poses=t(poses), feat_ids=t(np.tile(np.arange(N),
                                                            (P, 1))),
        feats=t(feats), U=t(U), Uij=t(Uij), W=t(W), Wpf=t(Wpf), V=t(V),
        n_poses=t(full(M - pad)), n_feats=t(full(N)), n_U=t(full(KU - 3)),
        n_W=t(full(KW)), gauge=types.Gauge(*(t(g) for g in gauge)))


def _k5_case(datatype, device="cpu", fix=None):
    """(map, new gauge ids) of K5's small cases: 3 stereo lanes, or one
    mono lane per projection case (every lane pinned at `fix` if given)."""
    if datatype == "stereo":
        lm = _k5_map(5, 3, 7, 11, 16, 40, False, device=device)
        return lm, (torch.tensor([13, 10, 15], device=device),)
    lm = _k5_map(6, len(K5_MONO_GAUGES), 7, 11, 16, 40, True, device=device)
    new = [torch.tensor(col, device=device) for col in zip(*K5_MONO_GAUGES)]
    if fix is not None:
        new[2] = torch.full_like(new[2], fix)
    return lm, tuple(new)


def _k5_call(fn_name, lm, new, info):
    from linearsfm_tpu_torch.ops import congruence
    return getattr(congruence, fn_name)(lm, *new, info_dtype=info)


def _k5_fields(lm):
    from linearsfm_tpu_torch import types
    return ([getattr(lm, f) for f in types.MAP_FIELDS]
            + [getattr(lm.gauge, f) for f in types.GAUGE_FIELDS])


@pytest.mark.parametrize("info", [None, "float32"])
@pytest.mark.parametrize("datatype", ["stereo", "mono"])
def test_gauge_congruence_cpu_is_the_plain_transform(datatype, info):
    """On the CPU the transform takes the plain version: every field and
    gauge tag `torch.equal` to `transform_map_*_ref`'s, and no launch."""
    lm, new = _k5_case(datatype)
    before = dict(kernels.launches)
    got = _k5_call(f"transform_map_{datatype}", lm, new, info)
    want = _k5_call(f"transform_map_{datatype}_ref", lm, new, info)
    assert kernels.launches == before
    for a, b in zip(_k5_fields(got), _k5_fields(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got.U.dtype == (torch.float32 if info else torch.float64)


@pytest.mark.parametrize("fix", range(6))
def test_gauge_congruence_cpu_pinned_coordinate(fix):
    """Each pinned coordinate: 0-2 give the plain version's map, 3-5 (no
    translation coordinate) raise in both."""
    lm, new = _k5_case("mono", fix=fix)
    if fix < 3:
        got = _k5_call("transform_map_mono", lm, new, None)
        want = _k5_call("transform_map_mono_ref", lm, new, None)
        for a, b in zip(_k5_fields(got), _k5_fields(want)):
            assert torch.equal(a, b)
        return
    for name in ("transform_map_mono", "transform_map_mono_ref"):
        with pytest.raises(RuntimeError, match="out of bounds"):
            _k5_call(name, lm, new, None)


def test_gauge_congruence_refuses_a_device_without_kernel():
    """A map on a device without a kernel raises instead of falling back,
    and counts no launch."""
    from linearsfm_tpu_torch import types
    lm, new = _k5_case("stereo")
    meta = types.map_fields(lm, lambda a: a.to("meta"))
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="no kernel"):
        _k5_call("transform_map_stereo", meta, (new[0].to("meta"),), None)
    lm, new = _k5_case("mono")
    with pytest.raises(ValueError, match="no kernel"):
        _k5_call("transform_map_mono", types.map_fields(
            lm, lambda a: a.to("meta")), [t.to("meta") for t in new], None)
    assert kernels.launches == before


def test_port_imports_no_jax():
    """Importing every module of the port (each module and subpackage that
    `pkgutil.walk_packages` finds under `linearsfm_tpu_torch`, the tools
    included) and every module `chip_smoke.py` imports, at its top or
    inside its functions, pulls in neither jax nor the reference package
    (run in a fresh interpreter)."""
    code = (
        "import ast, importlib, importlib.util, pkgutil, sys\n"
        "import linearsfm_tpu_torch\n"
        "from linearsfm_tpu_torch import types\n"
        "from linearsfm_tpu_torch.ops import congruence, gauge, kernels, "
        "rotations, schur, segment, solve\n"
        "from linearsfm_tpu_torch.core import compact, dcompact, "
        "device_tree, join, plan\n"
        "from linearsfm_tpu_torch.parallel import level, mesh, multihost, "
        "shard_solve\n"
        "import linearsfm_tpu_torch.tools.multihost_worker\n"
        "from linearsfm_tpu_torch.utils import metrics\n"
        "import synth.generate\n"
        "walked = [m.name for m in pkgutil.walk_packages("
        "linearsfm_tpu_torch.__path__, 'linearsfm_tpu_torch.')]\n"
        "for name in walked:\n"
        "    importlib.import_module(name)\n"
        "smoke = set()\n"
        "for node in ast.walk(ast.parse(open('chip_smoke.py').read())):\n"
        "    if isinstance(node, ast.Import):\n"
        "        smoke.update(a.name for a in node.names)\n"
        "    elif isinstance(node, ast.ImportFrom) and node.level == 0:\n"
        "        smoke.add(node.module)\n"
        "        for a in node.names:\n"
        "            sub = node.module + '.' + a.name\n"
        "            if importlib.util.find_spec(node.module).submodule_search_"
        "locations and importlib.util.find_spec(sub):\n"
        "                smoke.add(sub)\n"
        "for name in sorted(smoke):\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'linearsfm_tpu' or m.startswith('linearsfm_tpu.')]\n"
        "assert not bad, bad\n"
        "need = {'linearsfm_tpu_torch.tools.compare_ate', "
        "'linearsfm_tpu_torch.tools.bench_root', "
        "'linearsfm_tpu_torch.tools.generate', "
        "'linearsfm_tpu_torch.cli'}\n"
        "assert need <= set(walked), sorted(need - set(walked))\n"
        "assert {'linearsfm_tpu_torch.ops.kernels', "
        "'linearsfm_tpu_torch.tools.compare_ate', "
        "'linearsfm_tpu_torch.tools.bench_root'} <= smoke, sorted(smoke)\n"
        "print('clean', len(walked), len(smoke))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().split()[0] == "clean", proc.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_cuda(dtype):
    """On the card: exact without duplicate coordinates, rtol 1e-6 (plus
    1e-6 of the largest magnitude) with them; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name in ("6x3 padding, duplicates, unsorted", "6x6 sorted rows",
                 "K = 0"):
        rows, cols, vals, M, N = (torch.as_tensor(a).cuda()
                                  if isinstance(a, np.ndarray) else a
                                  for a in _case(name))
        vals = vals.to(dtype)
        n0 = kernels.launches["blockcoo_to_dense"]
        got = kernels.blockcoo_to_dense(rows, cols, vals, M, N)
        ref = kernels.blockcoo_to_dense_ref(rows, cols, vals, M, N)
        torch.cuda.synchronize()
        scale = float(ref.abs().max()) if ref.numel() else 0.0
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6 * scale)
        assert kernels.launches["blockcoo_to_dense"] == n0 + (rows.numel() > 0)
    # a lane-folded batch with no duplicate coordinates: exact
    P, M, N = 8, 16, 16
    g = torch.Generator(device="cuda").manual_seed(5)
    key = torch.randperm(M * N, generator=g, device="cuda")[:100]
    rows = (key // N).expand(P, -1).contiguous()
    cols = (key % N).expand(P, -1).contiguous()
    rows[:, ::9] = -1
    vals = torch.randn((P, 100, 6, 3), generator=g, device="cuda", dtype=dtype)
    assert torch.equal(kernels.blockcoo_to_dense(rows, cols, vals, M, N),
                       kernels.blockcoo_to_dense_ref(rows, cols, vals, M, N))


def _inv3x3_card_cases(dtype):
    """Zero, NaN and near-singular blocks among random SPD ones, the level-1
    lane stack of the mono 2,048-map plan and its root join's shape."""
    g = torch.Generator(device="cuda").manual_seed(7)
    A = torch.randn((300, 3, 3), generator=g, device="cuda", dtype=dtype)
    V = A @ A.transpose(1, 2) + 0.5 * torch.eye(3, device="cuda", dtype=dtype)
    V[7] = 0.0
    V[11, 1, 2] = V[11, 2, 1] = float("nan")
    v = torch.randn(3, generator=g, device="cuda", dtype=dtype)
    V[13] = torch.outer(v, v)                      # rank 1: det ~ rounding
    V[17] = torch.outer(v, v) + 1e-6 * torch.eye(3, device="cuda", dtype=dtype)
    B = torch.randn((1024, 64, 3, 3), generator=g, device="cuda", dtype=dtype)
    R = torch.randn((1, 11648, 3, 3), generator=g, device="cuda", dtype=dtype)
    return {"special": V, "level-1 [1024, 64]": B @ B.transpose(-1, -2),
            "root [1, 11648]": R @ R.transpose(-1, -2),
            "empty": V[:0]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_inv3x3_kernel_matches_plain_on_cuda(dtype):
    """On the card K2 equals its plain version bit for bit (NaN where it is
    NaN); one launch per non-empty call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cases = _inv3x3_card_cases(dtype)
    for name, V in cases.items():
        n0 = kernels.launches["inv3x3_sym"]
        got = kernels.inv3x3_sym(V)
        ref = kernels.inv3x3_sym_ref(V)
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(got), torch.isnan(ref)), name
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref)), name
        assert kernels.launches["inv3x3_sym"] == n0 + (V.numel() > 0), name
    V = cases["level-1 [1024, 64]"]
    with pytest.raises(ValueError, match="contiguous"):
        kernels.inv3x3_sym(V.transpose(0, 1))
    with pytest.raises(TypeError):
        kernels.inv3x3_sym(V.to(torch.float16))


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# (name, P, M, N, K, C): M = 37 is no multiple of the tile's block rows;
# 3 * 53 f32 columns make rows of 636 bytes (plain-store branch); 3 * 100
# and 6 * 70 columns are no multiple of the tile width (192 f32 / 96 f64)
EDGE_CASES = [("6x3 M37 N53 plain stores", 1, 37, 53, 700, 3),
              ("6x3 M37 N100 ragged tiles", 2, 37, 100, 900, 3),
              ("6x6 M45 N70 ragged tiles", 3, 45, 70, 500, 6),
              ("6x3 one block row", 1, 1, 400, 300, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", EDGE_CASES, ids=lambda c: c[0])
def test_planned_kernel_tile_edges_on_cuda(case, dtype):
    """On the card, K1 on a plan equals a sequential scatter-add in list
    order on the host exactly (both add each coordinate's duplicates in list
    order), at tile edges and on stripe windows of one plan; one launch per
    planned call. (The plain version on the CPU may add float32 duplicates
    with parallel atomics once a list has 32,768 elements, so it is not the
    yardstick of order here.)"""
    _needs_card()
    _, P, M, N, K, C = case
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    rows, cols, vals = (torch.from_numpy(a) for a in
                        _plan_list(P, M, N, K, C, np_dtype, seed=M + N))
    plan = kernels.coo_plan(rows.cuda(), cols.cuda(), M, N)
    vals_d = vals.cuda()
    for lo, width in _windows(N):
        n0 = kernels.launches["blockcoo_to_dense"]
        got = kernels.blockcoo_to_dense_planned(plan, vals_d, lo, width)
        torch.cuda.synchronize()
        assert kernels.launches["blockcoo_to_dense"] == n0 + 1
        srows, scols = _masked_stripe(rows, cols, lo, width)
        want = np.stack([_dense_loop(srows[p].numpy(), scols[p].numpy(),
                                     vals[p].numpy(), M, width)
                         for p in range(P)])
        np.testing.assert_array_equal(got.cpu().numpy(), want,
                                      err_msg=f"{(lo, width)}")
    with pytest.raises(ValueError, match="match"):
        kernels.blockcoo_to_dense_planned(plan, vals_d[:, :-1].contiguous())


@pytest.mark.cuda
def test_planned_kernel_main_path_stripe_on_cuda():
    """A root-sized W list, whole: 2,048 block rows by 11,712 feature
    columns (f32 rows of 140,544 bytes, 183 tiles wide), equal to the
    plain version on the card (exact: no duplicate coordinates)."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(11)
    M, N, K = 2048, 11712, 60000
    key = torch.randperm(M * N, generator=g, device="cuda")[:K]
    rows, cols = (key // N)[None], (key % N)[None]
    rows[:, ::17] = -1
    vals = torch.randn((1, K, 6, 3), generator=g, device="cuda")
    plan = kernels.coo_plan(rows, cols, M, N)
    got = kernels.blockcoo_to_dense_planned(plan, vals)
    want = kernels.blockcoo_to_dense_ref(rows, cols, vals, M, N)
    assert torch.equal(got, want)


# (name, P, N, K): the fused K2 at tile edges (256 entries a tile), N = 0
# with K > 0, K = 0, several lanes, and operands off 16-byte alignment
WY_CARD_CASES = [("K=0", 3, 50, 0), ("N=0 padding", 2, 0, 300),
                 ("K=T-1", 1, 40, 255), ("K=T", 1, 40, 256),
                 ("K=T+1", 1, 40, 257), ("lanes, odd P*K", 3, 70, 171),
                 ("two tiles + 3", 1, 300, 515), ("unaligned", 1, 33, 301)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", WY_CARD_CASES, ids=lambda c: c[0])
def test_inv3x3_wy_kernel_matches_plain_on_cuda(case, dtype):
    """On the card the fused K2 equals its plain version bit for bit (NaN
    where it is NaN) for both outputs, with zero and NaN blocks and entries
    whose wf is outside [0, N); one launch per call."""
    _needs_card()
    name, P, N, K = case
    g = torch.Generator(device="cuda").manual_seed(P * 1000 + N + K)
    A = torch.randn((P, N + 1, 3, 3), generator=g, device="cuda", dtype=dtype)
    V = A @ A.transpose(-1, -2)
    if N > 11:
        V[:, 7] = 0.0
        V[:, 11, 1, 2] = V[:, 11, 2, 1] = float("nan")
    W = torch.randn((P, K + 1, 6, 3), generator=g, device="cuda", dtype=dtype)
    wf = torch.randint(-2, N + 2, (P, K + 1), generator=g, device="cuda")
    Wpf = torch.stack([torch.zeros_like(wf), wf], dim=-1)
    Wpf[:, ::7], W[:, ::7] = 0, 0.0                  # padding
    if name == "unaligned":   # contiguous views 72 and 36 bytes in
        V, W, Wpf = V[:, 1:], W[:, 1:], Wpf[:, 1:]
    else:
        V, W, Wpf = (t[:, :-1].contiguous() for t in (V, W, Wpf))
    assert V.is_contiguous() and W.is_contiguous() and Wpf.is_contiguous()
    n0 = kernels.launches["inv3x3_sym"]
    got = kernels.inv3x3_wy(V, W, Wpf)
    want = kernels.inv3x3_wy_ref(V, W, Wpf)
    torch.cuda.synchronize()
    assert kernels.launches["inv3x3_sym"] == n0 + (P * (N + K) > 0)
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape and _nan_equal(g_, w_), name
    with pytest.raises(TypeError):
        kernels.inv3x3_wy(V, W, Wpf.to(torch.int32))
    if K > 1:
        with pytest.raises(ValueError, match="contiguous"):
            kernels.inv3x3_wy(V, W[:, ::2], Wpf[:, ::2])


@pytest.mark.cuda
def test_direct_solve_float64_level_batch_on_cuda():
    """The direct executor's level 10 at 2,048 maps: two 6,144-wide float64
    systems solved as one batch. `torch.cholesky_solve` raised "CUDA error:
    invalid argument" on exactly this batch on the H100 (torch 2.11.0+cu128);
    `solve.cholesky_solve` solves it with two triangular solves, to the
    residual of a float64 Cholesky."""
    _needs_card()
    from linearsfm_tpu_torch.ops import solve
    g = torch.Generator(device="cuda").manual_seed(12)
    d = 6144
    A = torch.randn((2, d, d), generator=g, device="cuda",
                    dtype=torch.float64) / d ** 0.5
    S = A @ A.transpose(-1, -2) + torch.eye(d, device="cuda",
                                            dtype=torch.float64)
    E = torch.randn((2, d), generator=g, device="cuda", dtype=torch.float64)
    x = solve.cholesky_solve(S, E)
    r = (S @ x[..., None])[..., 0] - E
    assert float(r.abs().max() / E.abs().max()) < 1e-10


@pytest.mark.cuda
def test_pcg_preconditioner_float32_level_batch_on_cuda():
    """The refine preconditioner at the 3,499-map stereo tree's level 11:
    two 12,288-wide float32 systems factored and solved as one batch
    (`schur.precond_factor`'s sch32). `torch.cholesky_solve` raised "CUDA
    error: invalid argument" on this batch on the H100 (torch
    2.11.0+cu128); two triangular solves solve it to float32 accuracy."""
    _needs_card()
    from linearsfm_tpu_torch.ops import schur
    g = torch.Generator(device="cuda").manual_seed(13)
    d = 12288
    A = torch.randn((2, d, d), generator=g, device="cuda") / d ** 0.5
    S = A @ A.transpose(-1, -2) + torch.eye(d, device="cuda")
    del A
    E = torch.randn((2, d), generator=g, device="cuda")
    fixed = torch.zeros((2, d), dtype=torch.bool, device="cuda")
    sch32, E32 = schur.precond_factor(S.clone(), E, fixed)
    x = sch32(E32)
    r = (S @ x[..., None])[..., 0] - E
    assert bool(torch.isfinite(x).all())
    assert float(r.abs().max() / E.abs().max()) < 1e-3


@pytest.mark.cuda
def test_sharded_full_mixed_on_cuda():
    """On the card, the feature-sharded PCG over four shards of one device
    ("cuda:0" four times) launches K2, K1 (A) and K4 (the Schur product
    of the shard's W entries) once per shard and agrees with the
    single-device solve to 1e-9."""
    _needs_card()
    from linearsfm_tpu_torch.ops import schur
    from linearsfm_tpu_torch.parallel import mesh, shard_solve
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(21)
    M, N, f64 = 8, 40, torch.float64
    A = torch.randn((M, 6, 6), generator=g, dtype=f64)
    diag = A @ A.transpose(-1, -2) + 5 * torch.eye(6, dtype=f64)
    U = torch.cat([diag, 0.1 * torch.randn((M - 1, 6, 6), generator=g,
                                           dtype=f64)])
    Uij = torch.cat([torch.arange(M).expand(2, M).T,
                     torch.stack([torch.arange(M - 1),
                                  torch.arange(1, M)], dim=1)])
    wf = torch.arange(N).repeat_interleave(3)
    wp = torch.randint(0, M, (3 * N,), generator=g)
    W = 0.3 * torch.randn((3 * N, 6, 3), generator=g, dtype=f64)
    B = torch.randn((N, 3, 3), generator=g, dtype=f64)
    V = B @ B.transpose(-1, -2) + 3 * torch.eye(3, dtype=f64)
    eP = torch.randn((M, 6), generator=g, dtype=f64)
    eF = torch.randn((N, 3), generator=g, dtype=f64)
    ops = [t[None].cuda() for t in (U, Uij, W, torch.stack([wp, wf], 1), V,
                                     eP, eF)]
    fixed = torch.zeros((1, 6 * M), dtype=torch.bool, device="cuda")
    n0 = dict(kernels.launches)
    xp, xf, res = shard_solve.sharded_full_mixed(
        *ops, M, fixed, mesh.Mesh(("cuda:0",) * 4, "fs"), iters=16)
    torch.cuda.synchronize()
    assert kernels.launches["inv3x3_sym"] - n0["inv3x3_sym"] == 4
    assert (kernels.launches["blockcoo_to_dense"]
            - n0["blockcoo_to_dense"]) == 4
    assert kernels.launches["schur_pairs"] - n0["schur_pairs"] == 4
    want = schur.solve_full_mixed(*ops, M, fixed, force_dense=True,
                                  iters=16)
    torch.testing.assert_close(xp, want[0], atol=1e-9, rtol=0)
    torch.testing.assert_close(xf, want[1], atol=1e-9, rtol=0)
    assert float(res[0]) < 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAIR_CASES + [("root-like one lane", 1, 600,
                                                 2400, 60000)],
                         ids=lambda c: c[0])
def test_schur_pairs_kernel_matches_plain_on_cuda(case):
    """On the card K4 equals its plain version on the CPU bit for bit (S
    and E), two launches give the same bits, one launch a call; float64
    and non-contiguous operands raise."""
    _needs_card()
    from linearsfm_tpu_torch.ops import schur
    _, P, M, N, K = case
    A, eP, W, Y, eF, Wpf = _pair_case(P, M, N, K)
    want = _pairs_plain(A, eP, W, Y, eF, Wpf, M, N)
    W_d, Y_d, eF_d, Wpf_d = (torch.from_numpy(a).cuda() for a in
                             (W, Y, eF, Wpf))
    plan = schur.w_plan(W_d, Wpf_d, M, N)
    got = []
    for _ in range(2):
        S, E = torch.from_numpy(A).cuda(), torch.from_numpy(eP).cuda()
        n0 = kernels.launches["schur_pairs"]
        kernels.schur_pairs(S, E, W_d, Y_d, eF_d, plan)
        torch.cuda.synchronize()
        assert kernels.launches["schur_pairs"] == n0 + 1
        got.append((S.cpu(), E.cpu()))
    for g_, w_ in zip(got[0], want):
        assert torch.equal(g_, w_)
    for a, b in zip(*got):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        kernels.schur_pairs(S.double(), E, W_d, Y_d, eF_d, plan)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.schur_pairs(S.transpose(1, 2), E, W_d, Y_d, eF_d, plan)


# K5 on the card against its plain version, per float field: |kernel -
# plain| <= tol x the plain field's largest magnitude. The Jacobians come
# from dual numbers where the plain version's come from jacfwd's tangent
# rules (a few ulps apart), and every product and sum is taken in another
# fixed order (the emission sums in list order, the cross sums over the
# segments' emissions): float64 rounding, eps 1.1e-16, over sums of up to
# about 10^4 terms whose magnitudes exceed the field's largest by at most
# about 100 through cancellation, bounds the difference by about 1e-10;
# float32 information (eps 6e-8) over the small cases' sums of at most 40
# terms by about 1e-5.
K5_TOL = {torch.float64: 1e-10, torch.float32: 1e-5}


def _k5_assert_close(tag, got, want):
    for f, a, b in zip(_k5_names(), _k5_fields(got), _k5_fields(want)):
        assert a.shape == b.shape and a.dtype == b.dtype, (tag, f)
        if not a.is_floating_point():
            assert torch.equal(a, b), (tag, f)
            continue
        assert torch.isfinite(a).all() and torch.isfinite(b).all(), (tag, f)
        scale = float(b.abs().max()) if b.numel() else 0.0
        err = float((a - b).abs().max()) if b.numel() else 0.0
        assert err <= K5_TOL[a.dtype] * scale, (tag, f, err, scale)


def _k5_names():
    from linearsfm_tpu_torch import types
    return list(types.MAP_FIELDS) + [f"gauge.{f}" for f in types.GAUGE_FIELDS]


def _k5_same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(_k5_fields(a),
                                                   _k5_fields(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("info", [None, "float32"])
@pytest.mark.parametrize("datatype", ["stereo", "mono"])
def test_gauge_congruence_kernel_matches_plain_on_cuda(datatype, info):
    """K5 against the plain transform on the card (padded slots and
    entries; mono: one lane per projection case) within K5_TOL; one count
    a call; a second call gives the same bits."""
    _needs_card()
    lm, new = _k5_case(datatype, device="cuda")
    want = _k5_call(f"transform_map_{datatype}_ref", lm, new, info)
    n0 = kernels.launches["gauge_congruence"]
    got = _k5_call(f"transform_map_{datatype}", lm, new, info)
    again = _k5_call(f"transform_map_{datatype}", lm, new, info)
    torch.cuda.synchronize()
    assert kernels.launches["gauge_congruence"] == n0 + 2
    _k5_assert_close(f"{datatype} {info}", got, want)
    assert _k5_same_bits(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("fix", range(6))
def test_gauge_congruence_pinned_coordinate_on_cuda(fix):
    """Each pinned coordinate on the card: 0-2 match the plain version,
    3-5 (which the plain version refuses) give NaN states in every lane."""
    _needs_card()
    lm, new = _k5_case("mono", device="cuda", fix=fix)
    got = _k5_call("transform_map_mono", lm, new, None)
    torch.cuda.synchronize()
    if fix < 3:
        _k5_assert_close(f"fix {fix}", got, _k5_call(
            "transform_map_mono_ref", lm, new, None))
    else:
        assert not torch.isfinite(got.poses).flatten(1).all(1).any()


def _k5_cell_calls(cell):
    """The first K5 call (level 1's merge transform) and the last call on
    one lane (the root's) of a solve of the benchmark cell's first set
    (seed 0), as (map, new gauge ids, info dtype)."""
    import json
    from benchmark import gen
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    with open(os.path.join(REPO, "benchmark", "configs", f"{cell}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(REPO, "benchmark", "traffic", "covis.json")) as f:
        mix = json.load(f)
    maps = gen.make_set(cfg, mix, 0, 0)
    calls = []
    saved = kernels.gauge_congruence

    def spy(lm, mono, new, info_dtype=None):
        calls.append((lm, new, info_dtype))
        return saved(lm, mono, new, info_dtype)
    kernels.gauge_congruence = spy
    try:
        DeviceTreeSolver(cfg["datatype"], method=cfg["method"]).run(maps)
    finally:
        kernels.gauge_congruence = saved
    return cfg["datatype"], calls[0], [c for c in calls
                                       if c[0].poses.shape[0] == 1][-1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["nc3500_stereo", "rs468_mono",
                                  "mono3499_refine"])
def test_gauge_congruence_cell_shapes_on_cuda(cell):
    """K5 against the plain transform on the inputs of a benchmark cell's
    level-1 and root calls, within K5_TOL, two calls bit for bit."""
    _needs_card()
    from linearsfm_tpu_torch.ops import segment
    torch.backends.cuda.matmul.allow_tf32 = False
    datatype, *cases = _k5_cell_calls(cell)
    for where, (lm, new, info) in zip(("level 1", "root"), cases):
        with segment.deterministic():
            want = _k5_call(f"transform_map_{datatype}_ref", lm, new, info)
            got = _k5_call(f"transform_map_{datatype}", lm, new, info)
            again = _k5_call(f"transform_map_{datatype}", lm, new, info)
        torch.cuda.synchronize()
        _k5_assert_close(f"{cell} {where} {tuple(lm.U.shape[:2])}", got,
                         want)
        assert _k5_same_bits(got, again), (cell, where)


@pytest.mark.cuda
@pytest.mark.parametrize("datatype", ["stereo", "mono"])
def test_gauge_congruence_dispatches_few_ops_on_cuda(datatype):
    """One K5 call dispatches at most 60 aten operations (the plain
    version: about 1,000 stereo, 1,500 mono)."""
    _needs_card()
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))
    lm, new = _k5_case(datatype, device="cuda")
    _k5_call(f"transform_map_{datatype}", lm, new, None)   # the build
    with Count():
        _k5_call(f"transform_map_{datatype}", lm, new, None)
    n_kernel = Count.n
    Count.n = 0
    with Count():
        _k5_call(f"transform_map_{datatype}_ref", lm, new, None)
    assert n_kernel <= 60, n_kernel
    assert Count.n > 10 * n_kernel, (Count.n, n_kernel)


@pytest.mark.cuda
def test_gauge_congruence_refuses_bad_inputs_on_cuda():
    """Non-contiguous, float32-state, int32-index and cross-device inputs
    raise, and count no launch."""
    _needs_card()
    import dataclasses
    lm, new = _k5_case("mono", device="cuda")
    n0 = kernels.launches["gauge_congruence"]
    bad = [
        (ValueError, "contiguous", dataclasses.replace(
            lm, U=lm.U.transpose(2, 3).contiguous().transpose(2, 3)), new),
        (TypeError, "float64 states", dataclasses.replace(
            lm, poses=lm.poses.float()), new),
        (TypeError, "int64", dataclasses.replace(
            lm, Uij=lm.Uij.to(torch.int32)), new),
        (ValueError, "tensor on", lm, (new[0].cpu(), *new[1:])),
    ]
    for exc, match, m, ids in bad:
        with pytest.raises(exc, match=match):
            _k5_call("transform_map_mono", m, ids, None)
    assert kernels.launches["gauge_congruence"] == n0
