"""Kernels K1 (`blockcoo_to_dense`) and K2 (`inv3x3_sym`) of the PyTorch port.

* K1's plain PyTorch version against the reference's Pallas kernel in
  interpret mode (the cases of tests/test_pallas.py, K = 0, a lane-folded
  batch), exactly: both sum duplicates in list order;
* K2's plain version against the reference's `schur.inv3x3_sym` and its
  Pallas kernel in interpret mode (tests/test_pallas.py inputs, float32, a
  NaN block, a lane stack);
* the wrappers' dispatch: CPU tensors take the plain version and count no
  launch; a device without a kernel raises instead of falling back;
* the port imports neither jax nor the reference package;
* on a CUDA card (marker `cuda`), each kernel against its plain version in
  float32 and float64.

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
    """schur.inv3x3_sym takes the plain version on the CPU (no launch, also
    for a non-contiguous V); a device without a kernel raises."""
    from linearsfm_tpu_torch.ops import schur

    V = torch.from_numpy(_inv3x3_input("lane stack [P, N]"))
    before = dict(kernels.launches)
    assert torch.equal(schur.inv3x3_sym(V), kernels.inv3x3_sym_ref(V))
    Vt = V.transpose(0, 1)                          # not contiguous
    assert torch.equal(schur.inv3x3_sym(Vt), kernels.inv3x3_sym_ref(Vt))
    assert kernels.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        kernels.inv3x3_sym(torch.empty((4, 3, 3), device="meta"))


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither jax nor the
    reference package (run in a fresh interpreter)."""
    code = (
        "import sys\n"
        "import linearsfm_tpu_torch\n"
        "from linearsfm_tpu_torch import types\n"
        "from linearsfm_tpu_torch.ops import congruence, gauge, kernels, "
        "rotations, schur, segment, solve\n"
        "from linearsfm_tpu_torch.core import compact, dcompact, "
        "device_tree, join, plan\n"
        "from linearsfm_tpu_torch.utils import metrics\n"
        "import synth.generate\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'linearsfm_tpu' or m.startswith('linearsfm_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


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
