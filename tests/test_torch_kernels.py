"""Kernel K1 (`blockcoo_to_dense`) of the PyTorch port.

* its plain PyTorch version against the reference's Pallas kernel in
  interpret mode (the cases of tests/test_pallas.py, K = 0, a lane-folded
  batch), exactly: both sum duplicates in list order;
* the wrapper's dispatch: CPU tensors take the plain version and count no
  launch; a device without a kernel raises instead of falling back;
* the port imports neither jax nor the reference package;
* on a CUDA card (marker `cuda`), the kernel against the plain version in
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
