"""The port's entry points called as the JAX package's callers call them.

`DeviceTreeSolver`, `TreeSolver`, `DenseTreeSolver` and `pipeline.run`
with no device argument: they run on the card (the `cuda` test, which
skips without one), and with no CUDA device they raise, naming
`device="cpu"`, rather than fall back to the CPU. The file imports no JAX,
so the `cuda` test runs on a machine without it: `python -m pytest
--noconftest tests/test_torch_entry_points.py -m cuda`.
"""

import pytest
import torch

from synth import generate as gen
from linearsfm_tpu_torch.core import pipeline as tpipeline
from linearsfm_tpu_torch.core.dense_tree import DenseTreeSolver
from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
from linearsfm_tpu_torch.core.tree import TreeSolver
from linearsfm_tpu_torch.io import localmap as tio
from linearsfm_tpu_torch.ops import kernels

# one intra-op thread: the suite's workers share the machine's cores, and
# an oversubscribed thread pool slows the trees' small ops many times over
torch.set_num_threads(1)

ENTRIES = ["DeviceTreeSolver", "TreeSolver", "DenseTreeSolver",
           "pipeline.run"]


def _entry_calls(data):
    """The four entry points as the JAX package's callers write them: no
    device argument."""
    return {
        "DeviceTreeSolver": lambda: DeviceTreeSolver("stereo"),
        "TreeSolver": lambda: TreeSolver("stereo"),
        "DenseTreeSolver": lambda: DenseTreeSolver("stereo"),
        "pipeline.run": lambda: tpipeline.run(data, 3, "stereo",
                                              progress=False),
    }


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_default_to_the_card(tmp_path, entry, monkeypatch):
    """With no device argument the entry points ask for the card; with no
    CUDA device (hidden here where there is one) they raise, naming
    device="cpu", and nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    maps, _, _ = gen.make_dataset(3, "stereo", noise=0.005, seed=0)
    tio.write_dataset(maps, str(tmp_path))
    with pytest.raises(RuntimeError, match='no CUDA device; pass '
                                           'device="cpu"'):
        _entry_calls(str(tmp_path))[entry]()


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_default_to_the_card_on_cuda(tmp_path, entry):
    """The same calls on a CUDA machine solve on cuda:0: the solvers'
    device, the device tree's root poses, K2 launched at every executor's
    joins and K1 in the dense assemblies (the host executor, the
    pipeline's default, assembles these small joins grouped); the device
    and host executors also sum in the fixed order (K3) and transform on
    the card (K5), and the device executor's refine joins form their f32
    Schur product with K4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    maps, _, _ = gen.make_dataset(13, "stereo", noise=0.005, seed=0)
    tio.write_dataset(maps, str(tmp_path))
    n0 = dict(kernels.launches)
    got = _entry_calls(str(tmp_path))[entry]()
    if entry != "pipeline.run":
        assert got.device == torch.device("cuda", 0)
        out = got.run(maps)
        if entry == "DeviceTreeSolver":
            assert out.poses.device == torch.device("cuda", 0)
    torch.cuda.synchronize()
    ran = {k for k in n0 if kernels.launches[k] > n0[k]}
    want = {"DeviceTreeSolver": {"blockcoo_to_dense", "inv3x3_sym",
                                 "seg_sum_fixed", "schur_pairs",
                                 "gauge_congruence"},
            "TreeSolver": {"inv3x3_sym", "seg_sum_fixed", "gauge_congruence"},
            "DenseTreeSolver": {"blockcoo_to_dense", "inv3x3_sym"}}
    want["pipeline.run"] = want["TreeSolver"]
    assert ran == want[entry], ran
