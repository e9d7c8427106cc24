"""PyTorch port vs the JAX reference: the multi-process tree.

Process-local subtrees and a replicated top (parallel/multihost.py) against
the reference's decomposition, first in one process with the gather
stubbed by every host's contribution (tests/test_multihost.py's cases),
then as two real processes of the port's worker over gloo on the CPU.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import helpers as H  # noqa: F401
from synth import generate as gen
from linearsfm_tpu.core.device_tree import DeviceTreeSolver as JaxTree
from linearsfm_tpu.parallel import multihost as JMH
from linearsfm_tpu_torch import types
from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver as TorchTree
from linearsfm_tpu_torch.parallel import multihost as TMH

# one intra-op thread: the suite's workers share the machine's cores, and
# an oversubscribed thread pool slows the trees' small ops many times over
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dataset(n, datatype):
    maps, _, _ = gen.make_dataset(n, datatype, noise=0.01, seed=3,
                                  covis_radius=3.0, covis_max=4)
    return maps


def _poses_by_id(final):
    h = types.host_fields(final)
    return {int(i): h.poses[k] for k, i in enumerate(h.pose_ids) if i >= 0}


def _simulated(mh, maps, datatype, n_hosts, kw):
    """Every host's local phase in this process; the gather hands back the
    contributions (the top is replicated, so host 0 stands for all)."""
    stacks = [mh.local_stacked(maps, datatype, n_hosts, h, kw)
              for h in range(n_hosts)]
    return mh.run_multihost(maps, datatype, n_hosts=n_hosts, host_id=0,
                            gather=lambda _mine: stacks, solver_kw=kw)


@pytest.mark.parametrize("datatype,n,n_hosts", [
    ("stereo", 8, 2), ("mono", 6, 2),
    # odd count: a partial tail block rides the schedule as the carry
    ("stereo", 11, 2)])
def test_multihost_matches_reference(datatype, n, n_hosts):
    """Direct method (full f64): port vs reference, both decomposed, to
    1e-10, and the port's decomposition equal to its single-process solve
    to 1e-10; the common root capacities are the reference's."""
    maps = _dataset(n, datatype)
    lms = [m.to_local_map() for m in maps]
    want = _poses_by_id(_simulated(JMH, lms, datatype, n_hosts,
                                   dict(method="direct")))
    kw = dict(method="direct", device="cpu")
    got = _poses_by_id(_simulated(TMH, maps, datatype, n_hosts, kw))
    single = _poses_by_id(TorchTree(datatype, **kw).run(maps))
    assert got.keys() == want.keys() == single.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-10,
                                   err_msg=f"pose {k}")
        np.testing.assert_allclose(got[k], single[k], atol=1e-10,
                                   err_msg=f"pose {k}")
    assert (TMH.common_root_caps(maps, datatype, n_hosts)
            == JMH.common_root_caps(lms, datatype, n_hosts))


@pytest.mark.parametrize("n_hosts", [2, 4, 5])
def test_plan_chunks_matches_reference(n_hosts):
    """The 3,499-map decomposition (the reference's NC3500 count): blocks,
    owners and spans equal the reference's, tile the sequence and stay
    aligned through each block's depth."""
    L, block, owners = TMH.plan_chunks(3499, n_hosts)
    assert (L, block, owners) == JMH.plan_chunks(3499, n_hosts)
    spans = TMH._block_spans(3499, block, 0, owners[-1][1])
    assert spans == JMH._block_spans(3499, block, 0, owners[-1][1])
    assert spans[0][0] == 0 and spans[-1][1] == 3499
    for lo, hi in spans:
        assert lo % block == 0 and 0 < hi - lo <= block
        assert lo % (1 << TMH._levels_of(hi - lo)) == 0
    with pytest.raises(ValueError):
        TMH.plan_chunks(0, n_hosts)


def test_multihost_needs_a_device(monkeypatch):
    """With no device in solver_kw the solve asks for the card, as every
    entry point does; with no CUDA device it raises, naming device="cpu",
    and does not solve on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TMH.run_multihost(_dataset(4, "stereo"), "stereo", n_hosts=1,
                          solver_kw=dict(method="direct"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_gloo(tmp_path):
    """Two ranks of the port's worker (gloo over TCP on localhost, CPU):
    each rank's poses equal the single-process solve's to 1e-10."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "linearsfm_tpu_torch.tools.multihost_worker",
         f"127.0.0.1:{port}", "2", str(rank), str(tmp_path), "--device",
         "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, f"rank {rank}:\n{outs[rank][-3000:]}"
    maps = _dataset(8, "stereo")
    ref = _poses_by_id(TorchTree("stereo", method="direct",
                                 device="cpu").run(maps))
    for rank in range(2):
        f = np.load(tmp_path / f"result_{rank}.npz")
        got = {int(i): p for i, p in zip(f["ids"], f["poses"])}
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], atol=1e-10,
                                       err_msg=f"rank {rank} pose {k}")
