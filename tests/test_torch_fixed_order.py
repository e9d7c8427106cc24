"""The fixed summation order on every executor path but the dense one.

On the card the port sums every floating-point segment in list order
(kernel K3) inside `ops/segment.deterministic()`, which the device and host
executors enter for every run, as the JAX package's XLA sums in a fixed
order; K3 sorts each index list once per join (`segment.planned`). Here,
on the CPU, where `index_add_` already adds in list order:

* every floating-point `seg_sum` / `index_add` of every executor path and
  entry point runs inside the scope (a spy on `segment._k3`), and the
  dense executor sends no sum through it;
* with the K3 route forced on the CPU (`segment._k3` true inside the
  scope: `kernels.seg_sum_fixed` runs its plain version), small refine
  trees give the same bits as the default route, and K3's plans number
  the distinct index lists of each join, not its sweeps times its lists;
* the grid pattern, which amplifies rounding by orders of magnitude more
  than the loop pattern of the other parity tests: the JAX package and the
  port on one grid mono covis set, refine and direct.
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from synth import generate as gen
from linearsfm_tpu.core.device_tree import DeviceTreeSolver as JaxTree
from linearsfm_tpu_torch import cli as tcli
from linearsfm_tpu_torch import types
from linearsfm_tpu_torch.core import pipeline as tpipeline
from linearsfm_tpu_torch.core.dense_tree import DenseTreeSolver
from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
from linearsfm_tpu_torch.core.tree import TreeSolver
from linearsfm_tpu_torch.io import localmap as tio
from linearsfm_tpu_torch.ops import kernels, segment
from linearsfm_tpu_torch.parallel import multihost as tmh
from linearsfm_tpu_torch.parallel.mesh import Mesh
from linearsfm_tpu_torch.tools import bench, multihost_worker

# one intra-op thread: the suite's workers share the machine's cores, and
# an oversubscribed thread pool slows the trees' small ops many times over
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _maps(n, datatype, seed=3):
    return gen.make_dataset(n, datatype, noise=0.01, seed=seed,
                            covis_radius=3.0, covis_max=4)[0]


@pytest.fixture
def scope_spy(monkeypatch):
    """Records, for every sum that reaches `segment._k3`, whether it was a
    floating-point sum and whether the fixed-order scope was open."""
    seen = []
    k3 = segment._k3

    def spy(x):
        seen.append((x.is_floating_point(), segment._fixed > 0))
        return k3(x)
    monkeypatch.setattr(segment, "_k3", spy)
    return seen


def _simulated_multihost(maps, datatype):
    """Two hosts' local phases in this process, then host 0's top."""
    kw = dict(method="direct", device="cpu")
    stacks = [tmh.local_stacked(maps, datatype, 2, h, kw) for h in range(2)]
    return tmh.run_multihost(maps, datatype, n_hosts=2, host_id=0,
                             gather=lambda _mine: stacks, solver_kw=kw)


def _pipeline(tmp, datatype, executor, method):
    maps = _maps(5, datatype)
    tio.write_dataset(maps, str(tmp))
    return tpipeline.run(str(tmp), 5, datatype, method=method,
                         progress=False, executor=executor, device="cpu")


def _cli(tmp, datatype):
    maps = _maps(5, datatype)
    tio.write_dataset(maps, str(tmp / "data"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tcli.main(["-path", str(tmp / "data"), "-num", "5", "-type",
                        "Monocular" if datatype == "mono" else "Stereo",
                        "-p", str(tmp / "p.txt"), "-f", str(tmp / "f.txt"),
                        "-st", str(tmp / "st.txt"), "--cpu", "--quiet",
                        "--check"])
    assert rc == 0 and "LinearSFM Check: OK" in out.getvalue()


def _worker(tmp):
    assert multihost_worker.main(["localhost:0", "1", "0", str(tmp),
                                  "--device", "cpu", "--maps", "5"]) == 0


def _bench(datatype, method, executor="device"):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = bench.main(["--cpu"], dict(BENCH_MAPS="5", BENCH_TYPE=datatype,
                                        BENCH_METHOD=method,
                                        BENCH_EXEC=executor))
    assert rc == 0 and out.getvalue().strip()


def _mesh(n):
    return Mesh(("cpu",) * n)


# every path of the fixed order: name -> fn(tmp_path)
PATHS = {
    "device stereo refine": lambda t: DeviceTreeSolver(
        "stereo", device=CPU).run(_maps(5, "stereo")),
    "device stereo direct": lambda t: DeviceTreeSolver(
        "stereo", method="direct", device=CPU).run(_maps(5, "stereo")),
    "device mono refine": lambda t: DeviceTreeSolver(
        "mono", device=CPU).run(_maps(5, "mono")),
    "device mono direct": lambda t: DeviceTreeSolver(
        "mono", method="direct", device=CPU).run(_maps(5, "mono")),
    "device mono refine pin zero": lambda t: DeviceTreeSolver(
        "mono", pin="zero", device=CPU).run(_maps(5, "mono")),
    "device mono direct pin zero": lambda t: DeviceTreeSolver(
        "mono", method="direct", pin="zero", device=CPU).run(
            _maps(5, "mono")),
    "device stereo mixed_max_m": lambda t: DeviceTreeSolver(
        "stereo", mixed_max_m=8, device=CPU).run(_maps(5, "stereo")),
    # dp levels and a feature-sharded (tp) root
    "device stereo mesh": lambda t: DeviceTreeSolver(
        "stereo", mesh=_mesh(2), root_shard_min=0, device=CPU).run(
            _maps(8, "stereo")),
    "device mono mesh": lambda t: DeviceTreeSolver(
        "mono", mesh=_mesh(2), root_shard_min=0, device=CPU).run(
            _maps(9, "mono")),
    "host stereo direct": lambda t: TreeSolver(
        "stereo", device=CPU).run(_maps(5, "stereo")),
    "host mono refine": lambda t: TreeSolver(
        "mono", method="refine", device=CPU).run(_maps(5, "mono")),
    "host stereo serial": lambda t: TreeSolver(
        "stereo", strategy="serial", device=CPU).run(_maps(5, "stereo")),
    "host stereo meshes": lambda t: TreeSolver(
        "stereo", mesh=_mesh(2), root_mesh=_mesh(2), root_shard_min=8,
        device=CPU).run(_maps(8, "stereo")),
    "multihost simulated stereo": lambda t: _simulated_multihost(
        _maps(8, "stereo"), "stereo"),
    "multihost simulated mono": lambda t: _simulated_multihost(
        _maps(6, "mono"), "mono"),
    "multihost worker": _worker,
    "pipeline device mono": lambda t: _pipeline(t, "mono", "device",
                                                "refine"),
    "pipeline host stereo": lambda t: _pipeline(t, "stereo", "host",
                                                "direct"),
    "cli stereo": lambda t: _cli(t, "stereo"),
    "cli mono": lambda t: _cli(t, "mono"),
    "bench stereo refine": lambda t: _bench("stereo", "refine"),
    "bench mono direct": lambda t: _bench("mono", "direct"),
    "bench host stereo": lambda t: _bench("stereo", "direct", "host"),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_every_path_sums_in_the_scope(path, scope_spy, tmp_path):
    """Every floating-point segment sum of the path runs inside
    `segment.deterministic()`, where the card takes K3."""
    PATHS[path](tmp_path)
    floats = [fixed for is_float, fixed in scope_spy if is_float]
    assert floats, f"{path}: no floating-point sum seen"
    assert all(floats), (f"{path}: {floats.count(False)} of {len(floats)} "
                         f"floating-point sums outside the fixed-order scope")
    assert segment._fixed == 0 and segment._plans is None


@pytest.mark.parametrize("run", [
    lambda: DenseTreeSolver("stereo", device=CPU).run(_maps(5, "stereo")),
    lambda: DenseTreeSolver("mono", method="direct", mixed_max_m=0,
                            device=CPU).run(_maps(5, "mono")),
    lambda: _bench("stereo", "refine", "dense"),
], ids=["dense stereo refine", "dense mono direct", "bench dense stereo"])
def test_dense_executor_sends_no_sum_through_k3(run, scope_spy):
    """The dense executor's sums stay out of `ops/segment` (its scatters add
    at most one value per row: `DenseTreeSolver`'s docstring), so K3 can
    run on no dense path."""
    run()
    assert not [s for s in scope_spy if s[0]]


@pytest.fixture
def k3_on_cpu(monkeypatch):
    """The K3 route forced on the CPU: inside the scope every
    floating-point sum goes through `kernels.seg_sum_fixed` (its plain
    version here) on a plan; records every plan built, with the plan scope
    it was built in, and every K3 sum."""
    plans, sums = [], []
    seg_plan, seg_sum_fixed = kernels.seg_plan, kernels.seg_sum_fixed

    def plan(idx, num):
        plans.append((segment._plans, (idx.untyped_storage().data_ptr(),
                                       idx.storage_offset(),
                                       tuple(idx.shape), idx.stride(),
                                       idx._version, num)))
        return seg_plan(idx, num)

    def fixed_sum(*a, **k):
        sums.append(segment._plans)
        return seg_sum_fixed(*a, **k)
    monkeypatch.setattr(segment, "_k3", lambda x: segment._fixed > 0
                        and x.is_floating_point())
    monkeypatch.setattr(kernels, "seg_plan", plan)
    monkeypatch.setattr(kernels, "seg_sum_fixed", fixed_sum)
    return plans, sums


@pytest.mark.parametrize("datatype", ["stereo", "mono"])
def test_k3_route_same_bits_and_plans_once_per_join(datatype, k3_on_cpu):
    """A small refine tree through the K3 route (plain version) gives the
    same bits as the default CPU route; inside each join's plan scope no
    index list is sorted twice; and more PCG sweeps add sums but no plan."""
    plans, sums = k3_on_cpu
    maps = _maps(9, datatype)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(segment, "_k3", lambda x: False)
        want = types.to_numpy(DeviceTreeSolver(datatype, device=CPU).run(
            maps))
    counts = {}
    for iters in (3, 6):
        plans.clear()
        sums.clear()
        got = types.to_numpy(DeviceTreeSolver(
            datatype, refine_iters=iters, top_min_m=1 << 20,
            device=CPU).run(maps))
        counts[iters] = (len(plans), len(sums))
        if iters == 3:
            for f in ("pose_ids", "poses", "feats"):
                assert np.array_equal(getattr(got, f), getattr(want, f)), f
        scoped = [key for scope, key in plans if scope is not None]
        by_scope = {}
        for scope, key in plans:
            if scope is not None:
                by_scope.setdefault(id(scope), []).append(key)
        assert scoped and all(len(set(k)) == len(k)
                              for k in by_scope.values())
        assert len(plans) < len(sums)
    assert counts[6][0] == counts[3][0], counts
    assert counts[6][1] > counts[3][1], counts


def test_plan_memo_keys():
    """`segment.planned()`: one plan per list while the scope lasts (views
    of one list with its storage, offset, shape and strides share it); a
    rewritten list or another view gets a new plan; nested scopes share the
    outer one's plans, which its exit drops."""
    idx = torch.tensor([[2, 0, 2, 1, 5], [0, 0, 3, 1, 1]])
    with segment.planned():
        a = segment._plan(idx, 4)
        with segment.planned():
            assert segment._plan(idx[:], 4) is a
        assert segment._plan(idx, 4) is a
        assert segment._plan(idx, 5) is not a
        assert segment._plan(idx[:, 1:], 4) is not a
        idx[0, 0] = 3
        b = segment._plan(idx, 4)
        assert b is not a
        assert torch.equal(b.perm, kernels.seg_plan(idx, 4).perm)
        assert len(segment._plans) == 4
    assert segment._plans is None
    assert segment._plan(idx, 4) is not segment._plan(idx, 4)


# ---------------------------------------------------------------------------
# the grid pattern against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid_mono():
    return gen.make_dataset(32, "mono", noise=0.005, seed=7, pattern="grid",
                            covis_radius=6.0, covis_max=6)[0]


@pytest.mark.parametrize("method", ["refine", "direct"])
def test_grid_mono_matches_reference(method, grid_mono):
    """Grid mono covis, 32 maps: the port's poses within 1e-8 of the JAX
    package's (both on the CPU, where each adds in list order; the grid
    amplifies one ulp of input to about 1e-2 to 1e-1 at 1,024 maps in
    either package, so the packages are held at a size where that stays
    far below the tolerance: 7.5e-13 refine, 3.6e-12 direct here)."""
    a = JaxTree("mono", method=method).run(
        [m.to_local_map() for m in grid_mono])
    b = types.to_numpy(DeviceTreeSolver("mono", method=method,
                                        device=CPU).run(grid_mono))
    np.testing.assert_array_equal(b.pose_ids, np.asarray(a.pose_ids))
    np.testing.assert_allclose(b.poses, np.asarray(jax.device_get(a.poses)),
                               atol=1e-8, rtol=0)
