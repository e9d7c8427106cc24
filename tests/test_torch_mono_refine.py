"""Mono on the refine path, the float32-preconditioned float64 PCG with
the mono scale pin (`core/join.join_mono` -> `ops/schur.solve_full_mixed`
with `fixc` and `sign`), against the benchmark's plain reference
(`benchmark/reference.py`, float64, whole-matrix form, no code shared with
the port) on the CPU. The top band (early exit, escalation test) runs from
8 joined poses, so the small sets reach it.

The tolerances are those the benchmark's own reference test holds the
port to (`benchmark/tests/test_sfmbench_reference.py`):
* pose and landmark coordinates within 1e-8: both sides solve the same
  float64 systems, the port by a PCG that stops at a relative residual of
  1e-14 (`pcg_exit_tol`), the reference by Cholesky; what is left is
  rounding, amplified by a mono root's conditioning (at most 4e-10 on
  these sets);
* information within 1e-9 of the reference's largest entry: information
  is transformed and summed, never solved, so only the congruences'
  rounding separates the two (at most 1e-10 here).
The reference computed in float32 must fail them.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import compare, gen, reference
from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver

# one intra-op thread: the suite's workers share the machine's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_TOL, INFO_TOL = 1e-8, 1e-9
TOP_MIN_M = 8


def _limits():
    with open(os.path.join(ROOT, "benchmark/configs/mono3499_refine.json")) \
            as fh:
        return json.load(fh)["limits"]


def _set(n, seed):
    """A set of the benchmark's mono cell's mix (`covis`) at n maps."""
    maps, _, _ = gen.make_dataset(n, "mono", noise=0.005, seed=seed,
                                  covis_radius=6.0, covis_max=6)
    return maps


def _within(g):
    return (g["id_mismatch"] == 0 and g["pose_gap"] < POSE_TOL
            and g["feat_gap"] < POSE_TOL and g["info_gap"] < INFO_TOL)


def _passes(g, limits):
    return all(g[k] <= v for k, v in limits.items())


@pytest.fixture(scope="module", params=[(32, 2**31 + 5), (64, 2**31 + 13)],
                ids=["32", "64"])
def solved(request):
    n, seed = request.param
    maps = _set(n, seed)
    s = DeviceTreeSolver("mono", method="refine", top_min_m=TOP_MIN_M,
                         device="cpu")
    out = s.run(maps)
    return s, maps, out, reference.solve_tree(maps, "mono")


def test_mono_refine_matches_reference(solved):
    s, _, out, want = solved
    assert bool(compare.finite_flag(out))
    g = compare.gaps(compare.program_map(out), want)
    assert _within(g), g
    assert _passes(g, _limits()), g


def test_mono_refine_runs_the_top_band(solved):
    """The top band ran: each of its joins read its exit flag before every
    sweep and once after the last, then the escalation flag, and ran
    top_iters sweeps more on an escalation; the joins below it ran
    refine_iters sweeps each with no read."""
    s, maps, _, _ = solved
    tp, _ = s.prepare(maps)
    top = [lp.join_m >= TOP_MIN_M for lp in tp.levels]
    assert sum(top) >= 2 and not all(top)
    spans = s.last_spans
    joins = [i for i, sp in enumerate(spans) if sp["name"] == "join"]
    assert len(joins) == len(tp.levels)
    want = 0
    for i, is_top in zip(joins, top):
        a = spans[i]["attrs"]
        reads = sum(sp["name"] == "sync" and sp["parent"] == i
                    for sp in spans)
        if is_top:
            assert reads >= 3
            esc = a.get("pcg_escalations", 0)
            assert a["pcg_sweeps"] == reads - 2 + esc * s.top_iters
        else:
            assert reads == 0 and a == {"pcg_sweeps": s.refine_iters}
        want += a["pcg_sweeps"]
    # the sum is no bound on the band: a top-band join that meets the exit
    # test after one or two sweeps runs fewer than refine_iters
    assert s._last_timing["pcg_sweeps"] == want
    # every top-band lane's residual is finite and under the escalation
    # tolerance
    for lv, is_top in enumerate(top, start=1):
        if is_top:
            r = s.last_residuals[lv]
            assert np.all(np.isfinite(r)) and np.all(r <= s.escalate_tol)


def test_float32_reference_fails_the_tolerances(solved):
    _, maps, _, want = solved
    ctl = reference.solve_tree(maps, "mono", dtype=np.float32)
    g = compare.gaps(ctl, want)
    assert not _within(g), g
    assert not _passes(g, _limits()), g
