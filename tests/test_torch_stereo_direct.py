"""Stereo on the direct path, the float64 Schur assembly and Cholesky of
every join (`core/join.join_stereo` -> `ops/schur.assemble_schur` ->
`ops/solve.solve_reduced`), against the benchmark's plain reference
(`benchmark/reference.py`, float64, whole-matrix form, no code shared with
the port) on the CPU, on sets of the benchmark's two mixes: `covis`
(loop-closure landmarks) and `chain` (none). Mono direct on chain sets
too, against the limits of `rs468_mono`, whose chain mix no cell runs yet.

Stereo is held to the tolerances the benchmark's own reference test holds
the port to (`benchmark/tests/test_sfmbench_reference.py`):
* pose and landmark coordinates within 1e-8: both sides solve the same
  float64 systems by a Cholesky factorisation, in other orders of
  summation; what is left is rounding, amplified by the root's
  conditioning (at most 7.1e-11 on these sets);
* information within 1e-9 of the reference's largest entry: information
  is transformed and summed, never solved, so only the congruences'
  rounding separates the two (at most 4.5e-12 here).
Mono chains amplify rounding more: with no loop closure the root carries
the scale drift of the whole odometry chain, and mono information is
transformed at the solved states. The reference against itself with its
joins solved one by one moves by up to 5.6e-9, and the JAX package lands
7.1e-8 (coordinates) and 7.1e-9 (information) from it on the 40-map chain
of seed 12; the port at most 3.8e-8 and 5.1e-9 on these sets. Mono chains
are held to 3e-7 and 3e-8, ten times the port's largest readings.
The cells' limits (`benchmark/configs/nc3500_stereo_direct.json`,
`rs468_mono.json`) must hold, and the reference computed in float32 must
fail them.
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
# (coordinates, information) by data type
TOL = {"stereo": (1e-8, 1e-9), "mono": (3e-7, 3e-8)}


def _json(*parts):
    with open(os.path.join(ROOT, "benchmark", *parts)) as fh:
        return json.load(fh)


def _set(datatype, mix, n, seed):
    """A set of the benchmark mix `mix` at n maps."""
    m = _json("traffic", f"{mix}.json")
    maps, _, _ = gen.make_dataset(
        n, datatype, feats_per_pose=m["feats_per_pose"], noise=m["noise"],
        seed=seed, pattern=m["pattern"], covis_radius=m["covis_radius"],
        covis_max=m["covis_max"])
    return maps


def _within(g, datatype):
    coord, info = TOL[datatype]
    return (g["id_mismatch"] == 0 and g["pose_gap"] < coord
            and g["feat_gap"] < coord and g["info_gap"] < info)


def _passes(g, limits):
    return all(g[k] <= v for k, v in limits.items())


CASES = {"stereo-covis-32": ("stereo", "covis", 32, 2**31 + 25),
         "stereo-covis-48": ("stereo", "covis", 48, 2**33 + 3),
         "stereo-chain-24": ("stereo", "chain", 24, 2**31 + 27),
         "stereo-chain-40": ("stereo", "chain", 40, 2**33 + 5),
         "mono-chain-32": ("mono", "chain", 32, 2**31 + 29),
         "mono-chain-44": ("mono", "chain", 44, 2**33 + 7)}
CONFIG = {"stereo": "nc3500_stereo_direct", "mono": "rs468_mono"}


@pytest.fixture(scope="module", params=sorted(CASES))
def solved(request):
    datatype, mix, n, seed = CASES[request.param]
    maps = _set(datatype, mix, n, seed)
    s = DeviceTreeSolver(datatype, method="direct", device="cpu")
    out = s.run(maps)
    return (s, maps, out, reference.solve_tree(maps, datatype),
            _json("configs", f"{CONFIG[datatype]}.json"))


def test_direct_matches_reference(solved):
    s, _, out, want, cfg = solved
    assert bool(compare.finite_flag(out))
    g = compare.gaps(compare.program_map(out), want)
    assert _within(g, cfg["datatype"]), g
    assert _passes(g, cfg["limits"]), g
    # every join formed its reduced system in float64, once
    assert s._last_timing["schur_f64_s"] > 0
    assert s._last_timing["pcg_sweeps"] == 0


def test_float32_reference_fails_the_limits(solved):
    _, maps, _, want, cfg = solved
    ctl = reference.solve_tree(maps, cfg["datatype"], dtype=np.float32)
    g = compare.gaps(ctl, want)
    assert not _within(g, cfg["datatype"]), g
    assert not _passes(g, cfg["limits"]), g


def test_the_configuration_is_the_direct_deployment():
    cfg = _json("configs", "nc3500_stereo_direct.json")
    assert (cfg["maps"], cfg["datatype"], cfg["executor"], cfg["method"],
            cfg["reduced"]) == (3499, "stereo", "device", "direct", [])
    assert set(cfg["limits"]) == {"id_mismatch", "pose_gap", "feat_gap",
                                  "info_gap"}
    assert cfg["limits"]["id_mismatch"] == 0
    # the chain mix is the covis mix without loop-closure landmarks
    covis, chain = _json("traffic", "covis.json"), _json("traffic",
                                                         "chain.json")
    assert (chain["covis_radius"], chain["covis_max"]) == (0, 0)
    for k in ("pattern", "feats_per_pose", "noise", "pool_maps"):
        assert chain[k] == covis[k], k
