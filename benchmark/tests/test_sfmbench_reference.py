"""The plain reference against the port, both on the CPU, at 16-32 maps of
each data type; and the control (the reference in float32) against the
limits. Only this test touches the port; the reference does not."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import compare, gen, reference

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = {"stereo": ("nc3500_stereo", "refine"), "mono": ("rs468_mono",
                                                         "direct")}


def _limits(datatype):
    with open(os.path.join(HERE, "configs",
                           CELLS[datatype][0] + ".json")) as fh:
        return json.load(fh)["limits"]


def _set(datatype, n, seed):
    maps, _, _ = gen.make_dataset(n, datatype, noise=0.005, seed=seed,
                                  covis_radius=6.0, covis_max=6)
    return maps


def _program(datatype, maps):
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    torch.set_num_threads(1)
    out = DeviceTreeSolver(datatype, method=CELLS[datatype][1],
                           device="cpu").run(maps)
    return compare.program_map(out)


def _passes(g, limits):
    return all(g[k] <= v for k, v in limits.items())


@pytest.mark.parametrize("datatype,n,seed", [("stereo", 16, 3),
                                             ("stereo", 29, 2**31 + 1),
                                             ("mono", 17, 5),
                                             ("mono", 32, 2**31 + 9)])
def test_reference_matches_program(datatype, n, seed):
    maps = _set(datatype, n, seed)
    want = reference.solve_tree(maps, datatype)
    got = _program(datatype, maps)
    g = compare.gaps(got, want)
    assert g["id_mismatch"] == 0
    assert g["pose_gap"] < 1e-8 and g["feat_gap"] < 1e-8, g
    assert g["info_gap"] < 1e-9, g
    assert _passes(g, _limits(datatype)), g


@pytest.mark.parametrize("datatype", ["stereo", "mono"])
def test_control_fails_the_limits(datatype):
    """The reference in float32, put in the program's place, fails."""
    maps = _set(datatype, 32, 21)
    want = reference.solve_tree(maps, datatype)
    ctl = reference.solve_tree(maps, datatype, dtype=np.float32)
    g = compare.gaps(ctl, want)
    assert not _passes(g, _limits(datatype)), g


@pytest.mark.parametrize("datatype", ["stereo", "mono"])
def test_large_solve_path(datatype, monkeypatch):
    """Joins solved one by one (the path of the large top joins) give the
    batched path's answer."""
    maps = _set(datatype, 24, 8)
    batched = reference.solve_tree(maps, datatype)
    monkeypatch.setattr(reference, "BIG", 30)
    alone = reference.solve_tree(maps, datatype)
    g = compare.gaps(alone, batched)
    assert g["id_mismatch"] == 0 and g["pose_gap"] < 1e-10, g


def test_reference_imports_nothing_of_the_program():
    src = open(reference.__file__).read() + open(gen.__file__).read()
    assert "linearsfm" not in src.replace("linearsfm-tpu", "")
    assert "import jax" not in src
