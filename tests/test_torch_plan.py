"""The port's exact tree planner (`core/plan`: `sym_of_stacked` and
`plan_tree_exact`, each tree level one batch of array set arithmetic)
against the JAX package's planner, which replays the tree node by node in
Python sets, on the same compacted maps: every field of every level plan,
the root's re-gauge and the root's capacities equal. Also: subtrees as the
multi-host solvers plan them and their common root capacities, ids far
apart and out of order, and the refusal of keys past 63 bits."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmark import gen as bgen
from synth import generate as gen
from linearsfm_tpu.core import plan as jplan
from linearsfm_tpu.parallel import multihost as jmultihost
from linearsfm_tpu_torch.core import compact as tcompact
from linearsfm_tpu_torch.core import plan as tplan
from linearsfm_tpu_torch.parallel import multihost

# one intra-op thread: the suite's workers share the machine's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = {"loop_covis": dict(pattern="loop", covis_radius=6.0, covis_max=6),
          "loop": dict(pattern="loop"),
          "grid": dict(pattern="grid")}


def _stack(n: int, datatype: str, world: str = "loop_covis", seed: int = 0):
    maps, _, _ = gen.make_dataset(n, datatype, noise=0.01, seed=seed,
                                  **WORLDS[world])
    return tcompact.compact_stack(maps, 16, 64)


def _same(st, datatype: str, **kw):
    """The port's plan of a stack, held to the JAX package's."""
    got = tplan.plan_tree_exact(tplan.sym_of_stacked(st), datatype, 16, 64,
                                **kw)
    want = jplan.plan_tree_exact(jplan.sym_of_stacked(st), datatype, 16, 64,
                                 **kw)
    assert len(got.levels) == len(want.levels)
    for g, w in zip(got.levels, want.levels):
        assert dataclasses.astuple(g) == dataclasses.astuple(w)
    assert got.root_regauge == want.root_regauge
    assert got.root_caps == want.root_caps
    return got


@pytest.mark.parametrize("n", [1, 2, 3, 5, 13, 33, 88])
@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("datatype", ["stereo", "mono"])
def test_plan_matches_reference(datatype, world, n):
    tp = _same(_stack(n, datatype, world, seed=n), datatype)
    assert len(tp.levels) == (n - 1).bit_length()


def test_plan_matches_reference_on_a_benchmark_set():
    """A set of the RS468 mono deployment (466 maps), as the benchmark's
    generator draws it for the `covis` mix."""
    with open(os.path.join(ROOT, "benchmark/configs/rs468_mono.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "benchmark/traffic/covis.json")) as f:
        mix = json.load(f)
    maps = bgen.make_set(cfg, mix, 2**31 + 19, 0)
    assert len(maps) == 466
    tp = _same(tcompact.compact_stack(maps, 16, 64), "mono")
    assert any(any(lp.regauge) for lp in tp.levels)


@pytest.mark.parametrize("datatype", ["stereo", "mono"])
def test_subtree_plans_match_reference(datatype):
    """Each host's blocks as `parallel/multihost` solves them: planned at
    their global offset, without the whole tree's root re-gauge."""
    maps, _, _ = gen.make_dataset(37, datatype, noise=0.01, seed=4,
                                  covis_radius=6.0, covis_max=6)
    _, block, owners = multihost.plan_chunks(len(maps), 4)
    spans = multihost._block_spans(len(maps), block, 0, owners[-1][1])
    assert len(spans) == 5 and spans[-1] == (32, 37)
    for lo, hi in spans:
        st = tcompact.compact_stack(maps[lo:hi], 16, 64)
        _same(st, datatype, map_offset=lo, final_regauge=False)


@pytest.mark.parametrize("n_hosts,heavy_tail",
                         [(2, False), (4, False), (5, False), (2, True)])
@pytest.mark.parametrize("datatype", ["stereo", "mono"])
def test_common_root_caps_match_reference(datatype, n_hosts, heavy_tail):
    """The capacities every host pads its block roots to (each block
    planned at its offset, the idle-carry re-gauge included, a partial
    tail block among them) equal the JAX package's. heavy_tail: 14 maps
    on 2 hosts, blocks of 4 and a tail of 2 maps whose root idles through
    a level at an odd position, so it re-gauges; its maps observe 32
    landmarks a pose (the others 1), so that root sets the largest
    capacities."""
    if heavy_tail:
        small, _, _ = gen.make_dataset(14, datatype, feats_per_pose=1,
                                       noise=0.01, seed=5)
        big, _, _ = gen.make_dataset(14, datatype, feats_per_pose=32,
                                     noise=0.01, seed=5)
        maps = small[:12] + big[12:]
        L, block, owners = multihost.plan_chunks(len(maps), n_hosts)
        assert multihost._block_spans(len(maps), block, 0,
                                      owners[-1][1])[-1] == (12, 14)
        assert multihost._carry_regauge_positions(12, 1, L) == [3]
    else:
        maps, _, _ = gen.make_dataset(37, datatype, noise=0.01, seed=5,
                                      covis_radius=6.0, covis_max=6)
    lms = [m.to_local_map() for m in maps]
    assert (multihost.common_root_caps(maps, datatype, n_hosts)
            == jmultihost.common_root_caps(lms, datatype, n_hosts))


def _relabel(ids: np.ndarray, new: dict) -> np.ndarray:
    return np.array([new.get(int(x), -1) for x in ids.ravel()],
                    np.int64).reshape(ids.shape)


@pytest.mark.parametrize("datatype", ["stereo", "mono"])
def test_plan_matches_reference_on_sparse_shuffled_ids(datatype):
    """Pose and feature ids moved above 3 * 2^30, thousands apart, in a
    shuffled order (so the re-gauge tests `ref > fref` answer otherwise):
    the ranks must keep every comparison the ids make."""
    st = _stack(33, datatype)
    rng = np.random.default_rng(11)
    g = st.gauge
    pose_fields = dict(ref=g.ref, scap=g.scap, fref=g.fref, fscap=g.fscap)
    moved = {}
    for name, arrays in (("pose", [st.pose_ids, *pose_fields.values()]),
                         ("feat", [st.feat_ids])):
        old = np.unique(np.concatenate([np.ravel(a) for a in arrays]))
        old = old[old >= 0]
        gaps = rng.integers(1, 9973, len(old))
        moved[name] = dict(zip(old.tolist(),
                               (3 * 2**30 + np.cumsum(gaps))[
                                   rng.permutation(len(old))].tolist()))
    st = dataclasses.replace(
        st, pose_ids=_relabel(st.pose_ids, moved["pose"]),
        feat_ids=_relabel(st.feat_ids, moved["feat"]),
        gauge=dataclasses.replace(g, **{
            k: _relabel(v, moved["pose"]) for k, v in pose_fields.items()}))
    assert st.pose_ids.max() > 3 * 2**30
    _same(st, datatype)


@pytest.mark.parametrize("datatype", ["stereo", "mono"])
def test_keys_past_63_bits_are_refused(datatype, monkeypatch):
    """With the key budget cut one bit below what a 33-map stack needs,
    `sym_of_stacked` raises, naming the limit; at the budget the stack
    needs, it plans as the reference does."""
    st = _stack(33, datatype)
    lv = tplan.sym_of_stacked(st)
    need = lv.nb + max(2 * lv.pb, lv.pb + lv.fb) + 1
    monkeypatch.setattr(tplan, "_KEY_BITS", need - 1)
    with pytest.raises(ValueError, match=f"past {need - 1} bits"):
        tplan.sym_of_stacked(st)
    monkeypatch.setattr(tplan, "_KEY_BITS", need)
    _same(st, datatype)
