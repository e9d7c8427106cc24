"""The rest of a run, on the CPU at a small size, with the timed path
broken underneath: `correct` comes out false for each fault this system
can have, and for the control put in the program's place. (The cells run
on one card: no exchange between cards to leave out.)"""

import dataclasses
import functools

import pytest
import torch

from benchmark import run


def _solver(kind, workload):
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    if kind == "control":
        if workload.startswith("nc3500"):
            # the program's own float32 path (float32 information on every
            # level) for the configuration's float64 refine
            return functools.partial(DeviceTreeSolver, mixed_max_m=10**9)
        # no float32 path of its own: the reference in float32
        from benchmark import control
        return control.ReferenceF32

    class Broken(DeviceTreeSolver):
        first = None

        def run(self, maps, *a, **k):
            if kind == "half":
                # half of the maps left out of the solve
                return super().run(maps[:len(maps) // 2], *a, **k)
            out = super().run(maps, *a, **k)
            if kind == "stale":
                # the answer of the first solve returned again: a solve
                # that leaves its state unchanged
                Broken.first = Broken.first or out
                return Broken.first
            if kind == "altered":
                # one landmark coordinate altered where it is produced
                feats = out.feats.clone()
                feats[3, 1] += 0.05
                return dataclasses.replace(out, feats=feats)
            return out
    return Broken


@pytest.mark.parametrize("workload", ["nc3500_stereo.covis",
                                      "rs468_mono.covis"])
@pytest.mark.parametrize("kind", [None, "stale", "half", "altered",
                                  "control"])
def test_faults_make_the_run_incorrect(tiny, workload, kind):
    torch.set_num_threads(1)
    bench = run.Bench(tiny)
    factory = None if kind is None else _solver(kind, workload)
    res, lines = run.run_cell(bench, workload, 2**31 + 99, 1.0, False,
                              device="cpu", solver_factory=factory)
    assert res["attempted"] >= 2
    assert res["correct"] is (kind is None), (kind, lines)
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(bench.config(
        bench.cell(workload)["config"])["limits"])


def test_control_verdict_names_each_number_over_its_limit():
    from benchmark import control
    limits = dict(pose_gap=1e-6, info_gap=1e-5)
    assert control.verdict(dict(pose_gap=1e-9, info_gap=1e-9),
                           limits) == "passes"
    v = control.verdict(dict(pose_gap=3e-3, info_gap=1e-9), limits)
    assert v.startswith("fails") and "pose_gap" in v and "info_gap" not in v
    # a control that raised gives no number: it fails every limit
    v = control.verdict(dict(failed="FloatingPointError"), limits)
    assert "pose_gap None" in v and "info_gap None" in v
