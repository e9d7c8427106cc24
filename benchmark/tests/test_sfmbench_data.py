"""The harness is driven by data: a configuration, a traffic mix and a
per-layer metric that a later change adds as files of their own are found
by their names in BENCHMARK.json."""

import json
import os

from benchmark import run

EXTRA_CONFIG = {
    "name": "tiny_stereo", "source": "a test", "maps": 12,
    "datatype": "stereo", "executor": "device", "method": "refine",
    "reduced": [], "assumed": {},
    "limits": {"id_mismatch": 0, "pose_gap": 1e-6, "feat_gap": 1e-6,
               "info_gap": 1e-6}}
EXTRA_MIX = {"name": "chain", "why": "no co-visibility", "pattern": "loop",
             "feats_per_pose": 4, "noise": 0.005, "covis_radius": 0.0,
             "covis_max": 0, "pool_maps": 30}
EXTRA_METRIC = '''
def read(run):
    return float(len(run.solves))
'''


def test_extra_config_mix_and_metric_found_by_name(tiny):
    b = os.path.join(tiny, "benchmark")
    with open(os.path.join(b, "configs", "tiny_stereo.json"), "w") as fh:
        json.dump(EXTRA_CONFIG, fh)
    with open(os.path.join(b, "traffic", "chain.json"), "w") as fh:
        json.dump(EXTRA_MIX, fh)
    with open(os.path.join(b, "metrics", "solves_per_window.py"), "w") as fh:
        fh.write(EXTRA_METRIC)
    p = os.path.join(tiny, "BENCHMARK.json")
    with open(p) as fh:
        spec = json.load(fh)
    spec["workloads"].append({"name": "tiny_stereo.chain",
                              "config": "tiny_stereo", "traffic": "chain",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "solves_per_window", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "window", "moves": "maps_joined_per_s",
                              "workloads": ["tiny_stereo.chain"]})
    with open(p, "w") as fh:
        json.dump(spec, fh)
    bench = run.Bench(tiny)
    assert bench.config("tiny_stereo")["maps"] == 12
    assert bench.mix("chain")["covis_max"] == 0
    names = [m["name"] for m in bench.metrics("tiny_stereo.chain", True)]
    assert "solves_per_window" in names
    assert "solves_per_window" not in [
        m["name"] for m in bench.metrics("rs468_mono.covis", True)]
    res, lines = run.run_cell(bench, "tiny_stereo.chain", 77, 0.5, False,
                              device="cpu")
    assert res["correct"], lines
    assert set(res["metrics"]) == {"maps_joined_per_s", "setup_s"}
    r = run.Run(bench.cell("tiny_stereo.chain"), {}, {}, [{}] * 3, [])
    assert bench.reader("solves_per_window")(r) == 3.0
