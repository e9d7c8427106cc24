import json
import os
import shutil

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def tiny_root(tmp, maps=20, pool_maps=60):
    """A checkout-like directory holding BENCHMARK.json and a copy of the
    benchmark's folder whose configurations are cut to `maps` maps."""
    shutil.copytree(BENCH, os.path.join(tmp, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in os.listdir(os.path.join(tmp, "benchmark", "configs")):
        p = os.path.join(tmp, "benchmark", "configs", f)
        with open(p) as fh:
            c = json.load(fh)
        c["maps"] = maps
        with open(p, "w") as fh:
            json.dump(c, fh)
    for f in os.listdir(os.path.join(tmp, "benchmark", "traffic")):
        p = os.path.join(tmp, "benchmark", "traffic", f)
        with open(p) as fh:
            m = json.load(fh)
        m["pool_maps"] = pool_maps
        with open(p, "w") as fh:
            json.dump(m, fh)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    return tmp


@pytest.fixture
def tiny(tmp_path):
    import torch
    torch.set_num_threads(1)
    return tiny_root(str(tmp_path))


@pytest.fixture(autouse=True)
def _pool_in_process(monkeypatch):
    """The tests' pools are small: made in the test's own process."""
    from benchmark import run
    monkeypatch.setattr(run, "GEN_PROCS", 1)
