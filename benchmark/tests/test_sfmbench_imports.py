"""Nothing the benchmark runs loads JAX or the JAX package, by whole
top-level name; a run without a card fails and prints no result."""

import os
import subprocess
import sys
import types

from benchmark import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_forbidden_modules_by_whole_name(monkeypatch):
    """Names that only begin like a forbidden one (the port's among them)
    are not flagged; a submodule is flagged by its top-level name."""
    fake = {name: types.ModuleType("x") for name in (
        "linearsfm_tpu_torch", "linearsfm_tpu_torchx", "jaxtyping",
        "flaxen.io")}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == []
    fake["jax.numpy"] = fake["linearsfm_tpu.ops"] = types.ModuleType("x")
    assert run.forbidden_modules() == ["jax", "linearsfm_tpu"]


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(1)\n"
        "from benchmark import run, gen, reference, compare, trace\n"
        "from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver\n"
        "maps, _, _ = gen.make_dataset(12, 'mono', noise=0.005, seed=3,\n"
        "                              covis_radius=6.0, covis_max=6)\n"
        "out = DeviceTreeSolver('mono', method='direct', device='cpu').run(maps)\n"
        "g = compare.gaps(compare.program_map(out),\n"
        "                 reference.solve_tree(maps, 'mono'))\n"
        "assert g['pose_gap'] < 1e-8, g\n"
        "print('FORBIDDEN', run.forbidden_modules())\n" % ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "FORBIDDEN []" in r.stdout


def test_no_card_no_result():
    """Where torch sees no CUDA card the run exits non-zero and prints
    nothing on stdout."""
    code = ("import sys, torch; torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['run.py', '--workload', 'rs468_mono.covis',\n"
            "            '--seed', '5', '--seconds', '1', '--trace', '0']\n"
            "sys.path.insert(0, %r)\n"
            "from benchmark import run\n"
            "sys.exit(run.main())\n" % ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
