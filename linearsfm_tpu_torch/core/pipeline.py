"""Top-level pipeline: load local maps, run the merge tree, save results.

Counterpart of `linearsfm_tpu/core/pipeline.py`, after runStereo/runMono of
the reference C++ solver (LinearSFMImp.cpp:97-112, :3136-3152).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

from .. import types
from ..io import localmap as lio
from ..ops import kernels
from .dense_tree import DenseTreeSolver
from .device_tree import DeviceTreeSolver
from .tree import TreeSolver

log = logging.getLogger("linearsfm_tpu_torch")


@contextlib.contextmanager
def deterministic():
    """`torch.use_deterministic_algorithms` for the enclosed work: on the
    GPU `index_add_` and `index_put_` then sum in a fixed order, so two
    runs give the same bits. An operation without a fixed-order version
    warns and runs as it is. cuBLAS wants a fixed workspace then
    (CUBLAS_WORKSPACE_CONFIG=:4096:8, set for the enclosed work unless the
    caller set it). The previous settings are restored."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if env is None:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def load_local_maps(path: str, num: int, datatype: str) -> list:
    """Load `localmap_1.txt` .. `localmap_<num>.txt` (lmj_loadLocalMaps*)
    as host-form maps."""
    return [lio.read_local_map(os.path.join(path, f"localmap_{i + 1}.txt"),
                               datatype) for i in range(num)]


def run(path: str, num: int, datatype: str,
        st_path: str | None = None, pose_path: str | None = None,
        feat_path: str | None = None, method: str = "direct",
        progress: bool = True, solver=None,
        ckpt_dir: str | None = None, resume: bool = False,
        trace_dir: str | None = None, metrics=None,
        executor: str = "host", *, device):
    """Full run on `device`; returns (final map in host form, solve wall
    in seconds).

    executor: "host" = the host-driven tree (`core/tree.TreeSolver`, per-level
    compaction on the host); "device" = the device-resident tree
    (`core/device_tree.DeviceTreeSolver`, the CLI's default); "dense" = the
    host-planned dense executor (`core/dense_tree.DenseTreeSolver`: dense
    block tensors per map, every id and slot planned on the host). The host
    and device executors take checkpoint/resume; with the dense executor
    `ckpt_dir` and `resume` are logged as ignored. `solver` replaces the
    executor's default solver. trace_dir: write a torch.profiler trace of
    the solve there (CPU activities, and CUDA on a GPU; Chrome-trace JSON).
    The pose, feature and state files are written as the reference does.
    Logged at INFO: the read time and the parser used, the solve wall, the
    solver's host phases, the solve's kernel launches, its peak device
    memory (on a GPU) and the write time. The direct mono solve sums in a
    fixed order (`deterministic`).
    """
    device = torch.device(device)
    if solver is None:
        if executor == "device":
            solver = DeviceTreeSolver(datatype, method=method,
                                      progress=progress, device=device)
        elif executor == "host":
            solver = TreeSolver(datatype, method=method, progress=progress,
                                device=device)
        elif executor == "dense":
            solver = DenseTreeSolver(datatype, method=method,
                                     progress=progress, device=device)
        else:
            raise ValueError(f"unknown executor {executor!r}")
    t0 = time.perf_counter()
    maps = load_local_maps(path, num, datatype)
    t_read = time.perf_counter() - t0
    log.info("Read %d local maps in %.3f s (%s parser)", num, t_read,
             lio.parser_name())
    launched = dict(kernels.launches)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    kw = dict(metrics=metrics)
    if isinstance(solver, (TreeSolver, DeviceTreeSolver)):
        kw.update(ckpt_dir=ckpt_dir, resume=resume)
    elif ckpt_dir or resume:
        log.warning("checkpoint/resume requires the host or device executor; "
                    "ignoring")
    # on an H100 the direct mono solve's atomic sums moved its poses by up
    # to 7.4e-6 from run to run, and summing in a fixed order cost it no
    # measurable wall; stereo moved 2e-13 and would pay 11-17% (PERF.md §6)
    fixed_order = method == "direct" and datatype == "mono"
    with deterministic() if fixed_order else contextlib.nullcontext():
        if trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                final = solver.run(maps, **kw)
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        else:
            final = solver.run(maps, **kw)
    final = types.host_fields(final)   # one copy of the root to the host
    wall = time.perf_counter() - t0
    log.info("Total Used Time:  %f  sec", wall)
    log.info("Solver host phases: %s", getattr(solver, "_last_timing", {}))
    log.info("Kernel launches: %s",
             {k: n - launched[k] for k, n in kernels.launches.items()})
    if device.type == "cuda":
        log.info("Peak device memory: %.2f GiB",
                 torch.cuda.max_memory_allocated(device) / 2**30)

    t0 = time.perf_counter()
    ids, poses = final.pose_ids, final.poses
    fids, feats = final.feat_ids, final.feats
    pv, fv = ids >= 0, fids >= 0
    if st_path:
        lio.write_state(st_path, ids[pv], poses[pv], fids[fv], feats[fv])
    if pose_path:
        lio.write_poses(pose_path, ids[pv], poses[pv])
    if feat_path:
        lio.write_features(feat_path, fids[fv], feats[fv])
    log.info("Wrote the results in %.3f s", time.perf_counter() - t0)
    return final, wall
