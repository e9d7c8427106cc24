"""Top-level pipeline: load local maps, run the merge tree, save results.

Counterpart of `linearsfm_tpu/core/pipeline.py`, after runStereo/runMono of
the reference C++ solver (LinearSFMImp.cpp:97-112, :3136-3152).
"""

from __future__ import annotations

import logging
import os
import time

import torch

from .. import types
from ..io import localmap as lio
from ..ops import kernels
from .device_tree import DeviceTreeSolver
from .tree import TreeSolver

log = logging.getLogger("linearsfm_tpu_torch")


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
    (`core/device_tree.DeviceTreeSolver`, the CLI's default). Both take
    checkpoint/resume. "dense" (the JAX package's experimental dense
    executor) is not ported. `solver` replaces the executor's default
    solver. trace_dir: write a torch.profiler trace of the solve there
    (CPU activities, and CUDA on a GPU; Chrome-trace JSON). The pose,
    feature and state files are written as the reference does. Logged at
    INFO: the read time and the parser used, the solve wall, the solver's
    host phases, the solve's kernel launches, its peak device memory (on a
    GPU) and the write time.
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
            raise NotImplementedError(
                "executor 'dense' is not ported (ROADMAP queue 1 item 16)")
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
    kw = dict(metrics=metrics, ckpt_dir=ckpt_dir, resume=resume)
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
