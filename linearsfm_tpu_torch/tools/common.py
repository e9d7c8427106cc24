"""What the port's profiling tools share: the device rule and the clock.

A tool runs on the card unless `--cpu` asks for the CPU. Without CUDA and
without `--cpu` it exits 1; it never moves to the CPU on its own. On the
card it first prints the card's name and power limit (the line of
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`) and turns
TF32 off, as the solvers require.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch


def open_device(cpu: bool, tool: str, file=None) -> str | None:
    """"cpu" with `cpu`, else "cuda" after the card's line is printed (to
    `file`, default stdout); None (with the reason on stderr) when there is
    no CUDA device: the caller returns 1."""
    if cpu:
        return "cpu"
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device (pass --cpu)", file=sys.stderr)
        return None
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(),
          file=file or sys.stdout, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def best_ms(fn, device):
    """(least wall of 3 calls of `fn` in ms, the last call's result): one
    warm call first; each call is timed from a synchronised device to
    the device's end of its work. On the CPU every operation is
    synchronous, so the host clock is the device's."""
    fn()
    sync(device)
    walls, out = [], None
    for _ in range(3):
        out = None          # no result outlives its call into the next
        t = time.perf_counter()
        out = fn()
        sync(device)
        walls.append(time.perf_counter() - t)
    return min(walls) * 1e3, out


def pose_digest(lm) -> str:
    """SHA-256 of a solved map's pose ids and poses (host form, as
    `types.host_fields` gives them): equal digests, equal bits."""
    import hashlib
    import numpy as np
    from linearsfm_tpu_torch import types
    h = types.host_fields(lm)
    return hashlib.sha256(
        np.ascontiguousarray(h.pose_ids).tobytes()
        + np.ascontiguousarray(h.poses).tobytes()).hexdigest()
