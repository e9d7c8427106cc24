"""Per-lane gathers and segment sums over lane-stacked block lists.

The reference writes these per map and vmaps them (``x[idx]``,
``jax.ops.segment_sum``, ``.at[idx].set/add(mode="drop")``). Here every
operand carries a leading lane dimension P and the lane offset is folded into
the flat index, so one torch call serves a whole tree level.

Index semantics differ between the two frameworks, so they are fixed here
once: a segment index outside ``[0, num)`` is dropped (the reference's
``mode="drop"``; torch would raise or write out of bounds) by routing it to
an extra slot that is sliced off. ``index_add_`` sums duplicates sequentially
on the CPU and through atomics on a GPU, whose order changes from run to run:
results there differ from run to run by float64 rounding only, unless the
work runs under `deterministic()`.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def deterministic():
    """`torch.use_deterministic_algorithms` for the enclosed work: on the
    GPU `index_add_` and `index_put_` then sum in a fixed order, so two
    runs give the same bits. An operation without a fixed-order version
    warns and runs as it is. cuBLAS wants a fixed workspace then
    (CUBLAS_WORKSPACE_CONFIG=:4096:8, set for the enclosed work unless the
    caller set it). The previous settings are restored, so scopes nest."""
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


def lane_ids(P: int, device) -> torch.Tensor:
    """[P, 1] lane index, for advanced indexing of lane-stacked tensors."""
    return torch.arange(P, device=device)[:, None]


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[p, k] = x[p, idx[p, k]]: x [P, M, ...], idx [P, K] -> [P, K, ...]."""
    return x[lane_ids(x.shape[0], x.device), idx]


def take1(x: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """out[p] = x[p, slot[p]]: x [P, M, ...], slot [P] -> [P, ...]."""
    return x[torch.arange(x.shape[0], device=x.device), slot]


def put1(x: torch.Tensor, slot: torch.Tensor, val) -> torch.Tensor:
    """Copy of x with x[p, slot[p]] = val[p] (or a scalar)."""
    out = x.clone()
    out[torch.arange(x.shape[0], device=x.device), slot] = val
    return out


def seg_sum(vals: torch.Tensor, idx: torch.Tensor, num: int) -> torch.Tensor:
    """out[p, s] = sum over k with idx[p, k] == s of vals[p, k].

    vals [P, K, ...], idx [P, K] -> [P, num, ...]; indices outside
    [0, num) are dropped."""
    P = idx.shape[0]
    tail = vals.shape[2:]
    idx = torch.where((idx >= 0) & (idx < num), idx, num)
    flat = (idx + lane_ids(P, idx.device) * (num + 1)).reshape(-1)
    out = vals.new_zeros((P * (num + 1),) + tail)
    out.index_add_(0, flat, vals.reshape((-1,) + tail))
    return out.view((P, num + 1) + tail)[:, :num]


def lane_where(mask: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """where(mask[p], a[p], b[p]) for a per-lane bool mask [P]."""
    return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)
