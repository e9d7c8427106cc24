"""Per-lane gathers and segment sums over lane-stacked block lists.

The reference writes these per map and vmaps them (``x[idx]``,
``jax.ops.segment_sum``, ``.at[idx].set/add(mode="drop")``). Here every
operand carries a leading lane dimension P and the lane offset is folded into
the flat index, so one torch call serves a whole tree level.

Index semantics differ between the two frameworks, so they are fixed here
once: a segment index outside ``[0, num)`` is dropped (the reference's
``mode="drop"``; torch would raise or write out of bounds) by routing it to
an extra slot that is sliced off.

Order of the sums. XLA adds a segment's values in a fixed order, so the JAX
package gives the same bits on every run. ``index_add_`` adds them
sequentially, in list order, on the CPU, but through atomics on a GPU, whose
order changes from run to run: float results there differ by rounding from
run to run. Inside `deterministic()`, which the device and host executors
enter for every run, every floating-point sum of a CUDA tensor here
(`seg_sum`, `index_add`) runs kernel K3 instead (`kernels.seg_sum_fixed`):
each segment's values added in list order, with no atomics, bit-equal to the
CPU's ``index_add_``. K3 sums over an index list sorted once
(`kernels.seg_plan`); inside `planned()`, which every join enters, each
distinct list is sorted once and its plan serves every later sum over it
(the PCG's sweeps sum over the same four lists). Integer sums are exact in
any order and keep ``index_add_``; so does the CPU, whose ``index_add_`` is
already in order.
"""

from __future__ import annotations

import contextlib

import torch


# depth of the open `deterministic()` scopes
_fixed = 0
# K3's plans of the open `planned()` scope, by index list, or None
_plans: dict | None = None


@contextlib.contextmanager
def deterministic():
    """The fixed-order scope: inside it every floating-point `seg_sum` and
    `index_add` of a CUDA tensor runs K3, so two runs give the same bits.
    PyTorch's global deterministic mode is left as the caller set it, and
    so is CUBLAS_WORKSPACE_CONFIG: PyTorch reads it once per process, at
    its first cuBLAS call, and cuBLAS may choose other algorithms for
    another workspace, so a value set only inside the scope would give a
    process whose first product ran here other bits than one whose first
    product ran before (mono 2,048 on an H100, PERF.md §6). Products on
    one stream repeat with any fixed workspace. Scopes nest."""
    global _fixed
    _fixed += 1
    try:
        yield
    finally:
        _fixed -= 1


@contextlib.contextmanager
def planned():
    """Keep K3's plans while active (also a decorator): the first sum over
    an index list sorts it (`kernels.seg_plan`), and every later sum over
    the same list reuses that plan. A list is the same when its storage,
    offset, shape, strides, version counter and segment count are; the
    scope holds a reference to every list it planned, so a freed or
    rewritten tensor never meets a stale plan. Nested scopes share the
    outermost one's plans, which its exit drops."""
    global _plans
    if _plans is not None:
        yield
        return
    _plans = {}
    try:
        yield
    finally:
        _plans = None


def _plan(idx: torch.Tensor, num: int):
    """K3's plan of idx [P, K] into num segments: the open `planned()`
    scope's, else a new one."""
    from . import kernels
    if _plans is None or idx.is_inference():
        return kernels.seg_plan(idx, num)
    key = (idx.device, idx.dtype, idx.untyped_storage().data_ptr(),
           idx.storage_offset(), tuple(idx.shape), idx.stride(),
           idx._version, num)
    hit = _plans.get(key)
    if hit is None:
        # the list itself is kept so that its storage outlives the key
        hit = _plans[key] = (idx, kernels.seg_plan(idx, num))
    return hit[1]


def _k3(x: torch.Tensor) -> bool:
    """Whether a sum into x's dtype on x's device takes K3."""
    return _fixed > 0 and x.device.type == "cuda" and x.is_floating_point()


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
    [0, num) are dropped. In list order on the CPU and, inside
    `deterministic()`, through K3 on the card; else `index_add_`'s
    atomics there."""
    if _k3(vals):
        from . import kernels
        return kernels.seg_sum_fixed(vals.contiguous(), _plan(idx, num))
    P = idx.shape[0]
    tail = vals.shape[2:]
    idx = torch.where((idx >= 0) & (idx < num), idx, num)
    flat = (idx + lane_ids(P, idx.device) * (num + 1)).reshape(-1)
    out = vals.new_zeros((P * (num + 1),) + tail)
    out.index_add_(0, flat, vals.reshape((-1,) + tail))
    return out.view((P, num + 1) + tail)[:, :num]


def index_add(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
              alpha: int = 1) -> torch.Tensor:
    """out.index_add_(0, idx, vals, alpha=alpha), in place, for idx [K] in
    [0, out.shape[0]) and alpha 1 or -1; returns out. Inside
    `deterministic()` a contiguous CUDA float `out` takes K3's
    accumulate-into form (each row's entries added in list order)."""
    if _k3(out):
        from . import kernels
        kernels.seg_sum_fixed(vals.contiguous()[None],
                              _plan(idx.reshape(1, -1), out.shape[0]),
                              out=out[None], alpha=alpha)
        return out
    return out.index_add_(0, idx, vals, alpha=alpha)


def lane_where(mask: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """where(mask[p], a[p], b[p]) for a per-lane bool mask [P]."""
    return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)
