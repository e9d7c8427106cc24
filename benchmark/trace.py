"""The traced run's reading of the device: one torch.profiler session per
traced solve, the benchmark's own spans around the calls into the
program's layers, the shapes of every K1 and K3 launch, and the reduction
of the session's Chrome trace to device time, busy time, idle gaps and
roofline bytes.

Nothing here changes what the program computes: the wrappers call the
program's own functions and only record, and only inside a traced solve.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import re
import tempfile

import torch

from . import roofline

K1_NAME = "blockcoo"      # K1's kernel: blockcoo_dense_kernel
K3_NAME = "seg_sum_"      # K3's kernels: seg_sum_direct, seg_sum_ring
SPANS = ("ingest_plan", "upload", "levels", "final")
_ISSUED = re.compile(r"Launch|Memset|Memcpy")


class LostRecords(AssertionError):
    """The profiler dropped device records of launches, fills or copies
    that the host issued: totals summed from such a trace read short."""


def record_counts(events, start=None):
    """(issued, recorded) among a Chrome trace's events: the kernel
    launches, fills and copies the host issued (`cuda_runtime` /
    `cuda_driver` events named Launch|Memset|Memcpy, at host time >= start
    if given), and how many of them have a device record (a kernel, fill or
    copy with the same correlation id). A frozen copy of the port's
    `tools/profile_k1.record_counts`, on loaded events."""
    dev = {e.get("args", {}).get("correlation") for e in events
           if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")}
    issued = recorded = 0
    for e in events:
        if (e.get("cat") in ("cuda_runtime", "cuda_driver")
                and _ISSUED.search(e.get("name", ""))
                and (start is None or e["ts"] >= start)):
            issued += 1
            recorded += e.get("args", {}).get("correlation") in dev
    return issued, recorded


def require_records(events, what, start=None):
    """Raises LostRecords, naming both counts, unless every launch, fill
    and copy (`record_counts`) has its device record."""
    issued, recorded = record_counts(events, start)
    if recorded != issued:
        raise LostRecords(f"{what}: the profiler lost device records: "
                          f"{issued} kernel launches, fills and copies "
                          f"issued, {recorded} with a device record")


def _union(iv):
    """[(start, end)] merged, sorted."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Recorder:
    """Wraps the program's K1 and K3 launchers and its layer calls while
    `active()` is entered: each K1 and K3 launch's operands are kept (the
    bytes are counted after the window, off the traced time), and each
    layer call runs inside a profiler range named by SPANS."""

    def __init__(self, solver):
        from linearsfm_tpu_torch.core import compact
        from linearsfm_tpu_torch.ops import kernels, schur
        from linearsfm_tpu_torch import types
        self.solver, self.kernels = solver, kernels
        self.k1, self.k3 = [], []
        self._targets = [
            (kernels, "blockcoo_to_dense_planned", self._k1),
            (schur, "densify_planned", self._k1),
            (kernels, "seg_sum_fixed", self._k3),
            (compact, "compact_stack", self._span("ingest_plan")),
            (types, "to_torch", self._span("upload")),
            (solver, "_plan", self._span("ingest_plan")),
            (solver, "_level", self._span("levels")),
            (solver, "_final", self._span("final")),
        ]

    def _span(self, name):
        def wrap(fn):
            @functools.wraps(fn)
            def inner(*a, **k):
                with torch.profiler.record_function(name):
                    return fn(*a, **k)
            return inner
        return wrap

    def _k1(self, fn):
        kernels = self.kernels

        @functools.wraps(fn)
        def inner(plan, vals, col_lo=0, width=None):
            n0 = kernels.launches["blockcoo_to_dense"]
            out = fn(plan, vals, col_lo, width)
            if kernels.launches["blockcoo_to_dense"] > n0:
                w = plan.N - col_lo if width is None else width
                self.k1.append((plan, vals.shape[-2], vals.shape[-1], col_lo,
                                w, vals.element_size()))
            return out
        return inner

    def _k3(self, fn):
        kernels = self.kernels

        @functools.wraps(fn)
        def inner(vals, plan, out=None, alpha=1):
            n0 = kernels.launches["seg_sum_fixed"]
            res = fn(vals, plan, out, alpha)
            if kernels.launches["seg_sum_fixed"] > n0:
                self.k3.append((plan, math.prod(vals.shape[2:]),
                                vals.element_size(), out is not None))
            return res
        return inner

    @contextlib.contextmanager
    def active(self):
        saved = [(obj, name, getattr(obj, name))
                 for obj, name, _ in self._targets]
        try:
            for (obj, name, wrap), (_, _, fn) in zip(self._targets, saved):
                setattr(obj, name, wrap(fn))
            yield
        finally:
            for obj, name, fn in saved:
                if obj is self.solver:
                    delattr(obj, name)   # back to the class's method
                else:
                    setattr(obj, name, fn)

    def take_bytes(self):
        """(K1 bytes per launch, K3 bytes per launch) of the launches kept
        so far, which are then dropped."""
        k1 = []
        for plan, R, C, lo, w, esz in self.k1:
            n = int(plan.row_ptr[-1])
            sc = plan.scol[:n]
            kept = int(((sc >= lo) & (sc < lo + w)).sum())
            rows = plan.row_ptr.numel() - 1
            k1.append(roofline.k1_bytes(kept, rows, R, C, w, esz))
        k3 = []
        for plan, T, esz, into in self.k3:
            base = torch.arange(plan.P, device=plan.off.device) * (
                plan.num + 1)
            kept = int((plan.off[base + plan.num] - plan.off[base]).sum())
            k3.append(roofline.k3_bytes(kept, plan.P, plan.num, T, esz, into))
        self.k1, self.k3 = [], []
        return k1, k3


def profile_solve(recorder, solve):
    """Run `solve()` (one solve and its synchronise) inside one profiler
    session and the recorder; returns (the solve's result, the session's
    events, the host time at which the solve's range starts)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with recorder.active(), profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as p:
        # late in a long process the profiler has been seen to drop the
        # device records of a session's first launches: these fills take
        # them, outside the counted range
        x = torch.empty(64, device="cuda")
        for _ in range(64):
            x.fill_(0.0)
        torch.cuda.synchronize()
        with record_function("solve"):
            result = solve()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        p.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    solve_ev = [e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == "solve"]
    return result, events, solve_ev[0]["ts"] if solve_ev else None


def reduce_session(events, start):
    """One traced solve's readings: wall and busy seconds, device seconds
    by kernel name, the K1 and K3 device seconds, and the idle gaps named
    by the innermost benchmark span (or "solve") holding their middle."""
    solve = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == "solve"][0]
    t0, t1 = solve["ts"], solve["ts"] + solve["dur"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")
           and t0 <= e["ts"] < t1]
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
    busy = _union((e["ts"], min(e["ts"] + e["dur"], t1)) for e in dev)
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") in SPANS)
    gaps, prev = [], t0
    for a, b in busy + [[t1, t1]]:
        if a > prev:
            mid = 0.5 * (a + prev)
            name = "solve"
            for s0, s1, nm in spans:
                if s0 <= mid <= s1:
                    name = nm
            gaps.append((name, (a - prev) * 1e-6))
        prev = max(prev, b)
    return dict(wall_s=(t1 - t0) * 1e-6,
                busy_s=sum(b - a for a, b in busy) * 1e-6,
                kernels=by_name,
                k1_s=sum(v for k, v in by_name.items() if K1_NAME in k),
                k3_s=sum(v for k, v in by_name.items() if K3_NAME in k),
                k1_launches=sum(1 for e in dev if K1_NAME in e["name"]),
                gaps=gaps)
