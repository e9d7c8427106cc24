"""Structured per-level metrics, and the spans and counts of a solve.

Counterpart of `linearsfm_tpu/utils/metrics.py` (`LevelMetrics`).

The reference prints one wall-clock line (LinearSFMImp.cpp:2068-2072); here
every tree level logs joins, shapes, solve residual proxy, and throughput, and
the collected record is JSON-serializable for observability pipelines.

Spans and counts (the port's own). `recording()` opens a solve's recorder
(`DeviceTreeSolver.run` opens one per solve); until it closes, `span(name,
**attrs)` records a span — its name, start and end on
`time.perf_counter_ns()`, the index of the span it opened in (None: the
solve itself), the solve's id and its attributes — and `count(name, n)`
adds to a counter of the solve and to the attributes of the innermost open
span. Outside a recorder both are a shared no-op. While a torch.profiler
session records, each span also opens `torch.profiler.record_function`
under its name, so the spans lie in the session's Chrome trace on the
device records' clock; with no session recording none is opened.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import time

import torch

log = logging.getLogger("linearsfm_tpu_torch")

# the open solve recorder, or None: spans and counts are then no-ops
_rec: SolveSpans | None = None
_solve_ids = itertools.count(1)
_OFF = contextlib.nullcontext()


class SolveSpans:
    """One solve's spans, in the order they opened (each a dict: name,
    start, end [ns], parent [index or None], solve, attrs), and its
    counts by name."""

    def __init__(self):
        self.solve = next(_solve_ids)
        self.spans: list[dict] = []
        self.counts: dict[str, int] = {}
        # indices of the open spans, innermost last
        self._open: list[int] = []


class _Span:
    """One span of a recorder, as `span` returns it."""

    __slots__ = ("rec", "record", "rf")

    def __init__(self, rec: SolveSpans, name: str, attrs: dict):
        self.rec = rec
        self.record = dict(name=name, start=0, end=0, parent=None,
                           solve=rec.solve, attrs=attrs)
        self.rf = None

    def __enter__(self) -> dict:
        rec, r = self.rec, self.record
        r["start"] = time.perf_counter_ns()
        if rec._open:
            r["parent"] = rec._open[-1]
        rec._open.append(len(rec.spans))
        rec.spans.append(r)
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(r["name"])
            self.rf.__enter__()
        return r

    def __exit__(self, *exc) -> None:
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec._open.pop()
        self.record["end"] = time.perf_counter_ns()


def span(name: str, **attrs):
    """A context manager recording one span of the open solve (its record
    dict as the `with` target), or a no-op (target None) outside one."""
    rec = _rec
    if rec is None:
        return _OFF
    return _Span(rec, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add n to the open solve's counter `name` and to the same attribute
    of its innermost open span; a no-op outside a solve."""
    rec = _rec
    if rec is None:
        return
    rec.counts[name] = rec.counts.get(name, 0) + n
    if rec._open:
        attrs = rec.spans[rec._open[-1]]["attrs"]
        attrs[name] = attrs.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Open a solve's recorder (the `with` target) until exit; a recorder
    opened inside another records alone, and the outer one resumes."""
    global _rec
    prev, _rec = _rec, SolveSpans()
    try:
        yield _rec
    finally:
        _rec = prev


def subtree(spans: list[dict], root: int) -> list[int]:
    """Indices of the spans opened inside span `root`, at any depth."""
    inside = {root}
    for i in range(root + 1, len(spans)):
        if spans[i]["parent"] in inside:
            inside.add(i)
    inside.discard(root)
    return sorted(inside)


def self_seconds(spans: list[dict], which=None) -> dict[str, float]:
    """Self time by span name, seconds summed over the spans (those of the
    indices `which`, if given): each span's duration less the parts its
    child spans cover."""
    own = [s["end"] - s["start"] for s in spans]
    for s in spans:
        if s["parent"] is not None:
            own[s["parent"]] -= s["end"] - s["start"]
    out: dict[str, float] = {}
    for i in range(len(spans)) if which is None else which:
        name = spans[i]["name"]
        out[name] = out.get(name, 0.0) + own[i] * 1e-9
    return out


class LevelMetrics:
    def __init__(self):
        self.records: list[dict] = []
        self._t0 = time.perf_counter_ns()

    def record(self, level: int, n_maps: int, n_joins: int, **extra):
        rec = dict(level=level, n_maps=n_maps, n_joins=n_joins,
                   t=round((time.perf_counter_ns() - self._t0) * 1e-9, 4),
                   **extra)
        self.records.append(rec)
        log.info("level %d: %d joins, %d maps, %.2fs elapsed %s",
                 level, n_joins, n_maps, rec["t"],
                 {k: v for k, v in extra.items()} or "")

    @property
    def total_joins(self) -> int:
        return sum(r["n_joins"] for r in self.records)

    def dump(self, path: str):
        with open(path, "w") as fh:
            json.dump(self.records, fh, indent=1)
