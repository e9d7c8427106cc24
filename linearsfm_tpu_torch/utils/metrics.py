"""Structured per-level metrics and timing.

Counterpart of `linearsfm_tpu/utils/metrics.py`.

The reference prints one wall-clock line (LinearSFMImp.cpp:2068-2072); here
every tree level logs joins, shapes, solve residual proxy, and throughput, and
the collected record is JSON-serializable for observability pipelines.
"""

from __future__ import annotations

import json
import logging
import time

log = logging.getLogger("linearsfm_tpu_torch")


class LevelMetrics:
    def __init__(self):
        self.records: list[dict] = []
        self._t0 = time.time()

    def record(self, level: int, n_maps: int, n_joins: int, **extra):
        rec = dict(level=level, n_maps=n_maps, n_joins=n_joins,
                   t=round(time.time() - self._t0, 4), **extra)
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
