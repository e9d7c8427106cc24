"""Per-level checkpoint/resume for both tree executors.

Counterpart of `linearsfm_tpu/utils/checkpoint.py`, with the same file
names, `.npz` keys and manifests, so either package reads the other's
checkpoints. The map set at a tree level boundary is a complete restart
point (the reference C++ solver keeps it only in memory).

* Host executor: `save_level` writes one `level<L>_map<i>.npz` per map and
  `manifest.json`; `latest` returns the newest complete level.
* Device executor: `save_stacked` writes the lane-stacked level boundary as
  one `stacked_level<L>.npz` and `stacked_manifest.json`; `latest_stacked`
  returns it. The executor re-derives its plan from the input maps and
  checks the stored shape against it before skipping levels.

Maps come back in host form (numpy, int32 ids); manifests are replaced
atomically, after the arrays they name are written.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .. import types


def _arrays(lm) -> dict:
    h = types.host_fields(lm)
    arrs = {f: np.asarray(getattr(h, f)) for f in types.MAP_FIELDS}
    arrs.update({f"gauge_{f}": np.asarray(getattr(h.gauge, f))
                 for f in types.GAUGE_FIELDS})
    return arrs


def _from_npz(f) -> types.LocalMap:
    gauge = types.Gauge(**{k: f[f"gauge_{k}"] for k in types.GAUGE_FIELDS})
    return types.LocalMap(**{k: f[k] for k in types.MAP_FIELDS}, gauge=gauge)


def _write_manifest(ckpt_dir: str, name: str, manifest: dict) -> None:
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    with open(tmp, "w") as fh:
        json.dump(manifest, fh)
    os.replace(tmp, os.path.join(ckpt_dir, name))


def save_level(ckpt_dir: str, level: int, maps: list) -> None:
    """Persist the maps after tree level `level` (host or torch maps)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    for i, lm in enumerate(maps):
        np.savez_compressed(os.path.join(ckpt_dir, f"level{level}_map{i}.npz"),
                            **_arrays(lm))
    _write_manifest(ckpt_dir, "manifest.json",
                    dict(level=level, count=len(maps)))


def latest(ckpt_dir: str):
    """(level, host-form maps) of the newest complete checkpoint, or None."""
    path = os.path.join(ckpt_dir, "manifest.json")
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        manifest = json.load(fh)
    level, count = manifest["level"], manifest["count"]
    maps = []
    for i in range(count):
        with np.load(os.path.join(ckpt_dir, f"level{level}_map{i}.npz")) as f:
            maps.append(_from_npz(f))
    return level, maps


def save_stacked(ckpt_dir: str, level: int, st) -> None:
    """Persist the lane-stacked level-boundary map set (the input of level
    `level` + 1) after one copy to the host."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, "stacked.npz.tmp")
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **_arrays(st))
    os.replace(tmp, os.path.join(ckpt_dir, f"stacked_level{level}.npz"))
    _write_manifest(ckpt_dir, "stacked_manifest.json", dict(level=level))


def latest_stacked(ckpt_dir: str):
    """(level, host-form stacked LocalMap) of the newest checkpoint, or
    None."""
    path = os.path.join(ckpt_dir, "stacked_manifest.json")
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        level = json.load(fh)["level"]
    with np.load(os.path.join(ckpt_dir, f"stacked_level{level}.npz")) as f:
        return level, _from_npz(f)
