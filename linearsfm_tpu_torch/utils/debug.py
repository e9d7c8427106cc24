"""Numeric sanity check of a solved map (the reference C++ solver's only
guard is one assert).

Counterpart of `linearsfm_tpu/utils/debug.py:check_map`. The JAX package's
`enable_nan_checks` (a JAX debug flag) has no counterpart.
"""

from __future__ import annotations

import numpy as np

from .. import types


def check_map(lm) -> list[str]:
    """Problems of one map — finite values, in-range block coordinates,
    symmetric V blocks, gauge ids present, no duplicate pose ids — as
    strings (empty = healthy). `lm`: a port map on any device, one map or a
    lane stack of one lane, or a host-form map."""
    h = types.host_fields(lm)
    if h.poses.ndim == 3:
        if h.poses.shape[0] != 1:
            raise ValueError(f"check_map: one map, got {h.poses.shape[0]} "
                             f"lanes")
        h = types.map_fields(h, lambda a: a[0])
    probs = []
    for name in ("poses", "feats", "U", "W", "V"):
        if not np.isfinite(getattr(h, name)).all():
            probs.append(f"non-finite values in {name}")
    M, N = h.poses.shape[0], h.feats.shape[0]
    Uij, Wpf = h.Uij, h.Wpf
    if Uij.size and (Uij.min() < 0 or Uij.max() >= M):
        probs.append("U block coordinates out of range")
    if Wpf.size and (Wpf[:, 0].min() < 0 or Wpf[:, 0].max() >= M
                     or Wpf[:, 1].min() < 0 or Wpf[:, 1].max() >= N):
        probs.append("W block coordinates out of range")
    V = h.V
    if V.size and np.abs(V - np.swapaxes(V, 1, 2)).max() > 1e-9:
        probs.append("V blocks not symmetric")
    ids = h.pose_ids
    ref, scap = int(h.gauge.ref), int(h.gauge.scap)
    # stereo maps keep the reference implicit; mono must contain it
    if scap >= 0 and ref not in ids:
        probs.append(f"gauge ref id {ref} not among pose ids")
    if scap >= 0 and scap not in ids:
        probs.append(f"gauge scap id {scap} not among pose ids")
    valid = ids[ids >= 0]
    if len(np.unique(valid)) != len(valid):
        probs.append("duplicate pose ids")
    return probs
