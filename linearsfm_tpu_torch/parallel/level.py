"""One tree level's pairwise joins as one lane-batched pass.

Counterpart of `linearsfm_tpu/parallel/level.py` (`merge_one_stereo`,
`merge_one_mono`, `stack_maps`, `unstack_maps`). The reference vmaps the
single-pair merge over the pairs of a level; here the pairs are the lanes
of stacked maps, and the merge functions take them all at once. The
mesh-parallel level (`level_merge_fn`, `run_level`) is not ported
(multiple GPUs).
"""

from __future__ import annotations

import numpy as np

from .. import types
from ..core import join as join_mod
from ..ops import congruence


def merge_one_stereo(g: types.LocalMap, m: types.LocalMap,
                     cfg: join_mod.JoinConfig):
    """Transform each lane of g into m's gauge and fuse the pair."""
    end = congruence.transform_map_stereo(g, m.gauge.ref,
                                          info_dtype=cfg.info_dtype)
    return join_mod.join_stereo(end, m, cfg)


def merge_one_mono(g: types.LocalMap, m: types.LocalMap,
                   cfg: join_mod.JoinConfig):
    end = congruence.transform_map_mono(g, m.gauge.ref, m.gauge.scap,
                                        m.gauge.fix, info_dtype=cfg.info_dtype)
    return join_mod.join_mono(end, m, cfg)


def stack_maps(maps: list[types.LocalMap]) -> types.LocalMap:
    """Stack same-capacity host-form maps along a new leading lane axis
    (numpy, so a level moves to the device in one copy per field)."""
    def stacked(obj_of, f):
        return np.stack([np.asarray(getattr(obj_of(m), f)) for m in maps])

    gauge = types.Gauge(*(stacked(lambda m: m.gauge, f)
                          for f in types.GAUGE_FIELDS))
    return types.LocalMap(*(stacked(lambda m: m, f) for f in types.MAP_FIELDS),
                          gauge=gauge)


def unstack_maps(batched: types.LocalMap) -> list[types.LocalMap]:
    """Split a lane-stacked map into host-form maps, after one copy of the
    batch to the host."""
    host = types.host_fields(batched)
    return [types.map_fields(host, lambda a, i=i: a[i])
            for i in range(host.poses.shape[0])]
