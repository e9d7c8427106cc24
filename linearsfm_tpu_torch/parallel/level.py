"""One tree level's pairwise joins as one lane-batched pass.

Counterpart of `linearsfm_tpu/parallel/level.py`. The reference vmaps the
single-pair merge over the pairs of a level; here the pairs are the lanes
of stacked maps, and the merge functions take them all at once. Over a
`parallel/mesh.Mesh` (`level_merge_fn`, `run_level`) the lanes are split
into equal runs, one per shard, each merged on its shard's device (the
reference's shard_map over the ``pairs`` axis).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import types
from ..core import join as join_mod
from ..ops import congruence
from ..utils import metrics
from .mesh import Mesh


def merge_one_stereo(g: types.LocalMap, m: types.LocalMap,
                     cfg: join_mod.JoinConfig):
    """Transform each lane of g into m's gauge and fuse the pair (spans
    `transform` and `join` of the open solve, `utils/metrics`)."""
    with metrics.span("transform"):
        end = congruence.transform_map_stereo(g, m.gauge.ref,
                                              info_dtype=cfg.info_dtype)
    with metrics.span("join"):
        return join_mod.join_stereo(end, m, cfg)


def merge_one_mono(g: types.LocalMap, m: types.LocalMap,
                   cfg: join_mod.JoinConfig):
    with metrics.span("transform"):
        end = congruence.transform_map_mono(g, m.gauge.ref, m.gauge.scap,
                                            m.gauge.fix,
                                            info_dtype=cfg.info_dtype)
    with metrics.span("join"):
        return join_mod.join_mono(end, m, cfg)


def stack_maps(maps: list[types.LocalMap]) -> types.LocalMap:
    """Stack host-form maps along a new leading lane axis (numpy, so a level
    moves to the device in one copy per field), each at the widest map's
    capacities: ids pad with -1, everything else with 0, as `pad_to`."""
    def stacked(obj_of, f):
        arrays = [np.asarray(getattr(obj_of(m), f)) for m in maps]
        shape = tuple(max(d) for d in zip(*(a.shape for a in arrays)))
        out = np.full((len(arrays),) + shape, -1 if f.endswith("_ids") else 0,
                      arrays[0].dtype)
        for b, a in enumerate(arrays):
            out[(b,) + tuple(slice(0, d) for d in a.shape)] = a
        return out

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


def level_merge_fn(datatype: str, cfg: join_mod.JoinConfig, mesh: Mesh,
                   axis: str = "pairs"):
    """The level merge over `mesh`: fn(G, M) for lane-stacked pairs whose
    lane count is a multiple of the mesh size (pad with clones and drop
    their results), returning the merged lanes (and the residuals when
    cfg.with_res) on the mesh's first device, in lane order. `axis` names
    the mesh axis, as the reference's signature does."""
    one = merge_one_stereo if datatype == "stereo" else merge_one_mono
    d0 = mesh.devices[0]

    def to(lm, dev):
        return types.map_fields(lm, lambda a: a.to(dev))

    def fn(G: types.LocalMap, Mb: types.LocalMap):
        P = G.poses.shape[0]
        if P % mesh.size:
            raise ValueError(f"level_merge_fn: {P} pairs do not split over "
                             f"{mesh.size} shards")
        per = P // mesh.size
        outs = []
        for d, dev in enumerate(mesh.devices):
            run = slice(d * per, (d + 1) * per)
            with mesh.on(d):
                out = one(to(types.lanes(G, run), dev),
                          to(types.lanes(Mb, run), dev), cfg)
            outs.append((to(out[0], d0), out[1].to(d0)) if cfg.with_res
                        else to(out, d0))
        if cfg.with_res:
            return (types.cat([o[0] for o in outs]),
                    torch.cat([o[1] for o in outs]))
        return types.cat(outs)

    return fn


def run_level(gs: list, ms: list, datatype: str, cfg: join_mod.JoinConfig,
              mesh: Mesh, fn_cache: dict | None = None) -> list:
    """One tree level's joins (host-form maps of equal capacities) over the
    mesh: padded with clones of the last pair to a multiple of the mesh
    size, merged, and returned as host-form maps without the clones.
    fn_cache keeps the merge function per (datatype, cfg, mesh)."""
    npair = len(gs)
    pad = (-npair) % mesh.size
    gs = gs + [gs[-1]] * pad
    ms = ms + [ms[-1]] * pad
    key = ("level", datatype, cfg, mesh.devices, mesh.axis)
    fn = fn_cache.get(key) if fn_cache is not None else None
    if fn is None:
        fn = level_merge_fn(datatype, cfg, mesh)
        if fn_cache is not None:
            fn_cache[key] = fn
    d0 = mesh.devices[0]
    out = fn(types.to_torch(stack_maps(gs), d0),
             types.to_torch(stack_maps(ms), d0))
    if cfg.with_res:
        out = out[0]
    return unstack_maps(out)[:npair]
