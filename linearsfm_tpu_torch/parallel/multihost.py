"""Multi-process tree: process-local subtrees, then a replicated top.

Counterpart of `linearsfm_tpu/parallel/multihost.py`. The reference merge
tree (lmj_PF3D_Divide_ConquerStereo/Mono, LinearSFMImp.cpp:1932-2035) is a
binary reduction over the map sequence. The sequence is cut into aligned
binary blocks of 2^L maps (the last may be partial): inside the first L
levels no join crosses a block boundary, so each block reduces on the
process that owns it, and only the top levels, over one root per block,
need the others' data.

Any map count works: a partial tail block reduces in fewer levels and then
rides the global schedule as the odd carry (:1946-1948). The every-2nd-map
re-gauge keys on the global output position (:1997); a block root carried
idle through a level sits at position (block offset >> level), and if any
of those positions is odd the root re-gauges to the final frame once (the
transform is idempotent through the ref > fref guard). Full blocks get the
same positions from the planner's map offset (`DeviceTreeSolver(
plan_offset=..., final_regauge=False)`).

Transport: the block roots, padded to capacities every process derives
from the same map metadata, are gathered once (`all_gather_object` over the
`torch.distributed` process group, gloo on host arrays, so several
processes may share one card), and every process runs the top levels
itself, from the gathered list in global order: all finish with the same
root. A single process simulates the others with a `gather` of its own.
"""

from __future__ import annotations

import numpy as np

from .. import types
from ..core import plan as plan_mod
from ..core.device_tree import DeviceTreeSolver
from . import level as plevel


def plan_chunks(n_maps: int, n_hosts: int):
    """(L, block, owners): aligned binary blocks of `block` = 2^L maps (L so
    that every host owns at least one block where it can) and each host's
    blocks, owners[h] = (first, last + 1), contiguous and near-even."""
    if n_maps < 1 or n_hosts < 1:
        raise ValueError(f"plan_chunks: {n_maps} maps on {n_hosts} hosts")
    per = max(1, n_maps // n_hosts)
    L = max(0, per.bit_length() - 1)
    block = 1 << L
    nblocks = -(-n_maps // block)
    base, rem = divmod(nblocks, n_hosts)
    owners = []
    lo = 0
    for h in range(n_hosts):
        take = base + (1 if h < rem else 0)
        owners.append((lo, lo + take))
        lo += take
    return L, block, owners


def _levels_of(count: int) -> int:
    """Tree levels that reduce `count` maps to one (0 for one map)."""
    lv = 0
    while count > 1:
        count = (count + 1) // 2
        lv += 1
    return lv


def _block_spans(n_maps: int, block: int, b_lo: int, b_hi: int):
    return [(b * block, min((b + 1) * block, n_maps))
            for b in range(b_lo, b_hi)]


def _carry_regauge_positions(o: int, used: int, L: int):
    """Global output positions of a block root while it idles (carry)
    through levels used + 1 .. L of the global schedule."""
    return [o >> lv for lv in range(used + 1, L + 1)]


def local_phase(maps: list, datatype: str, n_hosts: int, host_id: int,
                solver_kw: dict | None = None) -> list:
    """Reduce this host's blocks; returns the block roots (host form) in
    block order. solver_kw: `DeviceTreeSolver` arguments (`device`: the
    card by default)."""
    from ..core.tree import TreeSolver
    L, block, owners = plan_chunks(len(maps), n_hosts)
    b_lo, b_hi = owners[host_id]
    # host-side transform for the idle-carry re-gauges
    solver_kw = solver_kw or {}
    ts = TreeSolver(datatype, device=solver_kw.get("device", "cuda"))
    roots = []
    for lo, hi in _block_spans(len(maps), block, b_lo, b_hi):
        span = maps[lo:hi]
        if len(span) == 1:
            root = types.host_fields(span[0])
            used = 0
        else:
            solver = DeviceTreeSolver(datatype, plan_offset=lo,
                                      final_regauge=False, **solver_kw)
            root = types.to_numpy(solver.run(span))
            used = _levels_of(len(span))
        if any(p % 2 == 1 for p in _carry_regauge_positions(lo, used, L)):
            # idempotent: regauge_to_final does nothing unless ref > fref,
            # and afterwards ref == fref, so one application covers every
            # odd carry position (LinearSFMImp.cpp:1997-2030)
            root = ts.regauge_to_final(root)
        roots.append(root)
    return roots


def common_root_caps(maps: list, datatype: str, n_hosts: int,
                     bucket: int = 16, u_bucket: int = 64):
    """Capacities shared by every block root, idle-carry re-gauge growth
    included. Every process derives them from the same map metadata, so
    the gather exchanges equal shapes without a handshake."""
    n = len(maps)
    L, block, owners = plan_chunks(n, n_hosts)
    stacked = plevel.stack_maps([types.host_fields(m) for m in maps])
    caps = [1, 1, 1, 1]
    for lo, hi in _block_spans(n, block, 0, owners[-1][1]):
        syms = plan_mod.sym_of_stacked(
            types.map_fields(stacked, lambda a: a[lo:hi]))
        levels, root = plan_mod._simulate(syms, datatype, bucket, u_bucket,
                                          map_offset=lo)
        carried = _carry_regauge_positions(lo, len(levels), L)
        if any(p % 2 == 1 for p in carried):
            # the transform applies only where ref > fref, as
            # `regauge_to_final` (local_phase)
            root = plan_mod._regauge(root, root.ref > root.fref, datatype)
        caps = [max(a, b) for a, b in zip(caps,
                                          root.caps(bucket, u_bucket))]
    return tuple(caps)


def local_stacked(maps: list, datatype: str, n_hosts: int, host_id: int,
                  solver_kw: dict | None = None) -> types.LocalMap:
    """This host's part of the gather: its block roots padded to the common
    capacities and stacked to [max blocks per host, ...] (zero lanes past
    the blocks it owns; peers drop them by the owner table)."""
    _, _, owners = plan_chunks(len(maps), n_hosts)
    roots = local_phase(maps, datatype, n_hosts, host_id, solver_kw)
    caps = common_root_caps(maps, datatype, n_hosts)
    padded = [types.pad_to(r, *caps) for r in roots]
    maxb = max(hi - lo for lo, hi in owners)
    # a host owns no block when there are more hosts than blocks
    model = padded[0] if padded else types.pad_to(
        types.host_fields(maps[0]), *caps)
    padded += [types.map_fields(model, np.zeros_like)] * (maxb - len(padded))
    return plevel.stack_maps(padded)


def top_phase(roots: list, datatype: str,
              solver_kw: dict | None = None) -> types.LocalMap:
    """The top levels over the gathered block roots (the global level-L
    map list, in order, so at map offset 0), on this process."""
    return DeviceTreeSolver(datatype, **(solver_kw or {})).run(roots)


def _allgather(stacked: types.LocalMap, n_hosts: int) -> list:
    import torch.distributed as dist
    out = [None] * n_hosts
    dist.all_gather_object(out, stacked)
    return out


def run_multihost(maps: list, datatype: str, n_hosts: int | None = None,
                  host_id: int | None = None, gather=None,
                  solver_kw: dict | None = None) -> types.LocalMap:
    """The whole solve from this process's side; returns the root map (on
    the solver's device).

    gather(stacked) -> every host's stacked block roots, in host order
    (`local_stacked`); by default `torch.distributed.all_gather_object`
    over the process group. n_hosts, host_id: by default the group's world
    size and this process's rank, or 1 and 0 without a group. solver_kw:
    `DeviceTreeSolver` arguments (`device`: the card by default)."""
    solver_kw = solver_kw or {}
    if n_hosts is None or host_id is None:
        import torch.distributed as dist
        grouped = dist.is_available() and dist.is_initialized()
        if n_hosts is None:
            n_hosts = dist.get_world_size() if grouped else 1
        if host_id is None:
            host_id = dist.get_rank() if grouped else 0
    if n_hosts == 1:
        return DeviceTreeSolver(datatype, **solver_kw).run(maps)

    _, _, owners = plan_chunks(len(maps), n_hosts)
    stacked = local_stacked(maps, datatype, n_hosts, host_id, solver_kw)
    if gather is None:
        def gather(st):
            return _allgather(st, n_hosts)
    per_host = gather(stacked)
    all_roots = [types.map_fields(per_host[h], lambda a, i=i: a[i])
                 for h, (lo, hi) in enumerate(owners)
                 for i in range(hi - lo)]
    return top_phase(all_roots, datatype, solver_kw)
