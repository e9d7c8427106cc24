"""Host-driven merge tree: the host executor.

Counterpart of `linearsfm_tpu/core/tree.py` (`TreeSolver`). The reference
C++ solver's divide and conquer (lmj_PF3D_Divide_ConquerStereo,
LinearSFMImp.cpp:1926-2099; the mono variant :6511-6658): a binary-tree
reduction with odd-count carry, a re-gauge to the final reference after
every 2nd generated map of a level and once at the end.

The host drives the tree and keeps the maps in host form (numpy) between
levels, where each map is compacted to tight bucketed capacities
(`core/compact.compact`). The joins run on the solver's device: strategy
"level" stacks all pairs of a level, padded to common capacities, as the
lanes of one batched transform-and-join (`parallel/level.merge_one_*`);
"serial" joins one pair at a time. Each join's Schur system is assembled
grouped per feature, with the exact `max_obs` the host counts, or dense
from `ops/schur._DENSE_SCHUR_DIM` up; its kernels run on a CUDA device as
on every other path (K2 at every join, K1 in every dense assembly).

Not ported: the mesh (`mesh`, `root_mesh`: multiple GPUs); passing one
raises.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from .. import types
from ..ops import congruence
from ..parallel import level as plevel
from ..utils import checkpoint
from . import compact as compact_mod
from . import join as join_mod

log = logging.getLogger("linearsfm_tpu_torch")


def _max_obs_per_feature(lm) -> int:
    """Largest number of nonzero W entries of one feature in a single map
    (host form or a one-lane torch map), at least 1."""
    W, Wpf = lm.W, lm.Wpf
    if isinstance(W, torch.Tensor):
        W, Wpf = W.cpu().numpy(), Wpf.cpu().numpy()
    W, Wpf = W.reshape(-1, 6, 3), Wpf.reshape(-1, 2)
    f = Wpf[np.any(W != 0, axis=(1, 2)), 1]
    if f.size == 0:
        return 1
    return int(np.bincount(f).max())


def _pad_to(lm: types.LocalMap, M: int, N: int, KU: int,
            KW: int) -> types.LocalMap:
    """Grow the capacities of a host-form map (no-op where large enough)."""
    def pad(x, k, fill=0):
        return np.pad(x, [(0, max(k, x.shape[0]) - x.shape[0])]
                      + [(0, 0)] * (x.ndim - 1), constant_values=fill)
    return dataclasses.replace(
        lm, pose_ids=pad(lm.pose_ids, M, -1), poses=pad(lm.poses, M),
        feat_ids=pad(lm.feat_ids, N, -1), feats=pad(lm.feats, N),
        U=pad(lm.U, KU), Uij=pad(lm.Uij, KU), W=pad(lm.W, KW),
        Wpf=pad(lm.Wpf, KW), V=pad(lm.V, N))


class TreeSolver:
    """Runs the merge tree for one data type ("stereo" | "mono") on
    `device` (explicit; nothing is picked by default).

    strategy: "level" (default) joins all pairs of a tree level as one
    lane-batched pass; "serial" one pair at a time, like the reference
    C++ solver. method: "direct" (f64 Cholesky of the reduced system) or
    "refine" (stereo and mono pin "sign": the f32-preconditioned f64 PCG;
    mono pin "zero": the reduced system's f32 factor with refinement
    sweeps), `refine_iters` sweeps. pin: the mono scale pin (`JoinConfig`).
    bucket/u_bucket: the compaction's capacity buckets. progress: log each
    level.
    """

    def __init__(self, datatype: str, method: str = "direct",
                 refine_iters: int = 3, bucket: int = 16, u_bucket: int = 64,
                 progress: bool = False, strategy: str = "level", mesh=None,
                 pin: str = "sign", root_mesh=None, *, device):
        if datatype not in ("stereo", "mono"):
            raise ValueError(f"datatype must be 'stereo' or 'mono', got "
                             f"{datatype!r}")
        if strategy not in ("level", "serial"):
            raise ValueError(f"strategy must be 'level' or 'serial', got "
                             f"{strategy!r}")
        if mesh is not None or root_mesh is not None:
            raise NotImplementedError(
                "TreeSolver mesh and root_mesh: the mesh-parallel levels and the "
                "feature-sharded root are not ported (multiple GPUs, ROADMAP "
                "queue 1 item 13)")
        self.datatype = datatype
        self.device = torch.device(device)
        self.method = method
        self.refine_iters = refine_iters
        self.bucket = bucket
        self.u_bucket = u_bucket
        self.progress = progress
        self.strategy = strategy
        self.pin = pin
        self.join_count = 0
        self._last_timing: dict = {}

    def _cfg(self, max_obs: int) -> join_mod.JoinConfig:
        return join_mod.JoinConfig(max_obs=max_obs, method=self.method,
                                   refine_iters=self.refine_iters,
                                   pin=self.pin, dense_schur=False)

    def _one_lane(self, lm) -> types.LocalMap:
        """A host-form map as a one-lane stack on the device."""
        return types.stack([types.to_torch(lm, self.device)])

    def _transform(self, lm: types.LocalMap, gauge: types.Gauge
                   ) -> types.LocalMap:
        """One-lane map `lm` re-expressed in `gauge` (one-lane tags)."""
        if self.datatype == "stereo":
            return congruence.transform_map_stereo(lm, gauge.ref)
        return congruence.transform_map_mono(lm, gauge.ref, gauge.scap,
                                             gauge.fix)

    def _merge(self, g: types.LocalMap, m: types.LocalMap, cfg):
        merge = (plevel.merge_one_stereo if self.datatype == "stereo"
                 else plevel.merge_one_mono)
        return merge(g, m, cfg)

    # -- merge steps ---------------------------------------------------------
    def merge_pair(self, g: types.LocalMap, m: types.LocalMap
                   ) -> types.LocalMap:
        """Transform the accumulated host-form map `g` into `m`'s gauge when
        it differs, and fuse; returns the fused map in host form."""
        gd, md = self._one_lane(g), self._one_lane(m)
        if int(g.gauge.ref) != int(m.gauge.ref) or (
                self.datatype == "mono"
                and int(g.gauge.scap) != int(m.gauge.scap)):
            gd = self._transform(gd, md.gauge)
        # a shared max_obs for the fused map (upper bound: sum of both sides)
        mo = types.bucket(_max_obs_per_feature(gd) + _max_obs_per_feature(m),
                          4)
        if self.datatype == "stereo":
            out = join_mod.join_stereo(gd, md, self._cfg(mo))
        else:
            out = join_mod.join_mono(gd, md, self._cfg(mo))
        self.join_count += 1
        return types.to_numpy(types.lanes(out, 0))

    def regauge_to_final(self, g: types.LocalMap) -> types.LocalMap:
        """Re-express the host-form map `g` in the first map's gauge if
        needed (:1997-2030), else return it as it is."""
        if int(g.gauge.ref) > int(g.gauge.fref):
            lane = self._one_lane(g)
            lg = lane.gauge
            fin = dataclasses.replace(lg, ref=lg.fref, scap=lg.fscap,
                                      fix=lg.ffix)
            g = types.to_numpy(types.lanes(self._transform(lane, fin), 0))
        return g

    # -- level-batched execution ---------------------------------------------
    def _run_level_batched(self, gs: list, ms: list) -> list:
        """All pairwise joins of one level as one lane-batched pass; returns
        the merged maps in host form."""
        t0 = time.perf_counter()
        both = gs + ms
        caps = [max(getattr(lm, k) for lm in both)
                for k in ("M", "N", "KU", "KW")]
        both = [_pad_to(lm, *caps) for lm in both]
        gs, ms = both[:len(gs)], both[len(gs):]
        # +1/+2: the merge transforms g, which adds one (r, f) coupling per
        # feature (mono also (s, f)) to g's own entries
        span = 1 if self.datatype == "stereo" else 2
        mo = types.bucket(max(_max_obs_per_feature(g) for g in gs) + span
                          + max(_max_obs_per_feature(m) for m in ms), 4)
        G = types.to_torch(plevel.stack_maps(gs), self.device)
        Mb = types.to_torch(plevel.stack_maps(ms), self.device)
        t1 = time.perf_counter()
        out = self._merge(G, Mb, self._cfg(mo))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        res = plevel.unstack_maps(out)
        t3 = time.perf_counter()
        self._last_timing = dict(prep=round(t1 - t0, 4),
                                 device=round(t2 - t1, 4),
                                 get=round(t3 - t2, 4), max_obs=mo)
        self.join_count += len(gs)
        return res

    # -- full tree -----------------------------------------------------------
    def run(self, maps: list, ckpt_dir: str | None = None,
            resume: bool = False, metrics=None) -> types.LocalMap:
        """Solve the tree over `maps` (objects `types.host_fields` accepts)
        and return the root map in host form (numpy).

        ckpt_dir: save the maps after every level (`level<L>_map<i>.npz`);
        resume: start from the newest complete level there instead of
        `maps`."""
        level = 0
        if resume and ckpt_dir:
            state = checkpoint.latest(ckpt_dir)
            if state is not None:
                level, maps = state
                log.info("resuming from checkpoint level %d (%d maps)",
                         level, len(maps))
        maps = [compact_mod.compact(lm, self.bucket, self.u_bucket)
                for lm in maps]
        count = len(maps)
        t0 = time.perf_counter()
        while count > 1:
            nxt = (count + 1) // 2
            npair = count // 2
            if self.strategy == "level" and npair > 1:
                merged = self._run_level_batched(
                    [maps[2 * i] for i in range(npair)],
                    [maps[2 * i + 1] for i in range(npair)])
            else:
                merged = [self.merge_pair(maps[2 * i], maps[2 * i + 1])
                          for i in range(npair)]
            out = []
            for i in range(nxt):
                g = merged[i] if i < npair else maps[2 * i]  # odd carry (:1946-1948)
                if (i + 1) % 2 == 0:
                    g = self.regauge_to_final(g)
                out.append(compact_mod.compact(g, self.bucket, self.u_bucket))
            maps = out
            count = nxt
            level += 1
            if metrics is not None:
                metrics.record(level, count, npair, M=maps[0].M, N=maps[0].N,
                               **self._last_timing)
            if ckpt_dir:
                checkpoint.save_level(ckpt_dir, level, maps)
            if self.progress:
                log.info("Level %d done (%d maps, %.2fs)", level, count,
                         time.perf_counter() - t0)
        g = self.regauge_to_final(maps[0])
        return compact_mod.compact(g, self.bucket, self.u_bucket)
