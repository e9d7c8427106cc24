"""Device-resident merge tree: each level is one batched pass over its pairs.

Counterpart of `linearsfm_tpu/core/device_tree.py` (stereo, one device).
The whole level — all pairwise joins, the every-2nd-map re-gauge to the
final frame, the odd carry and the compaction — runs on lane-stacked
[count, ...caps] tensors, so the maps never leave the device between levels.
The host only builds the capacity plan (core/plan.py), drives one level after
another, and reads the residuals at the end.

Not ported (TPU- or JAX-specific): the Pallas vmap-width gate and
the <=1,024-lane split, AOT warm-up, mesh modes and checkpointing.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import types
from ..ops import congruence
from . import compact as compact_mod
from . import dcompact
from . import join as join_mod
from . import plan as plan_mod


def pad_to_device(lm: types.LocalMap, M: int, N: int, KU: int,
                  KW: int) -> types.LocalMap:
    """Grow the slot capacities of a stacked map (axis 1 of every field)."""
    def pad(x, k, fill=0):
        widths = [0, 0] * (x.dim() - 2) + [0, k - x.shape[1]]
        return torch.nn.functional.pad(x, widths, value=fill)
    return dataclasses.replace(
        lm,
        pose_ids=pad(lm.pose_ids, M, -1), poses=pad(lm.poses, M),
        feat_ids=pad(lm.feat_ids, N, -1), feats=pad(lm.feats, N),
        U=pad(lm.U, KU), Uij=pad(lm.Uij, KU),
        W=pad(lm.W, KW), Wpf=pad(lm.Wpf, KW),
        V=pad(lm.V, N),
    )


class _LevelTimer:
    """Per-level device walls: CUDA events on a GPU (read after the final
    synchronise, so timing does not stall the pipeline), the host clock on
    the CPU, where every operation is synchronous."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def walls(self) -> list[float]:
        """Seconds between consecutive marks."""
        if self.cuda:
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


class DeviceTreeSolver:
    """Device-resident hierarchical solver: binary-tree reduction with odd
    carry, every-2nd-map re-gauge, final re-gauge to the first map's frame.

    device: where the levels run (explicit; nothing is picked by default).
    Iteration bands (method="refine"): joins with fewer than `top_min_m`
    joined poses run `refine_iters` PCG sweeps; larger ones up to
    `top_iters`, with the early exit at `pcg_exit_tol` and `top_iters` more
    sweeps on lanes whose residual exceeds `escalate_tol`. `mixed_max_m`
    runs levels up to that size with f32 information (off by default);
    `direct_min_m` solves levels from that size with a plain f64 Cholesky.
    """

    def __init__(self, datatype: str = "stereo", method: str = "refine",
                 refine_iters: int = 3, bucket: int = 16, u_bucket: int = 64,
                 mixed_max_m: int = 0, direct_min_m: int = 0,
                 top_min_m: int = 256, top_iters: int = 16,
                 escalate_tol: float = 1e-8, pcg_exit_tol: float = 1e-14, *,
                 device):
        if datatype != "stereo":
            raise NotImplementedError("the port solves stereo maps only")
        self.datatype = datatype
        self.device = torch.device(device)
        self.method = method
        self.refine_iters = refine_iters
        self.bucket = bucket
        self.u_bucket = u_bucket
        self.mixed_max_m = mixed_max_m if method == "refine" else 0
        self.direct_min_m = direct_min_m if method == "refine" else 0
        self.top_min_m = top_min_m
        self.top_iters = top_iters
        self.escalate_tol = escalate_tol
        self.pcg_exit_tol = pcg_exit_tol
        self.join_count = 0
        self.last_residuals: dict = {}
        self._last_timing: dict = {}

    def _cfg(self, joined_m: int) -> join_mod.JoinConfig:
        if joined_m <= self.mixed_max_m:
            return join_mod.JoinConfig(method="direct",
                                       info_dtype=torch.float32, with_res=True)
        if self.direct_min_m and joined_m >= self.direct_min_m:
            return join_mod.JoinConfig(method="direct",
                                       info_dtype=torch.float64, with_res=True)
        top = joined_m >= self.top_min_m
        return join_mod.JoinConfig(
            method=self.method,
            refine_iters=self.top_iters if top else self.refine_iters,
            info_dtype=torch.float64, with_res=True,
            escalate_iters=self.top_iters if top else 0,
            escalate_tol=self.escalate_tol,
            exit_tol=self.pcg_exit_tol if top else 0.0)

    # -- building blocks -----------------------------------------------------
    def _merge(self, g: types.LocalMap, m: types.LocalMap, cfg):
        end = congruence.transform_map_stereo(g, m.gauge.ref,
                                              info_dtype=cfg.info_dtype)
        return join_mod.join_stereo(end, m, cfg)

    def _regauge_compact(self, lm: types.LocalMap, caps_out, info_dtype):
        """Re-gauge to the final frame + compact, on the lanes the exact plan
        flags (the id comparison ref > fref is decided on the host)."""
        t = congruence.transform_map_stereo(lm, lm.gauge.fref,
                                            info_dtype=info_dtype)
        return dcompact.compact_device(t, *caps_out)[0]

    def _level(self, x: types.LocalMap, lp: plan_mod.LevelPlan):
        """One tree level over `lp.count` stacked lanes. Returns (next level's
        stacked maps in output order, residual per merged lane [count // 2 +
        count % 2] with the carry last)."""
        count, caps_out, flags = lp.count, lp.caps_out, lp.regauge
        cfg = self._cfg(lp.join_m if lp.join_m is not None
                        else 2 * lp.caps_in[0])
        npair, nxt = count // 2, (count + 1) // 2
        idx_rg = [i for i in range(nxt) if flags[i]]
        idx_nr = [i for i in range(nxt) if not flags[i]]
        perm = np.argsort(np.array(idx_nr + idx_rg)).tolist()

        merged, res = self._merge(types.lanes(x, slice(0, 2 * npair, 2)),
                                  types.lanes(x, slice(1, 2 * npair, 2)), cfg)
        if count % 2 == 1:
            carry = types.lanes(x, slice(count - 1, count))
            carry = pad_to_device(carry, merged.M, merged.N, merged.KU,
                                  merged.KW)
            carry = dataclasses.replace(
                carry, poses=carry.poses.to(merged.poses.dtype),
                feats=carry.feats.to(merged.feats.dtype),
                U=carry.U.to(merged.U.dtype), W=carry.W.to(merged.W.dtype),
                V=carry.V.to(merged.V.dtype))
            merged = types.cat([merged, carry])
            res = torch.cat([res, res.new_zeros(1)])

        parts = []
        if idx_nr:
            parts.append(dcompact.compact_device(types.lanes(merged, idx_nr),
                                                 *caps_out)[0])
        if idx_rg:
            parts.append(self._regauge_compact(types.lanes(merged, idx_rg),
                                               caps_out, cfg.info_dtype))
        # res stays in merged order (pair i at slot i, carry last)
        return types.lanes(types.cat(parts), perm), res

    def _final(self, x: types.LocalMap, caps, need: bool) -> types.LocalMap:
        root = types.lanes(x, slice(0, 1))
        out = (self._regauge_compact(root, caps, torch.float64) if need
               else dcompact.compact_device(root, *caps)[0])
        dt = out.poses.dtype
        out = dataclasses.replace(out, U=out.U.to(dt), W=out.W.to(dt),
                                  V=out.V.to(dt))
        return types.lanes(out, 0)

    # -- full tree -----------------------------------------------------------
    def run(self, maps: list, metrics=None,
            time_levels: bool = False) -> types.LocalMap:
        """Solve the tree over `maps` (objects `types.host_fields` accepts)
        and return the root map on the solver's device.

        time_levels: record each level's device wall into the metrics
        records (`exec_wall`, seconds)."""
        t0 = time.perf_counter()
        stacked = compact_mod.compact_stack(maps, self.bucket, self.u_bucket)
        t1 = time.perf_counter()
        syms = plan_mod.sym_of_stacked(stacked)
        tp = plan_mod.plan_tree_exact(syms, self.datatype, self.bucket,
                                      self.u_bucket)
        if not tp:
            return types.lanes(types.to_torch(stacked, self.device), 0)
        plans = tp.levels
        Mi, Ni, KUi, KWi = plans[0].caps_in

        def grow(a, cap, fill=0):
            if a.ndim < 2 or a.shape[1] >= cap:
                return a
            return np.pad(a, [(0, 0), (0, cap - a.shape[1])]
                          + [(0, 0)] * (a.ndim - 2), constant_values=fill)

        stacked = dataclasses.replace(
            stacked,
            pose_ids=grow(stacked.pose_ids, Mi, -1),
            poses=grow(stacked.poses, Mi),
            feat_ids=grow(stacked.feat_ids, Ni, -1),
            feats=grow(stacked.feats, Ni),
            U=grow(stacked.U, KUi), Uij=grow(stacked.Uij, KUi),
            W=grow(stacked.W, KWi), Wpf=grow(stacked.Wpf, KWi),
            V=grow(stacked.V, Ni))
        t2 = time.perf_counter()
        x = types.to_torch(stacked, self.device)
        t3 = time.perf_counter()
        timer = _LevelTimer(self.device)
        res_per_level = {}
        for li, lp in enumerate(plans):
            if time_levels:
                timer.mark()
            x, res = self._level(x, lp)
            res_per_level[li + 1] = res
            self.join_count += lp.count // 2
            if metrics is not None:
                metrics.record(li + 1, (lp.count + 1) // 2, lp.count // 2,
                               M=lp.caps_out[0], N=lp.caps_out[1],
                               join_m=lp.join_m,
                               wall=round(time.perf_counter() - t0, 4))
        if time_levels:
            timer.mark()
        y = self._final(x, tp.root_caps, tp.root_regauge)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t4 = time.perf_counter()
        # per-level PCG residuals, read once after the tree
        self.last_residuals = {lv: r.cpu().numpy()
                               for lv, r in res_per_level.items()}
        if metrics is not None:
            by_level = {r["level"]: r for r in metrics.records}
            walls = timer.walls() if time_levels else []
            for lv, r in self.last_residuals.items():
                if lv not in by_level:
                    continue
                if r.size:
                    # max, not nanmax: a NaN lane must show in res_max
                    with np.errstate(invalid="ignore"):
                        by_level[lv]["res_max"] = float(np.max(r))
                if walls:
                    by_level[lv]["exec_wall"] = walls[lv - 1]
        self._last_timing = dict(compact=t1 - t0, plan=t2 - t1,
                                 upload=t3 - t2, levels=t4 - t3,
                                 get=time.perf_counter() - t4)
        return y
