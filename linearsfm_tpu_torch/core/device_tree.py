"""Device-resident merge tree: each level is one batched pass over its pairs.

Counterpart of `linearsfm_tpu/core/device_tree.py` (stereo and mono, on
one device or over a `parallel/mesh.Mesh`).
The whole level — all pairwise joins, the every-2nd-map re-gauge to the
final frame, the odd carry and the compaction — runs on lane-stacked
[count, ...caps] tensors, so the maps never leave the device between levels.
The host only builds the capacity plan (core/plan.py), drives one level after
another, and reads the residuals at the end. With a checkpoint directory
each level boundary is also saved (`utils/checkpoint.save_stacked`, one
device-to-host copy per level), and a resumed run restarts from the newest
one whose shapes the plan confirms.

Over a mesh each level takes one of the reference's modes (`_level_mode`):
"dp" splits the pair lanes over the shards, "tp" shards the feature axis of
the root-style single-pair solve, "rep" runs the plain level on the mesh's
first device, where the level boundaries stay. A subtree of a larger tree
(`parallel/multihost.py`) is planned at its global offset and without the
final re-gauge.

Not ported (TPU- or JAX-specific): the Pallas vmap-width gate and
the <=1,024-lane split, and AOT warm-up.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from .. import types
from ..ops import congruence, kernels, segment
from ..parallel import level as plevel
from ..parallel.mesh import canonical, solver_device
from ..utils import checkpoint
from ..utils.metrics import (device_span, read_device_walls, recording,
                             self_seconds, span)
from . import compact as compact_mod
from . import dcompact
from . import join as join_mod
from . import plan as plan_mod

log = logging.getLogger("linearsfm_tpu_torch")

# spans whose self seconds, summed over a solve, `_last_timing` holds
SELF_TIMED = ("plan_tree", "transform", "join", "sync", "regauge_compact",
              "final", "mono_gauge", "schur_f64")


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


def _grow_stacked(stacked: types.LocalMap, M: int, N: int, KU: int,
                 KW: int) -> types.LocalMap:
    """Grow the slot capacities of a host (numpy) stack, axis 1 of every
    field (no-op where already as large)."""
    def grow(a, cap, fill=0):
        if a.ndim < 2 or a.shape[1] >= cap:
            return a
        return np.pad(a, [(0, 0), (0, cap - a.shape[1])]
                      + [(0, 0)] * (a.ndim - 2), constant_values=fill)

    return dataclasses.replace(
        stacked,
        pose_ids=grow(stacked.pose_ids, M, -1), poses=grow(stacked.poses, M),
        feat_ids=grow(stacked.feat_ids, N, -1), feats=grow(stacked.feats, N),
        U=grow(stacked.U, KU), Uij=grow(stacked.Uij, KU),
        W=grow(stacked.W, KW), Wpf=grow(stacked.Wpf, KW),
        V=grow(stacked.V, N))


class DeviceTreeSolver:
    """Device-resident hierarchical solver: binary-tree reduction with odd
    carry, every-2nd-map re-gauge, final re-gauge to the first map's frame.

    The reference's parameters in its order. datatype: "stereo" or "mono".
    method: "refine" (the f32-preconditioned f64 PCG; mono with pin "zero":
    the reduced system's f32 factor with `refine_iters` refinement sweeps)
    or "direct" (f64 Cholesky). pin: the mono scale pin of every join,
    "sign" or "zero" (`JoinConfig.pin`). device (keyword-only): where the
    levels run, the card by default; `device="cpu"` runs the kernels'
    plain versions, and a CUDA device with no CUDA raises. Every level
    sums in a fixed order (`ops/segment.deterministic`).
    Iteration bands (method="refine"): joins with fewer than `top_min_m`
    joined poses run `refine_iters` PCG sweeps; larger ones up to
    `top_iters`, with the early exit at `pcg_exit_tol` and `top_iters` more
    sweeps on lanes whose residual exceeds `escalate_tol`. `mixed_max_m`
    runs levels up to that size with f32 information (off by default);
    `direct_min_m` solves levels from that size with a plain f64 Cholesky.
    progress: log each level as it is dispatched.

    mesh (a `parallel/mesh.Mesh` whose first device is `device`, or None):
    each level picks its mode (`_level_mode`): "dp" for a level of at least
    one pair per shard whose re-gauge flags repeat with the shard's lane
    count (the pair lanes are padded with clones of pair 0 to a multiple of
    the mesh, each shard's lanes run the level body on its device, the
    clones are dropped and the odd carry is handled outside); "tp" for a
    count-2 refine level whose join has at least `root_shard_min` poses
    (`shard_solve.sharded_full_mixed`); "rep" for the rest.
    plan_offset, final_regauge: a subtree's global map offset and whether
    its root is the whole tree's (`core/plan.plan_tree_exact`).
    """

    def __init__(self, datatype: str, method: str = "refine",
                 refine_iters: int = 3, bucket: int = 16, u_bucket: int = 64,
                 pin: str = "sign", progress: bool = False,
                 mixed_max_m: int = 0, direct_min_m: int = 0,
                 top_min_m: int = 256, top_iters: int = 16,
                 plan_offset: int = 0, final_regauge: bool = True,
                 mesh=None, root_shard_min: int = 256,
                 escalate_tol: float = 1e-8, pcg_exit_tol: float = 1e-14,
                 *, device="cuda"):
        if datatype not in ("stereo", "mono"):
            raise ValueError(f"datatype must be 'stereo' or 'mono', got "
                             f"{datatype!r}")
        self.datatype = datatype
        self.device = solver_device(device, "DeviceTreeSolver")
        if mesh is not None and canonical(device) != mesh.devices[0]:
            raise ValueError(f"DeviceTreeSolver: device {device} is not the "
                             f"mesh's first device {mesh.devices[0]}")
        self.mesh = mesh
        self._nd = mesh.size if mesh is not None else 0
        self.root_shard_min = root_shard_min
        self.plan_offset = plan_offset
        self.final_regauge = final_regauge
        self.method = method
        self.refine_iters = refine_iters
        self.pin = pin
        self.bucket = bucket
        self.u_bucket = u_bucket
        self.mixed_max_m = mixed_max_m if method == "refine" else 0
        self.direct_min_m = direct_min_m if method == "refine" else 0
        self.top_min_m = top_min_m
        self.top_iters = top_iters
        self.escalate_tol = escalate_tol
        self.pcg_exit_tol = pcg_exit_tol
        self.progress = progress
        self.join_count = 0
        self.last_residuals: dict = {}
        self.last_spans: list[dict] = []
        self._last_timing: dict = {}

    def _cfg(self, joined_m: int) -> join_mod.JoinConfig:
        if joined_m <= self.mixed_max_m:
            return join_mod.JoinConfig(method="direct", pin=self.pin,
                                       dense_schur=True,
                                       info_dtype=torch.float32, with_res=True)
        if self.direct_min_m and joined_m >= self.direct_min_m:
            return join_mod.JoinConfig(method="direct", pin=self.pin,
                                       dense_schur=True,
                                       info_dtype=torch.float64, with_res=True)
        top = joined_m >= self.top_min_m
        return join_mod.JoinConfig(
            method=self.method, pin=self.pin, dense_schur=True,
            refine_iters=self.top_iters if top else self.refine_iters,
            info_dtype=torch.float64, with_res=True,
            escalate_iters=self.top_iters if top else 0,
            escalate_tol=self.escalate_tol,
            exit_tol=self.pcg_exit_tol if top else 0.0)

    # -- building blocks -----------------------------------------------------
    def _merge(self, g: types.LocalMap, m: types.LocalMap, cfg):
        merge = (plevel.merge_one_stereo if self.datatype == "stereo"
                 else plevel.merge_one_mono)
        return merge(g, m, cfg)

    def _regauge_compact(self, lm: types.LocalMap, caps_out, info_dtype):
        """Re-gauge to the final frame + compact, on the lanes the exact plan
        flags (the id comparison ref > fref is decided on the host)."""
        with span("regauge_compact"):
            g = lm.gauge
            if self.datatype == "stereo":
                t = congruence.transform_map_stereo(lm, g.fref,
                                                    info_dtype=info_dtype)
            else:
                t = congruence.transform_map_mono(lm, g.fref, g.fscap,
                                                  g.ffix,
                                                  info_dtype=info_dtype)
            return dcompact.compact_device(t, *caps_out)[0]

    @staticmethod
    def _compact(lm: types.LocalMap, caps_out) -> types.LocalMap:
        """Compact without re-gauge (`dcompact.compact_device`)."""
        with span("regauge_compact"):
            return dcompact.compact_device(lm, *caps_out)[0]

    def _level_cfg(self, lp: plan_mod.LevelPlan) -> join_mod.JoinConfig:
        # exact plans carry the level's true largest join; the bucketed
        # 2 * caps_in[0] is only the count-based fallback
        return self._cfg(lp.join_m if lp.join_m is not None
                         else 2 * lp.caps_in[0])

    def _body(self, x: types.LocalMap, count: int, caps_out, flags, cfg):
        """One tree level's work over `count` stacked lanes; flags are the
        re-gauge booleans of the (count + 1) // 2 output lanes. Returns
        (next level's stacked maps in output order, residual per merged lane
        [count // 2 + count % 2] with the carry last). Also a dp shard's
        body, over its lanes and the shard-uniform flags."""
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
            parts.append(self._compact(types.lanes(merged, idx_nr),
                                       caps_out))
        if idx_rg:
            parts.append(self._regauge_compact(types.lanes(merged, idx_rg),
                                               caps_out, cfg.info_dtype))
        # res stays in merged order (pair i at slot i, carry last)
        return types.lanes(types.cat(parts), perm), res

    def _dp_pattern(self, lp: plan_mod.LevelPlan):
        """The shard-uniform re-gauge flags of a dp level's shard (one per
        local pair), or None if the level cannot split over the pairs.

        The pair lanes are padded with clones of pair 0 to local * nd (the
        joins are lane-independent) and the odd carry stays outside, so any
        count splits once the real pairs' flags repeat with period `local`;
        the every-2nd-output pattern does whenever local is even, so both
        ceil(npair / nd) and its even round-up are tried."""
        if self._nd <= 1 or lp.regauge is None:
            return None
        nd, npair = self._nd, lp.count // 2
        if npair < nd:
            return None
        flags = tuple(bool(f) for f in lp.regauge[:npair])
        base = -(-npair // nd)
        for local in (base, base + (base & 1)):
            cand = (flags * ((local + npair - 1) // npair))[:local]
            if all(flags[i] == cand[i % local] for i in range(npair)):
                return cand
        return None

    def _level_mode(self, lp: plan_mod.LevelPlan, cfg) -> str:
        """The level's mode: dp | tp | rep, or single without a mesh."""
        if self._nd <= 1:
            return "single"
        if self._dp_pattern(lp) is not None:
            return "dp"
        if (lp.count == 2 and lp.regauge is not None
                and (lp.join_m or 0) >= self.root_shard_min
                and cfg.method == "refine"):
            return "tp"
        return "rep"

    def _plan_modes(self, tp: plan_mod.TreePlan) -> list[str]:
        return [self._level_mode(lp, self._level_cfg(lp)) for lp in tp.levels]

    def _level(self, x: types.LocalMap, lp: plan_mod.LevelPlan):
        """One tree level over `lp.count` stacked lanes on the solver's
        device, in its mode; returns what `_body` returns (the fixed order
        is `run`'s: a caller of this alone enters `segment.deterministic()`
        itself)."""
        cfg = self._level_cfg(lp)
        mode = self._level_mode(lp, cfg)
        if mode == "dp":
            return self._level_dp(x, lp, cfg)
        if mode == "tp":
            return self._level_tp(x, lp, cfg)
        return self._body(x, lp.count, lp.caps_out, lp.regauge, cfg)

    def _level_dp(self, x: types.LocalMap, lp: plan_mod.LevelPlan, cfg):
        """The level's pairs split over the mesh: shard d runs the body on
        lanes [2 local d, 2 local (d + 1)) of the clone-padded pair stack on
        its device; the outputs come back to the first device in shard
        order, the clones are dropped, and the odd carry is compacted (and
        re-gauged if flagged) there."""
        mesh, nd = self.mesh, self._nd
        count, caps_out = lp.count, lp.caps_out
        npair = count // 2
        cand = self._dp_pattern(lp)
        local = len(cand)
        pad = local * nd - npair
        xp = types.lanes(x, slice(0, 2 * npair))
        if pad:
            xp = types.cat([xp] + [types.lanes(x, slice(0, 2))] * pad)
        outs, ress = [], []
        for d, dev in enumerate(mesh.devices):
            with mesh.on(d):
                shard = types.map_fields(
                    types.lanes(xp, slice(2 * local * d, 2 * local * (d + 1))),
                    lambda a, dev=dev: a.to(dev))
                out, res = self._body(shard, 2 * local, caps_out, cand, cfg)
            outs.append(types.map_fields(out, lambda a: a.to(self.device)))
            ress.append(res.to(self.device))
            del shard, out, res
        out, res = types.cat(outs), torch.cat(ress)
        if pad:
            out, res = types.lanes(out, slice(0, npair)), res[:npair]
        if count % 2 == 1:
            idt = cfg.info_dtype
            carry = pad_to_device(types.lanes(x, slice(count - 1, count)),
                                  *caps_out)
            carry = dataclasses.replace(carry, U=carry.U.to(idt),
                                        W=carry.W.to(idt), V=carry.V.to(idt))
            c = (self._regauge_compact(carry, caps_out, idt)
                 if lp.regauge[npair] else self._compact(carry, caps_out))
            out = types.cat([out, c])
            res = torch.cat([res, res.new_zeros(1)])
        return out, res

    def _level_tp(self, x: types.LocalMap, lp: plan_mod.LevelPlan, cfg):
        """The count-2 root-style level: its one join solved with the
        feature axis sharded over the mesh (`JoinConfig.mesh`); the
        transform and the compaction run on the first device."""
        cfg = cfg._replace(mesh=self.mesh, mesh_axis=self.mesh.axis)
        merged, res = self._merge(types.lanes(x, slice(0, 1)),
                                  types.lanes(x, slice(1, 2)), cfg)
        out = (self._regauge_compact(merged, lp.caps_out, cfg.info_dtype)
               if lp.regauge[0] else self._compact(merged, lp.caps_out))
        return out, res

    def _final(self, x: types.LocalMap, caps, need: bool) -> types.LocalMap:
        with span("final"):
            root = types.lanes(x, slice(0, 1))
            out = (self._regauge_compact(root, caps, torch.float64) if need
                   else self._compact(root, caps))
            dt = out.poses.dtype
            out = dataclasses.replace(out, U=out.U.to(dt), W=out.W.to(dt),
                                      V=out.V.to(dt))
            return types.lanes(out, 0)

    # -- full tree -----------------------------------------------------------
    def _plan(self, stacked: types.LocalMap) -> plan_mod.TreePlan:
        """The exact tree plan of the compacted host stack."""
        with span("plan_tree"):
            return plan_mod.plan_tree_exact(
                plan_mod.sym_of_stacked(stacked), self.datatype, self.bucket,
                self.u_bucket, map_offset=self.plan_offset,
                final_regauge=self.final_regauge)

    def prepare(self, maps: list):
        """(tree plan, level 1's input): what `run` builds before its first
        level — the maps compacted, planned and, padded to level 1's input
        caps, lane-stacked on the solver's device (the profiling tools run
        and time levels on it with `_level`)."""
        stacked = compact_mod.compact_stack(maps, self.bucket, self.u_bucket)
        tp = self._plan(stacked)
        if tp:
            stacked = _grow_stacked(stacked, *tp.levels[0].caps_in)
        return tp, types.to_torch(stacked, self.device)

    def run(self, maps: list, metrics=None, ckpt_dir: str | None = None,
            resume: bool = False,
            time_levels: bool = False) -> types.LocalMap:
        """Solve the tree over `maps` (objects `types.host_fields` accepts)
        and return the root map on the solver's device.

        ckpt_dir: save every level boundary there (`stacked_level<L>.npz`);
        resume: restart from its newest one, when its shape is the plan's
        (the plan is rebuilt from `maps`, so they must be the same maps),
        else warn and start over. time_levels: record each level's device
        wall into the metrics records (`exec_wall`, seconds). Runs under
        `segment.deterministic()`: two runs give the same bits.

        Each run records its spans (`utils/metrics`): `ingest_plan` (with
        `plan_tree`), `upload`, and `levels`, which holds one `level` per
        plan level (attributes: level, count, join_m, mode, device_wall
        [s], memory_allocated at its end [bytes, on a card]) with its
        `transform`, `join` (attributes: the PCG's sweeps and escalations)
        and `regauge_compact` spans, then `final` and the closing `sync`;
        a `sync` spans each blocking read of the PCG, and a mono join's
        `mono_gauge` what the mono gauge adds before its solve, and a
        `schur_f64` each float64 Schur assembly inside a join (attributes:
        P, M, N, KU, KW, device_wall [s]). Afterwards
        `last_spans` holds them, and `_last_timing` (a new flat dict of
        numbers) the host phases compact, plan, upload, levels (to the
        synchronise) and get [s], the self seconds of the spans in
        SELF_TIMED, schur_f64_s (the `schur_f64` spans' device walls
        summed) and schur_f64_ku / _kw / _m / _n / _m2 (KU, KW, M, N and
        M squared summed over those spans' lanes; all 0 on a solve that
        forms none, as the PCG levels of method refine do), and
        the solve's counts: pcg_sweeps, pcg_escalations,
        syncs, k1/k2/k3/k4/k5_launches (`kernels.launches`; K5: one per
        gauge transform on the card), k3_plans and k3_plan_hits
        (`segment._plan`)."""
        # the JAX package gives the same bits on every run, where the
        # card's atomic sums moved direct mono's poses by up to 1.1e-5 and
        # grid mono's by O(1) from run to run; the scope sums in list order
        # through kernel K3 (`ops/segment`), on every method and data type
        # (PERF.md §6 for what the fixed order costs; ROADMAP queue 3 for
        # grid mono, whose data amplify rounding)
        with segment.deterministic():
            return self._run(maps, metrics, ckpt_dir, resume, time_levels)

    def _run(self, maps, metrics, ckpt_dir, resume, time_levels):
        launched = dict(kernels.launches)
        with recording() as rec:
            t0 = time.perf_counter()
            with span("ingest_plan"):
                stacked = compact_mod.compact_stack(maps, self.bucket,
                                                    self.u_bucket)
                t1 = time.perf_counter()
                tp = self._plan(stacked)
                start_level = 0
                if tp:
                    stacked = _grow_stacked(stacked, *tp.levels[0].caps_in)
                    if resume and ckpt_dir:
                        stacked, start_level = self._resumed(tp, stacked,
                                                             ckpt_dir)
            t2 = time.perf_counter()
            with span("upload"):
                x = types.to_torch(stacked, self.device)
            t3 = time.perf_counter()
            cuda = self.device.type == "cuda"
            level_spans, res_per_level = [], {}
            with span("levels"):
                for li, lp in enumerate(tp.levels[start_level:] if tp else (),
                                        start=start_level):
                    with device_span(
                            "level", self.device, level=li + 1,
                            count=lp.count, join_m=lp.join_m,
                            mode=self._level_mode(lp, self._level_cfg(lp))
                    ) as sp:
                        x, res = self._level(x, lp)
                        # memory_allocated's value without its flattening
                        # of every statistic (about 100 us a call)
                        sp["attrs"]["memory_allocated"] = (
                            torch.cuda.memory_stats_as_nested_dict(
                                self.device)["allocated_bytes"]["all"][
                                "current"] if cuda else None)
                    level_spans.append(sp)
                    res_per_level[li + 1] = res
                    if ckpt_dir:
                        checkpoint.save_stacked(ckpt_dir, li + 1, x)
                    self.join_count += lp.count // 2
                    if metrics is not None:
                        metrics.record(li + 1, (lp.count + 1) // 2,
                                       lp.count // 2, M=lp.caps_out[0],
                                       N=lp.caps_out[1], join_m=lp.join_m,
                                       wall=round(time.perf_counter() - t0, 4))
                    if self.progress:
                        log.info("Level %d dispatched (%d maps)", li + 1,
                                 (lp.count + 1) // 2)
                y = (self._final(x, tp.root_caps, tp.root_regauge) if tp
                     else types.lanes(x, 0))
                with span("sync"):
                    if cuda:
                        torch.cuda.synchronize(self.device)
            t4 = time.perf_counter()
        # the device walls of the level and schur_f64 spans, read after the
        # synchronise
        read_device_walls(rec.spans)
        # per-level PCG residuals, read once after the tree
        self.last_residuals = {lv: r.cpu().numpy()
                               for lv, r in res_per_level.items()}
        if metrics is not None:
            by_level = {r["level"]: r for r in metrics.records}
            for lv, r in self.last_residuals.items():
                if lv not in by_level:
                    continue
                if r.size:
                    # max, not nanmax: a NaN lane must show in res_max
                    with np.errstate(invalid="ignore"):
                        by_level[lv]["res_max"] = float(np.max(r))
            if time_levels:
                for sp in level_spans:
                    by_level[sp["attrs"]["level"]]["exec_wall"] = (
                        sp["attrs"]["device_wall"])
        self.last_spans = rec.spans
        own = self_seconds(rec.spans)
        n = rec.counts
        f64 = [sp["attrs"] for sp in rec.spans if sp["name"] == "schur_f64"]

        def lanes(key, power=1):
            """A `schur_f64` attribute (to `power`) summed over the lanes
            of the solve's float64 Schur assemblies."""
            return sum(a["P"] * a[key] ** power for a in f64)
        self._last_timing = dict(
            compact=t1 - t0, plan=t2 - t1, upload=t3 - t2, levels=t4 - t3,
            **{k: own.get(k, 0.0) for k in SELF_TIMED},
            schur_f64_s=sum(a["device_wall"] for a in f64),
            schur_f64_ku=lanes("KU"), schur_f64_kw=lanes("KW"),
            schur_f64_m=lanes("M"), schur_f64_n=lanes("N"),
            schur_f64_m2=lanes("M", 2),
            pcg_sweeps=n.get("pcg_sweeps", 0),
            pcg_escalations=n.get("pcg_escalations", 0),
            syncs=sum(1 for sp in rec.spans if sp["name"] == "sync"),
            k1_launches=kernels.launches["blockcoo_to_dense"]
            - launched["blockcoo_to_dense"],
            k2_launches=kernels.launches["inv3x3_sym"]
            - launched["inv3x3_sym"],
            k3_launches=kernels.launches["seg_sum_fixed"]
            - launched["seg_sum_fixed"],
            k4_launches=kernels.launches["schur_pairs"]
            - launched["schur_pairs"],
            k5_launches=kernels.launches["gauge_congruence"]
            - launched["gauge_congruence"],
            k3_plans=n.get("k3_plans", 0),
            k3_plan_hits=n.get("k3_plan_hits", 0),
            get=time.perf_counter() - t4)
        return y

    def _resumed(self, tp: plan_mod.TreePlan, stacked, ckpt_dir: str):
        """(stack, first level to run): the newest checkpoint in ckpt_dir
        when its shape is the plan's, else (stacked, 0) with a warning."""
        got = checkpoint.latest_stacked(ckpt_dir)
        if got is None:
            return stacked, 0
        lvl, st = got
        plans = tp.levels
        want = ((plans[lvl].count, plans[lvl].caps_in[0])
                if lvl < len(plans) else
                ((plans[-1].count + 1) // 2, plans[-1].caps_out[0]))
        if st.pose_ids.shape == want:
            log.info("resuming at level %d from %s", lvl, ckpt_dir)
            return st, lvl
        log.warning("checkpoint shape %s mismatches plan %s; restarting",
                    st.pose_ids.shape, want)
        return stacked, 0
