"""Planned dense executor: host-planned layouts, dense level passes.

Counterpart of `linearsfm_tpu/core/dense_tree.py`, the third executor next
to core/tree.py (host-driven) and core/device_tree.py (device-resident block
lists), with the same scheduler semantics (lmj_PF3D_Divide_ConquerStereo/
Mono, LinearSFMImp.cpp:1926-2099, :6511-6658), but:

* All id/slot bookkeeping — feature matching (:2575-2599), pose
  identification (:7383-7409), re-gauge decisions (:1997), compaction — is
  planned on the host by core/layout.py: the tree schedule is a pure
  function of the input ids.
* Maps travel as dense block tensors (ops/dense.DenseMap), one lane per map
  of a level; a level is einsums, scatters into the joined layout with
  host-planned indices, and Cholesky solves. The device sees no sort,
  searchsorted or id search.

The level-0 maps are densified on the device from their block lists by
kernel K1 (`schur.densify_blocks`), every run; each join's V^-1 and Y = W
V^-1 come from one launch of kernel K2 (`ops/dense.solve_dense`).

Memory is O(M^2 + M N) blocks per map instead of O(nnz): at the 2,048-map
root the float64 Wd alone is 3.45 GB.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .. import types
from ..ops import dense as D
from ..ops import schur
from ..ops.rotations import wrap_angle_diff, wrap_angle_pi
from ..ops.segment import put1, take1
from ..parallel.mesh import solver_device
from . import compact as compact_mod
from . import layout as L

log = logging.getLogger("linearsfm_tpu_torch")


class LevelTimer:
    """Per-level device walls: CUDA events on a GPU (read after the final
    synchronise, so timing does not stall the pipeline), the spans' host
    clock (`utils/metrics`) on the CPU, where every operation is
    synchronous. The executor marks each level boundary."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter_ns() * 1e-9)

    def walls(self) -> list[float]:
        """Seconds between consecutive marks."""
        if self.cuda:
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


# ---------------------------------------------------------------------------
# scatters into the joined layout (a source slot with no destination, -1,
# goes to a dummy row that is sliced off)
# ---------------------------------------------------------------------------

def _inverse(src: np.ndarray, cap_in: int) -> np.ndarray:
    """Per lane, the destination slot of each source slot: the inverse of
    the planner's source maps src [P, C] (-1 = none)."""
    dst = np.full((src.shape[0], cap_in), -1, np.int64)
    lane, o = np.nonzero(src >= 0)
    dst[lane, src[lane, o]] = o
    return dst


def _scatter(out: torch.Tensor, idx: torch.Tensor, src: torch.Tensor):
    """out[idx[k]] += src rows, out [R + 1, w] with row R the dummy."""
    dummy = out.shape[0] - 1
    out.index_add_(0, torch.where(idx >= 0, idx, dummy).reshape(-1),
                   src.reshape(-1, out.shape[1]))


def _join_scatter(sources, Mo: int, No: int, dtype):
    """(A, Wd, V, eP, eF) of the joined layout [P, Mo, ...] from the two
    sources' (A, Wd, V, eP, eF, dP, dF): dP [P, Mi] and dF [P, Ni] give each
    source slot's joint slot (-1 = none); a joint slot fed by both sums
    them, by none stays zero."""
    A0, W0 = sources[0][0], sources[0][1]
    P, Mi, Ni = W0.shape[:3]
    dev = A0.device
    lane = torch.arange(P, device=dev)
    r6 = torch.arange(6, device=dev)
    A = A0.new_zeros((P * Mo * 6 * Mo + 1, 6), dtype=dtype)
    Wd = A0.new_zeros((P * Mo * No + 1, 18), dtype=dtype)
    V = A0.new_zeros((P * No + 1, 9), dtype=dtype)
    eP = A0.new_zeros((P * Mo + 1, 6), dtype=dtype)
    eF = A0.new_zeros((P * No + 1, 3), dtype=dtype)
    for sA, sW, sV, seP, seF, dP, dF in sources:
        row = torch.where(dP >= 0, lane[:, None] * Mo + dP, -1)    # [P, Mi]
        fcol = torch.where(dF >= 0, lane[:, None] * No + dF, -1)   # [P, Ni]
        ia = (row[:, :, None] * 6 + r6) * Mo             # [P, Mi, 6]
        ok = (row >= 0)[:, :, None, None] & (dP >= 0)[:, None, None, :]
        _scatter(A, torch.where(ok, ia[..., None] + dP[:, None, None, :], -1),
                 sA)
        okw = (row >= 0)[:, :, None] & (dF >= 0)[:, None, :]
        _scatter(Wd, torch.where(okw, row[:, :, None] * No + dF[:, None, :],
                                 -1), sW)
        _scatter(V, fcol, sV)
        _scatter(eP, row, seP)
        _scatter(eF, fcol, seF)
    return (A[:-1].view(P, Mo, 6, Mo, 6), Wd[:-1].view(P, Mo, No, 6, 3),
            V[:-1].view(P, No, 3, 3), eP[:-1].view(P, Mo, 6),
            eF[:-1].view(P, No, 3))


def _zero_pose(A: torch.Tensor, Wd: torch.Tensor, slot: torch.Tensor):
    """(A, Wd) with the row and column blocks of pose `slot` [P] zeroed in
    each lane, in place."""
    lane = torch.arange(A.shape[0], device=A.device)
    A[lane, slot] = 0.0
    A[lane, :, :, slot] = 0.0
    Wd[lane, slot] = 0.0
    return A, Wd


def _put_angles(poses: torch.Tensor, slot: torch.Tensor, ang: torch.Tensor):
    """Copy of poses [P, M, 6] with the angles of pose `slot` [P] set to
    ang [P, 3]."""
    return put1(poses, slot, torch.cat([take1(poses, slot)[:, 0:3], ang], -1))


def densify(lm, Mc: int, Nc: int):
    """Host: one map's block lists (any object `types.host_fields` accepts)
    -> dense (A, Wd, V) float64 numpy arrays at caps (Mc, Nc)."""
    lm = types.host_fields(lm)
    n = int(lm.n_feats)
    nU, nW = int(lm.n_U), int(lm.n_W)
    A = np.zeros((Mc, 6, Mc, 6))
    Wd = np.zeros((Mc, Nc, 6, 3))
    V = np.zeros((Nc, 3, 3))
    U, Uij = lm.U[:nU], lm.Uij[:nU]
    Wb, Wpf = lm.W[:nW], lm.Wpf[:nW]
    r6 = np.arange(6)
    i, j = Uij[:, 0], Uij[:, 1]
    ii = np.broadcast_to(i[:, None, None], (nU, 6, 6))
    jj = np.broadcast_to(j[:, None, None], (nU, 6, 6))
    aa = np.broadcast_to(r6[None, :, None], (nU, 6, 6))
    bb = np.broadcast_to(r6[None, None, :], (nU, 6, 6))
    np.add.at(A, (ii, aa, jj, bb), U)
    offd = (i != j)[:, None, None]
    np.add.at(A, (jj, bb, ii, aa), np.where(offd, U, 0.0))
    p, f = Wpf[:, 0], Wpf[:, 1]
    pp = np.broadcast_to(p[:, None, None], (nW, 6, 3))
    ff = np.broadcast_to(f[:, None, None], (nW, 6, 3))
    wa = np.broadcast_to(r6[None, :, None], (nW, 6, 3))
    wc = np.broadcast_to(np.arange(3)[None, None, :], (nW, 6, 3))
    np.add.at(Wd, (pp, ff, wa, wc), Wb)
    V[:n] = lm.V[:n]
    return A, Wd, V


class DenseTreeSolver:
    """Hierarchical solver on the dense planned path.

    Matches TreeSolver/DeviceTreeSolver numerically (method="direct", f64).
    method="refine" applies the JAX package's mixed-precision policy: f32
    information at tree levels whose joined width is <= mixed_max_m poses
    (a plain f32 solve), f64 information and an f32 factor with
    `refine_iters` refinement sweeps above.

    device (keyword-only): where the levels run, the card by default;
    `device="cpu"` for the CPU; a CUDA device with no CUDA raises.
    fuse: the levels of at most `fuse_max_count` maps (the tail of the
    tree) are recorded in the metrics as one fused pass sharing one wall,
    as the JAX package compiles them into one program; eager PyTorch runs
    every level alike.

    Unlike the other two executors it does not enter the fixed-order
    scope (`ops/segment.deterministic`), and runs no K3: its only
    accumulating scatter (`_scatter`, `index_add_`) adds at most one value
    to each row but the dropped dummy row, since the planner gives each
    joint slot at most one source slot per lane, so its sums repeat
    bit for bit in any order.
    """

    def __init__(self, datatype: str, method: str = "refine",
                 refine_iters: int = 3, bucket: int = 16,
                 mixed_max_m: int = 32, progress: bool = False,
                 fuse: bool = True, *, device="cuda"):
        if datatype not in ("stereo", "mono"):
            raise ValueError(f"datatype must be 'stereo' or 'mono', got "
                             f"{datatype!r}")
        self.datatype = datatype
        self.device = solver_device(device, "DenseTreeSolver")
        self.method = method
        self.refine_iters = refine_iters
        self.bucket = bucket
        self.mixed_max_m = mixed_max_m if method == "refine" else 0
        self.progress = progress
        self.fuse = fuse
        self.fuse_max_count = 64
        self.join_count = 0
        self._prep_maps = None
        self._prep = None
        self._last_timing: dict = {}
        self._last_dense = None

    def _policy(self, joined_m: int):
        """(information dtype, solve method) of a level whose joined width
        is `joined_m` (the pre-dedup 2 * caps_in[0], the device executor's
        key)."""
        if joined_m <= self.mixed_max_m:
            return torch.float32, "direct"
        return torch.float64, (self.method if self.method == "refine"
                               else "direct")

    # -- the pairwise joins of a level, all lanes at once ---------------------
    def _join(self, g: D.DenseMap, m: D.DenseMap, b: dict, idt, method,
              caps_out) -> D.DenseMap:
        slots = b["slots"]
        if self.datatype == "stereo":
            gt = D.transform_dense_stereo(g, slots[:, 0], info_dtype=idt)
            gA, gW = gt.A, gt.Wd
            mA, mW = m.A.to(idt), m.Wd.to(idt)
            m_poses = m.poses
            fixc = sign = None
        else:
            rs, ss, p1, p2, ofix, nfix, cref, cscap = slots.unbind(1)
            gt = D.transform_dense_mono(g, rs, ss, p1, p2, ofix, nfix,
                                        info_dtype=idt)
            # angle wraparound on the scale-pose blocks (:7427-7465)
            ang = wrap_angle_pi(take1(gt.poses, p2)[:, 3:6])
            gt = gt._replace(poses=_put_angles(gt.poses, p2, ang))
            m_ang = wrap_angle_diff(
                wrap_angle_pi(take1(m.poses, cscap)[:, 3:6]), ang)
            m_poses = _put_angles(m.poses, cscap, m_ang)
            # zero-information joint-reference blocks dropped (:7482, :7619)
            gA, gW = _zero_pose(gt.A, gt.Wd, p1)
            mA, mW = _zero_pose(m.A.to(idt, copy=True),
                                m.Wd.to(idt, copy=True), cref)
            fixc = 6 * p2 + nfix
            sign = gt.sign.to(idt)
        mV = m.V.to(idt)

        ePg, eFg = D.info_vector_dense(gt._replace(A=gA, Wd=gW), idt)
        ePm, eFm = D.info_vector_dense(
            D.DenseMap(m_poses, m.feats, mA, mW, mV, m.sign), idt)
        A, Wd, V, eP, eF = _join_scatter(
            [(gA, gW, gt.V, ePg, eFg, b["dPg"], b["dFg"]),
             (mA, mW, mV, ePm, eFm, b["dPm"], b["dFm"])],
            *caps_out, idt)
        del gt, gA, gW, mA, mW, mV   # the joint system replaces them
        xp, xf = D.solve_dense(A, Wd, V, eP, eF, b["fixed"], method=method,
                               refine_iters=self.refine_iters, fixc=fixc,
                               sign=sign, pairs=b["pairs"])
        sdt = g.poses.dtype
        return D.DenseMap(xp.to(sdt), xf.to(sdt), A, Wd, V, m.sign.to(sdt))

    def _regauge(self, dm: D.DenseMap, slots: torch.Tensor, idt):
        if self.datatype == "stereo":
            return D.transform_dense_stereo(dm, slots[:, 0], info_dtype=idt)
        return D.transform_dense_mono(dm, *slots.unbind(1), info_dtype=idt)

    # -- one tree level ------------------------------------------------------
    def _level(self, lp: L.DenseLevelPlan, x: D.DenseMap,
               b: dict) -> D.DenseMap:
        # policy keyed on the pre-dedup joined width (= DeviceTreeSolver's
        # key) so both executors assign the same levels to f32
        idt, method = self._policy(2 * lp.caps_in[0])
        count = lp.count
        npair, nxt = count // 2, (count + 1) // 2
        Mo, No = lp.caps_out
        idx_rg = [i for i in range(nxt) if lp.regauge[i]]
        idx_nr = [i for i in range(nxt) if not lp.regauge[i]]

        merged = self._join(x.lanes(slice(0, 2 * npair, 2)),
                            x.lanes(slice(1, 2 * npair, 2)), b, idt, method,
                            lp.caps_out)
        if count % 2 == 1:
            c = x.lanes(slice(count - 1, count))
            dM, dN = Mo - c.M, No - c.N
            carry = D.DenseMap(
                torch.nn.functional.pad(c.poses, (0, 0, 0, dM)),
                torch.nn.functional.pad(c.feats, (0, 0, 0, dN)),
                torch.nn.functional.pad(c.A, (0, 0, 0, dM, 0, 0, 0, dM)
                                        ).to(idt),
                torch.nn.functional.pad(c.Wd, (0, 0, 0, 0, 0, dN, 0, dM)
                                        ).to(idt),
                torch.nn.functional.pad(c.V, (0, 0, 0, 0, 0, dN)).to(idt),
                c.sign)
            merged = D.DenseMap.cat([merged, carry])
        if not idx_rg:
            return merged
        parts = [merged.lanes(idx_nr)] if idx_nr else []
        parts.append(self._regauge(merged.lanes(idx_rg), b["rg_slots"], idt))
        perm = np.argsort(np.array(idx_nr + idx_rg)).tolist()
        out = D.DenseMap.cat(parts)
        return out if perm == sorted(perm) else out.lanes(perm)

    def _final(self, x: D.DenseMap, plan: L.DenseTreePlan) -> D.DenseMap:
        root = D.DenseMap(*(t[0:1].to(torch.float64) for t in x))
        if plan.root_regauge:
            slots = torch.as_tensor(np.asarray(plan.root_slots, np.int64),
                                    device=self.device)[None]
            root = self._regauge(root, slots, torch.float64)
        return root

    # -- host prep: plan and the level bundles (cached per maps-list) --------
    def _bundle(self, lp: L.DenseLevelPlan) -> dict:
        """The level's planned indices on the device: per pair lane the
        destination of every source slot (dPg/dPm [P, Mi], dFg/dFm [P, Ni]),
        the gauge-fixed coordinates of the joint system (fixed [P, 6Mo]),
        the transform slots, the re-gauge lanes' slots, and K2's pair list
        of the joint Wd (`ops/dense.entry_pairs`)."""
        Mi, Ni = lp.caps_in
        Mo, No = lp.caps_out
        bd = lp.bundle
        valid = (bd["gsrcP"] >= 0) | (bd["msrcP"] >= 0)
        fixed = ~np.repeat(valid, 6, axis=1)
        slots = bd["slots"].astype(np.int64)
        if self.datatype == "mono":
            coord = np.arange(6 * Mo)[None]
            p1 = slots[:, 2:3]
            fixed |= (coord >= 6 * p1) & (coord < 6 * p1 + 6)
            fixed |= coord == 6 * slots[:, 3:4] + slots[:, 5:6]
        rg = (lp.rg_bundle["slots"] if lp.rg_bundle is not None
              else np.zeros((0, 1), np.int32))
        host = dict(dPg=_inverse(bd["gsrcP"], Mi),
                    dPm=_inverse(bd["msrcP"], Mi),
                    dFg=_inverse(bd["gsrcF"], Ni),
                    dFm=_inverse(bd["msrcF"], Ni),
                    fixed=fixed, slots=slots, rg_slots=rg.astype(np.int64))
        dev = {k: torch.as_tensor(v).to(self.device) for k, v in host.items()}
        dev["pairs"] = D.entry_pairs(lp.count // 2, Mo, No, self.device)
        return dev

    def _prepare(self, maps: list):
        if self._prep_maps is maps:
            return self._prep
        st = compact_mod.compact_stack(maps, self.bucket, 1)
        g = st.gauge
        layouts = []
        for b in range(st.pose_ids.shape[0]):
            pid, fid = st.pose_ids[b], st.feat_ids[b]
            layouts.append(L.NodeLayout(
                pose_ids=pid[pid >= 0].astype(np.int32),
                feat_ids=fid[fid >= 0].astype(np.int32),
                ref=int(g.ref[b]), scap=int(g.scap[b]), fix=int(g.fix[b]),
                fref=int(g.fref[b]), fscap=int(g.fscap[b]),
                ffix=int(g.ffix[b])))
        plan = L.plan_dense_tree(layouts, self.datatype, self.bucket)
        bundles = [self._bundle(lp) for lp in plan.levels]
        self._prep = (plan, st, layouts, bundles)
        self._prep_maps = maps
        return self._prep

    def _upload(self, st: types.LocalMap, plan: L.DenseTreePlan) -> D.DenseMap:
        """The stacked maps on the device as dense maps at the level-0 caps,
        in the level-0 policy dtype: A from U at (i, j) plus U^T at (j, i)
        off the diagonal, and Wd, densified by kernel K1 (list padding
        skipped); the states in float64."""
        Mi, Ni = plan.levels[0].caps_in
        B, Ms = st.pose_ids.shape
        Ns = st.feat_ids.shape[1]
        assert Ms <= Mi and Ns <= Ni, (Ms, Ns, plan.levels[0].caps_in)
        idt0, _ = self._policy(2 * Mi)
        dev = self.device

        def up(a, dtype=None):
            t = torch.as_tensor(np.asarray(a)).to(dev)
            return t if dtype is None else t.to(dtype)
        U, W = up(st.U, idt0), up(st.W, idt0)
        Uij, Wpf = up(st.Uij, torch.int64), up(st.Wpf, torch.int64)
        ui, uj = Uij[..., 0], Uij[..., 1]
        inU = (torch.arange(U.shape[1], device=dev)
               < up(st.n_U, torch.int64)[:, None])
        inW = (torch.arange(W.shape[1], device=dev)
               < up(st.n_W, torch.int64)[:, None])
        A = schur.densify_blocks(torch.where(inU, ui, -1), uj, U, Mi, Mi)
        A += schur.densify_blocks(torch.where(inU & (ui != uj), uj, -1), ui,
                                  U.mT.contiguous(), Mi, Mi)
        Wd = schur.densify_blocks(torch.where(inW, Wpf[..., 0], -1),
                                  Wpf[..., 1], W, Mi, Ni)
        Wd = Wd.view(B, Mi, 6, Ni, 3).permute(0, 1, 3, 2, 4).contiguous()
        f64 = torch.float64
        poses = torch.zeros((B, Mi, 6), dtype=f64, device=dev)
        feats = torch.zeros((B, Ni, 3), dtype=f64, device=dev)
        V = torch.zeros((B, Ni, 3, 3), dtype=idt0, device=dev)
        poses[:, :Ms] = up(st.poses, f64)
        feats[:, :Ns] = up(st.feats, f64)
        V[:, :Ns] = up(st.V, idt0)
        return D.DenseMap(poses, feats, A.view(B, Mi, 6, Mi, 6), Wd, V,
                          up(st.gauge.sign, f64))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- full tree -----------------------------------------------------------
    def run(self, maps: list, metrics=None,
            time_levels: bool = False) -> types.LocalMap:
        """Solve the tree over `maps` (objects `types.host_fields` accepts);
        returns the root as a host-form map whose information lists are
        empty (the dense information stays in `_last_dense`).

        time_levels: record each level's device wall into the metrics
        records (`exec_wall`, seconds). `_last_timing`: prep (compaction,
        plan and level indices, cached per maps list), upload (the copy to
        the device and K1's densify), levels, get (the states to the
        host)."""
        t0 = time.perf_counter()
        plan, st, layouts, bundles = self._prepare(maps)
        t1 = time.perf_counter()
        if not plan.levels:
            return compact_mod.compact(maps[0], 1, 1)
        x = self._upload(st, plan)
        self._sync()
        t2 = time.perf_counter()
        lps = plan.levels
        ntail = (sum(1 for lp in lps if lp.count <= self.fuse_max_count)
                 if self.fuse else 0)
        nhead = len(lps) - ntail
        timer = LevelTimer(self.device)
        recs = []
        for li, (lp, b) in enumerate(zip(lps, bundles)):
            if time_levels:
                timer.mark()
            x = self._level(lp, x, b)
            self.join_count += lp.count // 2
            recs.append(dict(level=li + 1, n_maps=(lp.count + 1) // 2,
                             n_joins=lp.count // 2, M=lp.caps_out[0],
                             N=lp.caps_out[1],
                             wall=round(time.perf_counter() - t0, 4)))
            if li >= nhead:
                recs[-1]["fused"] = True
            if self.progress:
                log.info("Level %d dispatched (%d maps)", li + 1,
                         (lp.count + 1) // 2)
        if time_levels:
            timer.mark()
        y = self._final(x, plan)
        self._sync()
        t3 = time.perf_counter()
        poses = y.poses[0].cpu().numpy()
        feats = y.feats[0].cpu().numpy()
        t4 = time.perf_counter()
        if metrics is not None:
            walls = timer.walls() if time_levels else []
            for k, r in enumerate(recs):
                if r.get("fused"):
                    # the fused tail shares its last level's wall
                    r["wall"] = recs[-1]["wall"]
                if walls:
                    r["exec_wall"] = walls[k]
                metrics.record(r.pop("level"), r.pop("n_maps"),
                               r.pop("n_joins"), **r)
        self._last_timing = dict(prep=t1 - t0, upload=t2 - t1,
                                 levels=t3 - t2, get=t4 - t3)
        self._last_dense = y
        root = plan.root
        M, N = poses.shape[0], feats.shape[0]
        pose_ids = np.full(M, -1, np.int32)
        pose_ids[:root.m] = root.pose_ids
        feat_ids = np.full(N, -1, np.int32)
        feat_ids[:root.n] = root.feat_ids
        gauge = types.Gauge(
            np.int32(root.ref), np.int32(root.scap), np.int32(root.fix),
            np.int32(1), np.int32(root.fref), np.int32(root.fscap),
            np.int32(root.ffix))
        z6 = np.zeros((1, 6, 6))
        return types.LocalMap(
            pose_ids=pose_ids, poses=poses, feat_ids=feat_ids, feats=feats,
            U=z6, Uij=np.zeros((1, 2), np.int32), W=np.zeros((1, 6, 3)),
            Wpf=np.zeros((1, 2), np.int32), V=np.zeros((N, 3, 3)),
            n_poses=np.int32(root.m), n_feats=np.int32(root.n),
            n_U=np.int32(0), n_W=np.int32(0), gauge=gauge)
