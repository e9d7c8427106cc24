"""Host-side layout planner for the dense planned executor (core/dense_tree.py).

Counterpart of `linearsfm_tpu/core/layout.py`, in numpy. The merge tree's
combinatorial structure — which pose/feature ids each node holds, in which
slot, which slot is a gauge pose, which output positions re-gauge — is a
pure function of the input ids and the schedule (lmj_PF3D_Divide_Conquer*,
LinearSFMImp.cpp:1926-2099, :6511-6658; the re-gauge condition ``ref >
fref`` at :1997 is an id comparison). This module simulates it once on the
host and emits, per tree level, the slot maps and gauge slots the device
needs; the device then only gathers and scatters with host-planned indices
(see ops/dense.py for the value algebra).

Layout conventions (all exact-size, padding added only at device caps):

* transform: slots unchanged; stereo re-tags the new-reference slot to the
  old reference id (LinearSFMImp.cpp:416-417).
* join output poses = [all G slots | M slots] (stereo), or
  [all G slots | M slots minus its ref/scap] (mono pose identification,
  m = m1 + m2 - 2, :7348).
* join output feats = [G feats | M feats not shared with G, in M order].
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import types


@dataclasses.dataclass
class NodeLayout:
    """Ordered id-space shadow of one tree node."""
    pose_ids: np.ndarray   # int32[m] exact
    feat_ids: np.ndarray   # int32[n] exact
    ref: int
    scap: int              # -1 stereo
    fix: int               # -1 stereo
    fref: int
    fscap: int
    ffix: int

    @property
    def m(self) -> int:
        return len(self.pose_ids)

    @property
    def n(self) -> int:
        return len(self.feat_ids)

    def pose_slot(self, pid: int) -> int:
        w = np.nonzero(self.pose_ids == pid)[0]
        if len(w) != 1:
            raise ValueError(f"pose id {pid} not unique in layout: {w}")
        return int(w[0])


def layout_of(lm) -> NodeLayout:
    """Layout of one map (any object `types.host_fields` accepts; its valid
    slots must be front-compacted)."""
    h = types.host_fields(lm)
    pid, fid, g = h.pose_ids, h.feat_ids, h.gauge
    return NodeLayout(
        pose_ids=pid[pid >= 0].astype(np.int32),
        feat_ids=fid[fid >= 0].astype(np.int32),
        ref=int(g.ref), scap=int(g.scap), fix=int(g.fix),
        fref=int(g.fref), fscap=int(g.fscap), ffix=int(g.ffix))


# ---------------------------------------------------------------------------
# Layout-space operations (mirror ops/dense transforms + the join)
# ---------------------------------------------------------------------------

def transform_layout(nl: NodeLayout, new_ref: int, new_scap: int,
                     new_fix: int, datatype: str):
    """Layout effect of transform_dense_{stereo,mono} + the slot bundle.

    Returns (layout', slots) where slots is
      stereo: (rs,)                     rs = slot of new_ref (holds old ref after)
      mono:   (rs, ss, p1, p2, old_fix, new_fix)
              rs/ss = slots of the old ref/scap, p1/p2 = of the new.
    """
    if datatype == "stereo":
        rs = nl.pose_slot(new_ref)
        ids = nl.pose_ids.copy()
        ids[rs] = nl.ref       # re-tag (LinearSFMImp.cpp:416-417)
        out = dataclasses.replace(nl, pose_ids=ids, ref=int(new_ref))
        return out, (rs,)
    rs = nl.pose_slot(nl.ref)
    ss = nl.pose_slot(nl.scap)
    p1 = nl.pose_slot(new_ref)
    p2 = nl.pose_slot(new_scap)
    out = dataclasses.replace(nl, ref=int(new_ref), scap=int(new_scap),
                              fix=int(new_fix))
    return out, (rs, ss, p1, p2, nl.fix, int(new_fix))


def join_layout(g: NodeLayout, m: NodeLayout, datatype: str):
    """Layout effect of the pairwise join (g already transformed into m's
    gauge). Returns (joint layout, maps) with maps = dict of exact-size
    source arrays (padded to caps by the planner):

      gsrcP/msrcP[mo]: source pose slot in g/m per joint slot, -1 = none.
      gsrcF/msrcF[no]: source feature slot per joint feature slot.
    """
    if datatype == "stereo":
        pose_ids = np.concatenate([g.pose_ids, m.pose_ids])
        if len(np.unique(pose_ids)) != len(pose_ids):
            raise ValueError("stereo join: duplicate pose ids")
        gsrcP = np.concatenate([np.arange(g.m), np.full(m.m, -1)])
        msrcP = np.concatenate([np.full(g.m, -1), np.arange(m.m)])
    else:
        # mono pose identification: m's ref & scap map onto g's slots
        # (LinearSFMImp.cpp:7383-7409); its ref row carries zero information
        # and is dropped (:7482, :7619).
        keep = (m.pose_ids != m.ref) & (m.pose_ids != m.scap)
        pose_ids = np.concatenate([g.pose_ids, m.pose_ids[keep]])
        gsrcP = np.concatenate([np.arange(g.m), np.full(int(keep.sum()), -1)])
        msrcP = np.full(len(pose_ids), -1)
        msrcP[g.pose_slot(m.scap)] = int(np.nonzero(m.pose_ids == m.scap)[0][0])
        msrcP[g.m:] = np.nonzero(keep)[0]
        if len(np.unique(pose_ids)) != len(pose_ids):
            raise ValueError("mono join: duplicate pose ids")

    # features: shared ids fuse, new ids append in m order
    pos_in_g = {int(f): i for i, f in enumerate(g.feat_ids)}
    new = [int(f) for f in m.feat_ids if int(f) not in pos_in_g]
    feat_ids = np.concatenate([g.feat_ids,
                               np.asarray(new, np.int32)]) if new else \
        g.feat_ids.copy()
    no = len(feat_ids)
    gsrcF = np.concatenate([np.arange(g.n), np.full(no - g.n, -1)])
    msrcF = np.full(no, -1)
    slot_of = {int(f): i for i, f in enumerate(feat_ids)}
    for j, f in enumerate(m.feat_ids):
        msrcF[slot_of[int(f)]] = j

    out = NodeLayout(
        pose_ids=pose_ids.astype(np.int32), feat_ids=feat_ids.astype(np.int32),
        ref=m.ref, scap=m.scap, fix=m.fix,
        fref=g.fref, fscap=g.fscap, ffix=g.ffix)
    maps = dict(gsrcP=gsrcP.astype(np.int32), msrcP=msrcP.astype(np.int32),
                gsrcF=gsrcF.astype(np.int32), msrcF=msrcF.astype(np.int32))
    return out, maps


# ---------------------------------------------------------------------------
# Whole-tree plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DenseLevelPlan:
    count: int
    caps_in: tuple[int, int]        # (M, N) input caps
    caps_out: tuple[int, int]
    bundle: dict                    # stacked numpy arrays (see plan_dense_tree)
    regauge: tuple                  # bool per output position
    rg_bundle: dict | None          # stacked arrays for the re-gauge lanes


@dataclasses.dataclass(frozen=True)
class DenseTreePlan:
    levels: tuple[DenseLevelPlan, ...]
    layouts: tuple                  # per-level INPUT layouts
    root: NodeLayout                # finished-root layout
    root_regauge: bool
    root_slots: tuple | None


def _caps(layouts, bucket: int) -> tuple[int, int]:
    return (types.bucket(max(l.m for l in layouts), bucket),
            types.bucket(max(l.n for l in layouts), bucket))


def _stack_pad(arrs, cap, fill=-1):
    out = np.full((len(arrs), cap), fill, np.int32)
    for i, a in enumerate(arrs):
        out[i, :len(a)] = a
    return out


def plan_dense_tree(layouts: list[NodeLayout], datatype: str,
                    bucket: int = 16) -> DenseTreePlan:
    """Simulate the scheduler in layout space; emit per-level device bundles.

    Mirrors lmj_PF3D_Divide_Conquer* exactly: pairwise joins with odd carry
    (:1946-1948), every-2nd-output re-gauge when ref > fref (:1997-2030),
    final re-gauge (:2039-2063)."""
    levels = []
    level_layouts = [tuple(layouts)]
    while len(layouts) > 1:
        count = len(layouts)
        npair, nxt = count // 2, (count + 1) // 2
        caps_in = _caps(layouts, bucket)
        out, flags = [], []
        slots_t, joins = [], []
        rg_slots = []
        for i in range(nxt):
            if i < npair:
                g, m = layouts[2 * i], layouts[2 * i + 1]
                gt, tsl = transform_layout(g, m.ref, m.scap, m.fix, datatype)
                j, maps = join_layout(gt, m, datatype)
                if datatype == "mono":
                    # extra per-lane scalars: M's own ref/scap slots (info
                    # drop at cref, :7482; angle wraparound at cscap, :7427)
                    tsl = tsl + (m.pose_slot(m.ref), m.pose_slot(m.scap))
                slots_t.append(tsl)
                joins.append(maps)
            else:
                j = layouts[2 * i]
            rg = (i % 2 == 1) and (j.ref > j.fref)
            flags.append(rg)
            if rg:
                j2, rsl = transform_layout(j, j.fref, j.fscap, j.ffix,
                                           datatype)
                rg_slots.append(rsl)
                j = j2
            out.append(j)
        caps_out = _caps(out, bucket)

        Mo, No = caps_out
        bundle = dict(
            gsrcP=_stack_pad([jm["gsrcP"] for jm in joins], Mo),
            msrcP=_stack_pad([jm["msrcP"] for jm in joins], Mo),
            gsrcF=_stack_pad([jm["gsrcF"] for jm in joins], No),
            msrcF=_stack_pad([jm["msrcF"] for jm in joins], No),
            slots=np.asarray(slots_t, np.int32),       # [npair, 1|8]
        )
        rgb = (dict(slots=np.asarray(rg_slots, np.int32))
               if rg_slots else None)
        levels.append(DenseLevelPlan(count, caps_in, caps_out, bundle,
                                     tuple(flags), rgb))
        layouts = out
        level_layouts.append(tuple(layouts))

    root = layouts[0]
    root_rg = bool(root.ref > root.fref)
    root_slots = None
    if root_rg:
        root, root_slots = transform_layout(root, root.fref, root.fscap,
                                            root.ffix, datatype)
    return DenseTreePlan(tuple(levels), tuple(level_layouts[:-1]), root,
                         root_rg, root_slots)
