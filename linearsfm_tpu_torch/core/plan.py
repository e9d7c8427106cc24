"""Host-side capacity plan for the device-resident merge tree.

Counterpart of `linearsfm_tpu/core/plan.py`, in pure Python. The device tree
(core/device_tree.py) allocates every level's stacked maps at fixed
capacities, which must be known before anything runs. This module
simulates the tree's count arithmetic from the initial per-map valid counts:

* join:      m = m1 + m2 (stereo; mono identifies ref+scap: m1 + m2 - 2),
             n <= n1 + n2, nU <= nU1' + nU2, nW <= nW1' + nW2,
             where (') includes the pre-join gauge transform growth
             (stereo: nU+m+1, nW+n — transform_map_stereo emission;
              mono: nU+2m+3, nW+2n — transform_map_mono emission).
* re-gauge:  same transform growth, applied at odd output positions
             (reference every-2nd-map re-gauge, LinearSFMImp.cpp:1997-2030).
* compact:   only shrinks (dedup/zero-drop), so the sums are upper bounds.

All bounds are exact for pose counts and conservative (no-dedup) for
feature/block counts; padding is zero-valued and semantically inert.
"""

from __future__ import annotations

import dataclasses

from .. import types


@dataclasses.dataclass(frozen=True)
class Counts:
    m: int   # valid poses
    n: int   # valid features
    nU: int  # nonzero U blocks
    nW: int  # nonzero W blocks


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    count: int                    # maps entering this level
    caps_in: tuple[int, int, int, int]   # (M, N, KU, KW) of the level input
    caps_out: tuple[int, int, int, int]  # of the level output (= next input)
    # Exact-plan only: which output positions re-gauge to the final frame
    # (position parity AND the id comparison ref > fref — both known on the
    # host, LinearSFMImp.cpp:1997). None = unknown (count-based plan); the
    # executor must then decide dynamically.
    regauge: tuple | None = None
    # Exact-plan only: the LARGEST joined pose count actually solved at this
    # level (max over pairs of m1+m2, mono m1+m2-2). The device executor keys
    # its precision/iteration bands on this; None (count-based plan) falls
    # back to the bucketed upper bound 2*caps_in[0].
    join_m: int | None = None


def _transform_growth(c: Counts, datatype: str) -> Counts:
    if datatype == "stereo":
        return Counts(c.m, c.n, c.nU + c.m + 1, c.nW + c.n)
    return Counts(c.m, c.n, c.nU + 2 * c.m + 3, c.nW + 2 * c.n)


def _join_counts(a: Counts, b: Counts, datatype: str) -> Counts:
    at = _transform_growth(a, datatype)
    if datatype == "stereo":
        m = a.m + b.m
    else:
        m = a.m + b.m - 2
    return Counts(m, a.n + b.n, at.nU + b.nU, at.nW + b.nW)


def _caps(counts: list[Counts], bucket: int, u_bucket: int):
    M = types.bucket(max(c.m for c in counts), bucket)
    N = types.bucket(max(c.n for c in counts), bucket)
    KU = types.bucket(max(c.nU for c in counts), u_bucket)
    KW = types.bucket(max(c.nW for c in counts), u_bucket)
    return (M, N, KU, KW)


def plan_tree(counts: list[Counts], datatype: str, bucket: int = 16,
              u_bucket: int = 64) -> list[LevelPlan]:
    """Level-by-level capacity plan for the whole merge tree."""
    plans = []
    while len(counts) > 1:
        count = len(counts)
        npair = count // 2
        nxt = (count + 1) // 2
        caps_in = _caps(counts, bucket, u_bucket)
        out = []
        for i in range(nxt):
            c = (_join_counts(counts[2 * i], counts[2 * i + 1], datatype)
                 if i < npair else counts[2 * i])
            if (i + 1) % 2 == 0:  # possible re-gauge growth before compact
                c = _transform_growth(c, datatype)
            out.append(c)
        caps_out = _caps(out, bucket, u_bucket)
        plans.append(LevelPlan(count, caps_in, caps_out))
        counts = out
    return plans


def counts_of(lm: types.LocalMap) -> Counts:
    """Valid counts of a host-compacted map (n_U/n_W are exact post-compact)."""
    return Counts(int(lm.n_poses), int(lm.n_feats), int(lm.n_U), int(lm.n_W))


# ---------------------------------------------------------------------------
# Exact symbolic plan.
#
# The count-based plan above is conservative (no feature dedup: n = n1+n2),
# which doubles the dense-Schur width at every shared-feature join. But the
# whole tree schedule is known on the host in *id space*: which pose/feature
# ids each node holds, which blocks exist, and even the data-dependent
# re-gauge condition `ref > fref` (an id comparison,
# reference LinearSFMImp.cpp:1997) — so exact
# per-node counts (up to numerically-zero block drops, which only shrink)
# can be simulated with plain set arithmetic before anything compiles.
# ---------------------------------------------------------------------------

_BIG = 1 << 32


def _uk(i: int, j: int) -> int:
    return (i * _BIG + j) if i <= j else (j * _BIG + i)


@dataclasses.dataclass
class SymNode:
    """Id-space shadow of a LocalMap: which ids/blocks exist, not values."""
    P: set        # pose ids
    F: set        # feature ids
    KU: set       # canonical (min,max) pose-id pair keys
    KW: set       # pose_id * BIG + feat_id keys
    ref: int
    scap: int     # -1 for stereo
    fref: int
    fscap: int

    def counts(self) -> Counts:
        return Counts(len(self.P), len(self.F), len(self.KU), len(self.KW))


def sym_of(lm: types.LocalMap) -> SymNode:
    """Build the id-space shadow of a host-compacted LocalMap."""
    import numpy as np
    pid = np.asarray(lm.pose_ids)
    fid = np.asarray(lm.feat_ids)
    nU, nW = int(lm.n_U), int(lm.n_W)
    Uij = np.asarray(lm.Uij)[:nU]
    Wpf = np.asarray(lm.Wpf)[:nW]
    ui, uj = pid[Uij[:, 0]], pid[Uij[:, 1]]
    KU = {_uk(int(a), int(b)) for a, b in zip(ui, uj)}
    KW = {int(p) * _BIG + int(f)
          for p, f in zip(pid[Wpf[:, 0]], fid[Wpf[:, 1]])}
    g = lm.gauge
    return SymNode(
        P=set(int(x) for x in pid[pid >= 0]),
        F=set(int(x) for x in fid[fid >= 0]),
        KU=KU, KW=KW,
        ref=int(g.ref), scap=int(g.scap),
        fref=int(g.fref), fscap=int(g.fscap))


def sym_of_stacked(st: types.LocalMap) -> list[SymNode]:
    """Id-space shadows of a stacked [B, ...] host LocalMap (compact_stack)."""
    import numpy as np
    pid = np.asarray(st.pose_ids)
    fid = np.asarray(st.feat_ids)
    Uij = np.asarray(st.Uij)
    Wpf = np.asarray(st.Wpf)
    nU = np.asarray(st.n_U)
    nW = np.asarray(st.n_W)
    g = st.gauge
    out = []
    for b in range(pid.shape[0]):
        ku, kw = int(nU[b]), int(nW[b])
        ui = pid[b][Uij[b, :ku, 0]]
        uj = pid[b][Uij[b, :ku, 1]]
        KU = {_uk(int(a), int(c)) for a, c in zip(ui, uj)}
        KW = {int(p) * _BIG + int(f)
              for p, f in zip(pid[b][Wpf[b, :kw, 0]], fid[b][Wpf[b, :kw, 1]])}
        out.append(SymNode(
            P=set(int(x) for x in pid[b][pid[b] >= 0]),
            F=set(int(x) for x in fid[b][fid[b] >= 0]),
            KU=KU, KW=KW,
            ref=int(g.ref[b]), scap=int(g.scap[b]),
            fref=int(g.fref[b]), fscap=int(g.fscap[b])))
    return out


def _sym_transform(n: SymNode, new_ref: int, new_scap: int,
                   datatype: str) -> SymNode:
    """Id-space effect of transform_map_{stereo,mono} + compaction."""
    r = n.ref
    if datatype == "stereo":
        # the slot holding new_ref is re-tagged to the old ref
        # (LinearSFMImp.cpp:416-417): substitute the id in every key.
        P = (n.P - {new_ref}) | {r}

        def sub(i):
            return r if i == new_ref else i
        KU = {_uk(sub(k // _BIG), sub(k % _BIG)) for k in n.KU}
        KW = {sub(k // _BIG) * _BIG + (k % _BIG) for k in n.KW}
        KU |= {_uk(p, r) for p in P} | {_uk(r, r)}
        KW |= {r * _BIG + f for f in n.F}
        return SymNode(P, set(n.F), KU, KW, new_ref, -1, n.fref, n.fscap)
    s = n.scap
    KU = set(n.KU)
    KW = set(n.KW)
    for q in (r, s):
        KU |= {_uk(p, q) for p in n.P}
        KW |= {q * _BIG + f for f in n.F}
    KU |= {_uk(r, r), _uk(s, s), _uk(r, s)}
    # gauge conditioning zeroes every block row/col of the NEW ref pose and
    # the new scap's pinned coordinate; only whole-ref-pose blocks vanish.
    KU = {k for k in KU if k // _BIG != new_ref and k % _BIG != new_ref}
    KW = {k for k in KW if k // _BIG != new_ref}
    return SymNode(set(n.P), set(n.F), KU, KW, new_ref, new_scap,
                   n.fref, n.fscap)


def _sym_join(g: SymNode, m: SymNode, datatype: str) -> SymNode:
    gt = _sym_transform(g, m.ref, m.scap, datatype)
    if datatype == "stereo":
        return SymNode(gt.P | m.P, gt.F | m.F, gt.KU | m.KU, gt.KW | m.KW,
                       m.ref, -1, g.fref, g.fscap)
    KU = gt.KU | m.KU
    KW = gt.KW | m.KW
    # blocks touching the zero-information joint reference pose are dropped
    # (LinearSFMImp.cpp:7482, :7619).
    rr = m.ref
    KU = {k for k in KU if k // _BIG != rr and k % _BIG != rr}
    KW = {k for k in KW if k // _BIG != rr}
    return SymNode(gt.P | m.P, gt.F | m.F, KU, KW,
                   m.ref, m.scap, g.fref, g.fscap)


def _sym_finish(n: SymNode, pos: int, datatype: str) -> tuple[SymNode, bool]:
    """Conditional re-gauge at odd output positions (exact: id comparison)."""
    if pos % 2 == 1 and n.ref > n.fref:
        return _sym_transform(n, n.fref, n.fscap, datatype), True
    return n, False


@dataclasses.dataclass(frozen=True)
class TreePlan:
    levels: tuple[LevelPlan, ...]
    root_regauge: bool                     # does the final map re-gauge?
    root_caps: tuple[int, int, int, int]   # caps of the finished root
    # (the final transform grows the block lists past the last level's
    # caps_out before the merge shrinks them back; the root program must
    # compact into capacities sized from the POST-re-gauge sym node)

    def __bool__(self):
        return bool(self.levels)


def plan_tree_exact(syms: list[SymNode], datatype: str, bucket: int = 16,
                    u_bucket: int = 64, map_offset: int = 0,
                    final_regauge: bool = True) -> TreePlan:
    """Exact per-level capacity plan from the id-space tree simulation.

    map_offset: global index of syms[0] when planning a SUBTREE of a larger
    merge tree (multi-host host-local phase, parallel/multihost.py). The
    every-2nd-map re-gauge keys on the GLOBAL output position
    (LinearSFMImp.cpp:1997), so level-l positions are offset by
    map_offset / 2^(l+1); the offset must stay integral (power-of-two chunk
    sizes and aligned offsets guarantee it).
    final_regauge=False skips the global-root re-gauge, which belongs to the
    WHOLE tree's root only, not to a subtree root.
    """
    plans = []
    off = map_offset
    while len(syms) > 1:
        count = len(syms)
        npair = count // 2
        nxt = (count + 1) // 2
        assert off % 2 == 0, \
            f"subtree offset {map_offset} unaligned at count {count}"
        off //= 2
        caps_in = _caps([s.counts() for s in syms], bucket, u_bucket)
        out = []
        flags = []
        for i in range(nxt):
            n = (_sym_join(syms[2 * i], syms[2 * i + 1], datatype)
                 if i < npair else syms[2 * i])
            n, f = _sym_finish(n, off + i, datatype)
            out.append(n)
            flags.append(f)
        caps_out = _caps([s.counts() for s in out], bucket, u_bucket)
        join_m = max(len(out[i].P) for i in range(npair))
        plans.append(LevelPlan(count, caps_in, caps_out, tuple(flags),
                               join_m))
        syms = out
    root = syms[0]
    root_rg = final_regauge and bool(root.ref > root.fref)
    if root_rg:
        root = _sym_transform(root, root.fref, root.fscap, datatype)
    return TreePlan(tuple(plans), root_rg,
                    _caps([root.counts()], bucket, u_bucket))
