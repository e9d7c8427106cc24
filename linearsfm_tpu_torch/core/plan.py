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

import numpy as np

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
# can be simulated with set arithmetic before anything compiles. It runs
# one tree level at a time, all the level's nodes at once, in numpy arrays.
# Ids are ranks: pose and feature ids relabelled 0, 1, ... in id order,
# which keeps every comparison and equality of the simulation (`ref >
# fref`, the canonical pair order, the drops by id), so every count is the
# same.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TreePlan:
    levels: tuple[LevelPlan, ...]
    root_regauge: bool                     # does the final map re-gauge?
    root_caps: tuple[int, int, int, int]   # caps of the finished root
    # (the final transform grows the block lists past the last level's
    # caps_out before the merge shrinks them back; the root program must
    # compact into capacities sized from the POST-re-gauge shadow)

    def __bool__(self):
        return bool(self.levels)


_KEY_BITS = 63


def _rev(i: np.ndarray, nb: int) -> np.ndarray:
    """i with its low nb bits in reverse order."""
    out = np.zeros_like(i)
    for b in range(nb):
        out |= ((i >> b) & 1) << (nb - 1 - b)
    return out


@dataclasses.dataclass
class SymLevel:
    """Id-space shadows of one tree level's nodes, in one batch.

    The level's nodes sit in 2^nb slots: node i at slot `_rev(i, nb)`. So
    the left node of each join (even i) lies in the lower half, at the
    slot its output node takes in the next level, and its right node at
    the same place in the upper half. Each set is one sorted array of
    keys slot << kb | value, without repeats: P, F a pose / feature rank
    (kb = pb / fb bits), KU a pose pair a << pb | b with a <= b (2 pb
    bits), KW p << fb | f (pb + fb bits), all int64. Per slot: node, the
    node's index (-1: no node), and ref, scap, fref, fscap, its gauge ids
    (stereo does not read scap)."""
    P: np.ndarray
    F: np.ndarray
    KU: np.ndarray
    KW: np.ndarray
    node: np.ndarray
    ref: np.ndarray
    scap: np.ndarray
    fref: np.ndarray
    fscap: np.ndarray
    nb: int
    pb: int
    fb: int

    def fits(self) -> bool:
        """Do the keys fit 63 bits, with the bounds one slot past the last
        (range ends) too?"""
        return self.nb + max(2 * self.pb, self.pb + self.fb) < _KEY_BITS

    def key(self, slot: np.ndarray, value: np.ndarray, kb: int):
        """Keys of (slot, value) pairs."""
        return (np.asarray(slot, np.int64) << kb) | value

    def sizes(self, keys: np.ndarray, kb: int) -> np.ndarray:
        """Each slot's count of a set."""
        slots = np.arange((1 << self.nb) + 1)
        return np.diff(np.searchsorted(keys, self.key(slots, 0, kb)))

    def caps(self, bucket: int, u_bucket: int):
        """`_caps` over the level's nodes."""
        pb, fb = self.pb, self.fb
        most = [int(self.sizes(k, kb).max()) for k, kb in (
            (self.P, pb), (self.F, fb), (self.KU, 2 * pb), (self.KW, pb + fb))]
        return _caps([Counts(*most)], bucket, u_bucket)


def _unique(k: np.ndarray) -> np.ndarray:
    """k's keys sorted, without repeats (k is sorted in place). The sort
    is stable (timsort), so sorted runs cost little more than a merge."""
    k.sort(kind="stable")
    keep = np.empty(len(k), bool)
    keep[:1] = True
    np.not_equal(k[1:], k[:-1], out=keep[1:])
    return k[keep]


def _union(parts: list) -> np.ndarray:
    """The union of sorted key arrays without repeats, sorted."""
    return parts[0] if len(parts) == 1 else _unique(np.concatenate(parts))


def _ranges(keys: np.ndarray, lo, hi) -> tuple[np.ndarray, np.ndarray]:
    """The indices of the sorted keys in [lo[j], hi[j]) for every j (the
    ranges in order, apart), and the j of each."""
    a = np.searchsorted(keys, lo)
    n = np.searchsorted(keys, hi) - a
    j = np.repeat(np.arange(len(n)), n)
    return np.arange(len(j)) + np.repeat(a - (np.cumsum(n) - n), n), j


def _pair(a: np.ndarray, b: np.ndarray, pb: int) -> np.ndarray:
    """KU values of the pose pairs (a, b): the smaller rank first."""
    return (np.minimum(a, b) << pb) | np.maximum(a, b)


def _ranks(*arrays) -> tuple[list, int]:
    """Each array with its values replaced by their rank among the values
    of all of them, and the bits a rank needs."""
    flat = [np.asarray(a).astype(np.int64).ravel() for a in arrays]
    u, inv = np.unique(np.concatenate(flat), return_inverse=True)
    cuts = np.cumsum([len(f) for f in flat])[:-1]
    return ([r.reshape(np.shape(a)) for r, a in zip(np.split(inv, cuts),
                                                     arrays)],
            max(1, (len(u) - 1).bit_length()))


def sym_of_stacked(st: types.LocalMap) -> SymLevel:
    """Id-space shadows of a stacked [B, ...] host LocalMap (compact_stack),
    as one batch (`SymLevel`): which ids and blocks each map holds, not
    their values, ids ranked. Raises ValueError where a key would pass 63
    bits."""
    g = st.gauge
    (pid, ref, scap, fref, fscap), pb = _ranks(
        st.pose_ids, g.ref, g.scap, g.fref, g.fscap)
    (fid,), fb = _ranks(st.feat_ids)
    count = len(ref)
    nb = (count - 1).bit_length()
    at = _rev(np.arange(count), nb)

    def slotted(x, fill):
        out = np.full(1 << nb, fill, np.int64)
        out[at] = x
        return out

    lv = SymLevel(None, None, None, None, slotted(np.arange(count), -1),
                  slotted(ref, 0), slotted(scap, 0), slotted(fref, 0),
                  slotted(fscap, 0), nb, pb, fb)
    if not lv.fits():
        raise ValueError(
            f"sym_of_stacked: {count} maps with {pb}-bit pose and {fb}-bit "
            f"feature ranks need keys past {_KEY_BITS} bits")

    def ids(rank, raw, kb):
        i, j = np.nonzero(np.asarray(raw) >= 0)
        return _unique(lv.key(at[i], rank[i, j], kb))

    def blocks(ij, n, ra, rb):
        ij = np.asarray(ij)
        i, j = np.nonzero(np.arange(ij.shape[1]) < np.asarray(n)[:, None])
        c = ij[i, j]
        return at[i], ra[i, c[:, 0]], rb[i, c[:, 1]]

    lv.P = ids(pid, st.pose_ids, pb)
    lv.F = ids(fid, st.feat_ids, fb)
    s, a, b = blocks(st.Uij, st.n_U, pid, pid)
    lv.KU = _unique(lv.key(s, _pair(a, b, pb), 2 * pb))
    s, p, f = blocks(st.Wpf, st.n_W, pid, fid)
    lv.KW = _unique(lv.key(s, (p << fb) | f, pb + fb))
    return lv


def _transform(lv: SymLevel, sets: tuple, sel: np.ndarray, t: np.ndarray,
               ts: np.ndarray, datatype: str) -> tuple:
    """The id-space effect of transform_map_{stereo,mono} + compaction on
    the slots of `lv` where `sel` holds, to the new ref t (mono: and scap
    ts) of the slot, on `sets` (P, F, KU, KW of those slots). Returns each
    set as a list of sorted parts whose union it is."""
    P, F, KU, KW = sets
    pb, fb = lv.pb, lv.fb
    pm, fm = (1 << pb) - 1, (1 << fb) - 1
    r, s = lv.ref, lv.scap
    sl = np.flatnonzero(sel)
    # F of the selected slots, by slot
    i, j = _ranges(F, lv.key(sl, 0, fb), lv.key(sl + 1, 0, fb))
    fs, f = sl[j], F[i] & fm
    # KW keys of pose t (stereo: re-tagged; mono: dropped)
    lo = lv.key(sl, t[sl] << fb, pb + fb)
    hit, j = _ranges(KW, lo, lo + (1 << fb))
    kw = [np.delete(KW, hit)]
    if datatype == "stereo":
        # the slot holding t is re-tagged to the old ref
        # (LinearSFMImp.cpp:416-417): substitute the id in every key
        tk = lv.key(sl, t[sl], pb)
        P = _union([np.delete(P, _ranges(P, tk, tk + 1)[0]),
                    lv.key(sl, r[sl], pb)])
        kw += [lv.key(sl[j], (r[sl[j]] << fb) | (KW[hit] & fm), pb + fb),
               lv.key(fs, (r[fs] << fb) | f, pb + fb)]
        us = KU >> (2 * pb)
        a, b, tu, ru = (KU >> pb) & pm, KU & pm, t[us], r[us]
        ha = sel[us] & (a == tu)
        hb = sel[us] & (b == tu)
        moved = ha | hb
        ps = P >> pb
        on = sel[ps]
        ku = [KU[~moved],
              lv.key(us[moved], _pair(np.where(ha, ru, a)[moved],
                                      np.where(hb, ru, b)[moved], pb),
                     2 * pb),
              lv.key(ps[on], _pair(P[on] & pm, r[ps[on]], pb), 2 * pb)]
        return [P], [F], ku, kw
    # mono: blocks of the old ref r and scap s with every pose and
    # landmark; gauge conditioning then zeroes every block of the NEW ref
    # pose t
    ps = P >> pb
    on = sel[ps]
    ps, p = ps[on], P[on] & pm
    rs, ss = r[sl], s[sl]
    ku = [KU] + [lv.key(sl, _pair(x, y, pb), 2 * pb)
                 for x, y in ((rs, rs), (ss, ss), (rs, ss))]
    for q in (r, s):
        ku.append(lv.key(ps, _pair(p, q[ps], pb), 2 * pb))
        keep = q[fs] != t[fs]
        kw.append(lv.key(fs[keep], (q[fs[keep]] << fb) | f[keep], pb + fb))
    return [P], [F], [_drop_pose(lv, x, sel, t) for x in ku], kw


def _drop_pose(lv: SymLevel, KU: np.ndarray, sel: np.ndarray,
               t: np.ndarray) -> np.ndarray:
    """KU without the pairs that touch pose t[slot] in a selected slot."""
    pb, pm = lv.pb, (1 << lv.pb) - 1
    us = KU >> (2 * pb)
    tu = t[us]
    return KU[~(sel[us] & ((((KU >> pb) & pm) == tu) | ((KU & pm) == tu)))]


def _join(lv: SymLevel, datatype: str) -> SymLevel:
    """Every pair of the level joined: node 2i (gauge-transformed to node
    2i + 1's frame) and node 2i + 1 into node i of the next level (an odd
    last node passes through)."""
    pb, fb = lv.pb, lv.fb
    h = 1 << (lv.nb - 1)
    out = dataclasses.replace(
        lv, nb=lv.nb - 1, node=lv.node[:h] >> 1, ref=lv.ref[:h],
        scap=lv.scap[:h], fref=lv.fref[:h], fscap=lv.fscap[:h])
    sel = lv.node[h:] >= 0
    t, ts = lv.ref[h:], lv.scap[h:]
    halves = []
    for K, kb in ((lv.P, pb), (lv.F, fb), (lv.KU, 2 * pb),
                  (lv.KW, pb + fb)):
        cut = np.searchsorted(K, h << kb)
        halves.append((K[:cut], K[cut:] - (h << kb)))
    parts = _transform(out, [x[0] for x in halves], sel, t, ts, datatype)
    right = [x[1] for x in halves]
    if datatype == "mono":
        # the right map's blocks on the zero-information joint reference
        # pose, its own ref (LinearSFMImp.cpp:7482, :7619)
        sl = np.flatnonzero(sel)
        lo = out.key(sl, t[sl] << fb, pb + fb)
        right[2] = _drop_pose(out, right[2], sel, t)
        right[3] = np.delete(right[3], _ranges(right[3], lo,
                                               lo + (1 << fb))[0])
    out.P, out.F, out.KU, out.KW = (
        _union(p + [x]) for p, x in zip(parts, right))
    out.ref = np.where(sel, t, out.ref)
    out.scap = np.where(sel, ts, out.scap)
    return out


def _regauge(lv: SymLevel, sel: np.ndarray, datatype: str) -> SymLevel:
    """The selected slots re-gauged to their final frame (fref, fscap)."""
    if not sel.any():
        return lv
    parts = _transform(lv, (lv.P, lv.F, lv.KU, lv.KW), sel, lv.fref,
                       lv.fscap, datatype)
    return dataclasses.replace(
        lv, P=_union(parts[0]), F=_union(parts[1]), KU=_union(parts[2]),
        KW=_union(parts[3]), ref=np.where(sel, lv.fref, lv.ref),
        scap=np.where(sel, lv.fscap, lv.scap))


def _simulate(syms: SymLevel, datatype: str, bucket: int, u_bucket: int,
              map_offset: int) -> tuple[list, SymLevel]:
    """The tree's levels from the maps' shadows up to one node: each
    level's plan, and the root's shadow (before any final re-gauge)."""
    lv = syms
    plans = []
    off = map_offset
    count = int((lv.node >= 0).sum())
    caps_in = lv.caps(bucket, u_bucket)
    while count > 1:
        assert off % 2 == 0, \
            f"subtree offset {map_offset} unaligned at count {count}"
        off //= 2
        joined = lv.node[1 << (lv.nb - 1):] >= 0
        lv = _join(lv, datatype)
        # conditional re-gauge at odd output positions (exact: an id
        # comparison, LinearSFMImp.cpp:1997-2030)
        rg = ((lv.node >= 0) & ((off + lv.node) % 2 == 1)
              & (lv.ref > lv.fref))
        lv = _regauge(lv, rg, datatype)
        nxt = (count + 1) // 2
        flags = np.zeros(nxt, bool)
        on = lv.node >= 0
        flags[lv.node[on]] = rg[on]
        caps_out = lv.caps(bucket, u_bucket)
        join_m = int(lv.sizes(lv.P, lv.pb)[joined].max())
        plans.append(LevelPlan(count, caps_in, caps_out,
                               tuple(flags.tolist()), join_m))
        count, caps_in = nxt, caps_out
    return plans, lv


def plan_tree_exact(syms: SymLevel, datatype: str, bucket: int = 16,
                    u_bucket: int = 64, map_offset: int = 0,
                    final_regauge: bool = True) -> TreePlan:
    """Exact per-level capacity plan from the id-space tree simulation.

    syms: the maps' shadows, as `sym_of_stacked` gives them; each level
    runs as one batch.
    map_offset: global index of syms[0] when planning a SUBTREE of a larger
    merge tree (multi-host host-local phase, parallel/multihost.py). The
    every-2nd-map re-gauge keys on the GLOBAL output position
    (LinearSFMImp.cpp:1997), so level-l positions are offset by
    map_offset / 2^(l+1); the offset must stay integral (power-of-two chunk
    sizes and aligned offsets guarantee it).
    final_regauge=False skips the global-root re-gauge, which belongs to the
    WHOLE tree's root only, not to a subtree root.
    """
    plans, lv = _simulate(syms, datatype, bucket, u_bucket, map_offset)
    root_rg = final_regauge and bool(lv.ref[0] > lv.fref[0])
    if root_rg:
        lv = _regauge(lv, np.ones(1, bool), datatype)
    return TreePlan(tuple(plans), root_rg, lv.caps(bucket, u_bucket))
