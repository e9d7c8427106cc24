"""Plain reference of the hierarchical linear SfM merge (Zhao et al., Linear
SFM; the upstream `lmj_PF3D_Divide_ConquerStereo` / `...Mono` tree), for the
benchmark's output check.

It states the algorithm in whole-matrix form and shares no code with the
program. The tree pairs maps (0, 1), (2, 3), ..., carries an odd map up,
and re-expresses every second map of a level, and the root, in the first
map's gauge when its reference is a later pose. A merge re-expresses the
left map in the right map's gauge, state by the gauge formula and
information by the congruence I' = J^T I J (J = d old state / d new state,
from autodiff of the same formula), and then solves the stacked information
of both maps once, x = (I_1 + I_2)^-1 (I_1 x_1 + I_2 x_2), with the gauge
coordinates held (mono: the reference pose at zero and the scale pose's
pinned coordinate at its sign). The solve eliminates the landmarks (their
information is 3x3 block-diagonal) and factors the dense pose system.

One tree level is one batch (`Level`): the states of all its maps in
concatenated rows, and one scipy sparse information matrix over the
coordinates [6 per pose row | 3 per landmark row] that holds every map's
information (maps share no entry). So a transform is one J^T I J, a join
one re-indexing, and the small solves one batched Cholesky; pose systems
of BIG coordinates or more are solved one by one, on `device`.

`dtype` sets the precision of everything, states, Jacobians, information
and solves: float64 is the reference, float32 the control that the
comparison must fail.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
import torch.autograd.forward_ad as fwad

REF_PI = 3.1415926   # the upstream wraparound's pi (LinearSFMImp.h)
BIG = 1536           # pose coordinates from which a join is solved alone
GAUGE = ("ref", "scap", "fix", "sign", "fref", "fscap", "ffix")


class Level:
    """K maps. Pose rows: pid, X [., 6], pmap (the map of each row); landmark
    rows: fid, F [., 3], fmap; rows are grouped by map, in map order. The
    coordinates are 6 per pose row, then 3 per landmark row; `info` is the
    symmetric information over them (csr). `g` holds the gauge tags, one
    int64 array [K] per name of GAUGE."""

    def __init__(self, pid, X, pmap, fid, F, fmap, info, g, K):
        self.pid, self.X, self.pmap = pid, X, pmap
        self.fid, self.F, self.fmap = fid, F, fmap
        self.info, self.g, self.K = info, g, K

    @property
    def NP(self):
        return len(self.pid)

    def pc(self, rows):
        """Coordinates of pose rows, [len(rows), 6]."""
        return 6 * np.asarray(rows)[:, None] + np.arange(6)

    def fc(self, rows):
        return 6 * self.NP + 3 * np.asarray(rows)[:, None] + np.arange(3)

    def state(self, X=None):
        return np.concatenate([(self.X if X is None else X).ravel(),
                               self.F.ravel()])


def _blocks(rows, cols, blocks):
    """COO (row, col, value) triplets of blocks [B, h, w] whose top-left
    coordinates are rows [B], cols [B] (or [B, h] / [B, w] per element)."""
    h, w = blocks.shape[1:]
    r = rows[:, None] + np.arange(h) if rows.ndim == 1 else rows
    c = cols[:, None] + np.arange(w) if cols.ndim == 1 else cols
    shape = blocks.shape
    return (np.broadcast_to(r[:, :, None], shape).reshape(-1),
            np.broadcast_to(c[:, None, :], shape).reshape(-1),
            blocks.reshape(-1))


def _csr(parts, n, dtype, transpose=False):
    r, c, v = (np.concatenate(x) for x in zip(*parts))
    if transpose:
        r, c = c, r
    return sp.csr_matrix((v.astype(dtype, copy=False), (r, c)), shape=(n, n))


def _mm(A, B, device):
    """The sparse product A @ B (csr): cuSPARSE through torch on a CUDA
    device, scipy elsewhere."""
    if torch.device(device).type != "cuda":
        return (A @ B).tocsr()

    def t(M):
        M = M.tocsr()
        return torch.sparse_csr_tensor(
            torch.from_numpy(M.indptr.astype(np.int32)).to(device),
            torch.from_numpy(M.indices.astype(np.int32)).to(device),
            torch.from_numpy(M.data).to(device), size=M.shape,
            check_invariants=False)
    C = t(A) @ t(B)
    out = sp.csr_matrix((C.values().cpu().numpy(),
                         C.col_indices().cpu().numpy(),
                         C.crow_indices().cpu().numpy()),
                        shape=(A.shape[0], B.shape[1]))
    out.sum_duplicates()
    return out


def _block_diag(B):
    """The block-diagonal csr of blocks B [n, k, k]."""
    n, k = B.shape[0], B.shape[1]
    return sp.bsr_matrix((B, np.arange(n), np.arange(n + 1)),
                         shape=(n * k, n * k)).tocsr()


def from_inputs(maps, dtype) -> Level:
    """The leaf level: one map per generated local map (`gen.LocalMapData`),
    its information from its block lists (U (i, j) and, off the diagonal,
    its transpose at (j, i); W (p, f) and its transpose; V on the landmark
    diagonal; duplicates add)."""
    K = len(maps)
    M = np.array([len(m.pose_ids) for m in maps])
    N = np.array([len(m.feat_ids) for m in maps])
    po, fo = (np.concatenate([[0], np.cumsum(x)]) for x in (M, N))
    NP, NF = int(po[-1]), int(fo[-1])

    def cat(f, shape, dt):
        return np.concatenate([np.asarray(getattr(m, f), dt).reshape(shape)
                               for m in maps])
    U, W, V = (cat("U", (-1, 6, 6), dtype), cat("W", (-1, 6, 3), dtype),
               cat("V", (-1, 3, 3), dtype))
    nU = np.array([np.asarray(m.Uij).size // 2 for m in maps])
    nW = np.array([np.asarray(m.Wpf).size // 2 for m in maps])
    Uij = cat("Uij", (-1, 2), np.int64) + np.repeat(po[:-1], nU)[:, None]
    Wpf = cat("Wpf", (-1, 2), np.int64)
    wp = Wpf[:, 0] + np.repeat(po[:-1], nW)
    wf = 6 * NP + 3 * (Wpf[:, 1] + np.repeat(fo[:-1], nW))
    off = Uij[:, 0] != Uij[:, 1]
    feat = 6 * NP + 3 * np.arange(NF)
    info = _csr([_blocks(6 * Uij[:, 0], 6 * Uij[:, 1], U),
                 _blocks(6 * Uij[off, 1], 6 * Uij[off, 0],
                         np.swapaxes(U[off], 1, 2)),
                 _blocks(6 * wp, wf, W),
                 _blocks(wf, 6 * wp, np.swapaxes(W, 1, 2)),
                 _blocks(feat, feat, V)], 6 * NP + 3 * NF, dtype)
    g = {k: np.full(K, -1, np.int64) for k in GAUGE}
    for i, m in enumerate(maps):
        mg = m.gauge
        g["ref"][i] = g["fref"][i] = mg["ref"]
        g["sign"][i] = mg.get("sign", 1)
        if mg["type"] == "mono":
            g["scap"][i] = g["fscap"][i] = mg["scap"]
            g["fix"][i] = g["ffix"][i] = mg["fix"]
    return Level(cat("pose_ids", (-1,), np.int64),
                 cat("poses", (-1, 6), dtype), np.repeat(np.arange(K), M),
                 cat("feat_ids", (-1,), np.int64),
                 cat("feats", (-1, 3), dtype), np.repeat(np.arange(K), N),
                 info, g, K)


# --- the gauge formulas, row by row (torch, for autodiff) --------------------

def _rot(abg):
    """R = Rx(g) Ry(b) Rz(a) of [..., 3] angles."""
    s, c = torch.sin(abg), torch.cos(abg)
    sa, sb, sg = s[..., 0], s[..., 1], s[..., 2]
    ca, cb, cg = c[..., 0], c[..., 1], c[..., 2]
    return torch.stack([
        torch.stack([cb * ca, cb * sa, -sb], -1),
        torch.stack([sg * sb * ca - cg * sa, sg * sb * sa + cg * ca, sg * cb],
                    -1),
        torch.stack([cg * sb * ca + sg * sa, cg * sb * sa - sg * ca, cg * cb],
                    -1)], -2)


def _euler(R):
    """The angles of R (cos(beta) > 0 branch)."""
    beta = torch.atan2(-R[..., 0, 2],
                       torch.sqrt(R[..., 0, 0] ** 2 + R[..., 0, 1] ** 2))
    return torch.stack([torch.atan2(R[..., 0, 1], R[..., 0, 0]), beta,
                        torch.atan2(R[..., 1, 2], R[..., 2, 2])], -1)


def _mv(R, v):
    return (R @ v[..., None])[..., 0]


def _pose_in(x, g, scale=None):
    """Pose rows x re-expressed in the frames of the pose rows g (each row
    its own g); translations divided by `scale` rows if given."""
    Rg = _rot(g[:, 3:6])
    tp = _mv(Rg, x[:, 0:3] - g[:, 0:3])
    if scale is not None:
        tp = tp / scale[:, None]
    ang = _euler(_rot(x[:, 3:6]) @ Rg.transpose(1, 2))
    return torch.cat([tp, ang], 1)


def _feat_in(f, g, scale=None):
    t = _mv(_rot(g[:, 3:6]), f - g[:, 0:3])
    return t if scale is None else t / scale[:, None]


def _inverse(g):
    """The pose of g's old frame origin in g's frame, per row."""
    Rg = _rot(g[:, 3:6])
    return torch.cat([-_mv(Rg, g[:, 0:3]), _euler(Rg.transpose(1, 2))], 1)


def _mono_scale(g, s, fix):
    """(|[R (s - t)]_fix|, its sign, +1 at 0) per row."""
    ts = _mv(_rot(g[:, 3:6]), s - g[:, 0:3])
    tsf = torch.gather(ts, 1, fix[:, None])[:, 0]
    sign = torch.where(tsf >= 0, 1.0, -1.0).to(tsf.dtype)
    return tsf * sign, sign


def _jac(fn, *args):
    """Per-row Jacobians of a row-wise fn by forward-mode autodiff: each
    row's output depends on that row's inputs alone, so one tangent per
    input column, set in every row, gives every row's derivative at once.
    Returns one [rows, out, in] array per argument."""
    jac = []
    for i, a in enumerate(args):
        cols = []
        for c in range(a.shape[1]):
            t = torch.zeros_like(a)
            t[:, c] = 1.0
            with fwad.dual_level():
                out = fn(*(fwad.make_dual(x, t) if k == i else x
                           for k, x in enumerate(args)))
                d = fwad.unpack_dual(out).tangent
            cols.append(torch.zeros_like(out) if d is None else d)
        jac.append(torch.stack(cols, -1).numpy())
    return jac


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _row_of(lv, sel, pid_of_map):
    """The pose row of each selected map k holding pose pid_of_map[k]."""
    rows = np.flatnonzero(sel[lv.pmap] & (lv.pid == pid_of_map[lv.pmap]))
    got = np.bincount(lv.pmap[rows], minlength=lv.K)
    if np.any(got[sel] != 1):
        raise ValueError("a map does not hold its gauge pose exactly once")
    out = np.full(lv.K, -1, np.int64)
    out[lv.pmap[rows]] = rows
    return out


def transform(lv: Level, sel, ref, scap, fix, datatype: str,
              device="cpu") -> Level:
    """Re-express the maps flagged in `sel` (bool [K]) in the gauges (ref,
    scap, fix) [K] and their information by J^T I J; the other maps stay.

    Stereo: the slot of the new reference then holds the old reference
    pose (tagged with its id). Mono: the new reference pose lands at zero
    and the new scale pose's pinned coordinate at +-1, and J's columns of
    those gauge coordinates are zero."""
    g0 = lv.g
    X, F, pid = lv.X.copy(), lv.F.copy(), lv.pid.copy()
    pr = np.flatnonzero(sel[lv.pmap])
    fr = np.flatnonzero(sel[lv.fmap])
    pm, fm = lv.pmap[pr], lv.fmap[fr]
    ks = np.flatnonzero(sel)
    p1 = _row_of(lv, sel, ref)
    g = dict(g0)
    g["ref"] = np.where(sel, ref, g0["ref"])
    cols, keep = [], np.ones(lv.info.shape[0], bool)
    tX, tF = _t(lv.X), _t(lv.F)
    if datatype == "stereo":
        X[pr] = _pose_in(tX[pr], tX[p1[pm]]).numpy()
        F[fr] = _feat_in(tF[fr], tX[p1[fm]]).numpy()
        X[p1[ks]] = _inverse(tX[p1[ks]]).numpy()
        pid[p1[ks]] = g0["ref"][ks]
        # J = d old / d new: old = the same formula at q, the new value of
        # the old reference's slot (the new reference's slot), whose own
        # old value is q's inverse
        nX, nF = _t(X), _t(F)
        D, C = _jac(_pose_in, nX[pr], nX[p1[pm]])
        Df, Cf = _jac(_feat_in, nF[fr], nX[p1[fm]])
        (Dinv,) = _jac(_inverse, nX[p1[ks]])
        at_r = pr == p1[pm]
        D[at_r] = Dinv[np.searchsorted(ks, pm[at_r])]
        cols.append(_blocks(lv.pc(pr[~at_r]), 6 * p1[pm[~at_r]], C[~at_r]))
        cols.append(_blocks(lv.fc(fr), 6 * p1[fm], Cf))
    else:
        p2 = _row_of(lv, sel, scap)
        r = _row_of(lv, sel, g0["ref"])
        s = _row_of(lv, sel, g0["scap"])
        scale, sign = _mono_scale(tX[p1[pm]], tX[p2[pm], 0:3], _t(fix[pm]))
        X[pr] = _pose_in(tX[pr], tX[p1[pm]], scale).numpy()
        fscale, _ = _mono_scale(tX[p1[fm]], tX[p2[fm], 0:3], _t(fix[fm]))
        F[fr] = _feat_in(tF[fr], tX[p1[fm]], fscale).numpy()
        sign_k = np.zeros(lv.K, np.int64)
        sign_k[pm] = sign.numpy().astype(np.int64)
        X[p1[ks]] = 0.0
        X[p2[ks], fix[ks]] = sign_k[ks]
        g["scap"] = np.where(sel, scap, g0["scap"])
        g["fix"] = np.where(sel, fix, g0["fix"])
        g["sign"] = np.where(sel, sign_k, g0["sign"])
        nX, nF = _t(X), _t(F)
        ofix_p, ofix_f = _t(g0["fix"][pm]), _t(g0["fix"][fm])

        def pose_old(x, q, sv):
            return _pose_in(x, q, _mono_scale(q, sv, ofix_p)[0])

        def feat_old(f, q, sv):
            return _feat_in(f, q, _mono_scale(q, sv, ofix_f)[0])

        D, C, C2 = _jac(pose_old, nX[pr], nX[r[pm]], nX[s[pm], 0:3])
        Df, Cf, C2f = _jac(feat_old, nF[fr], nX[r[fm]], nX[s[fm], 0:3])
        # the old gauge slots' own couplings fall on their diagonal blocks
        # and add there
        cols.append(_blocks(lv.pc(pr), 6 * r[pm], C))
        cols.append(_blocks(lv.pc(pr), 6 * s[pm], C2))
        cols.append(_blocks(lv.fc(fr), 6 * r[fm], Cf))
        cols.append(_blocks(lv.fc(fr), 6 * s[fm], C2f))
        # condition on the new gauge
        keep[lv.pc(p1[ks]).ravel()] = False
        keep[6 * p2[ks] + fix[ks]] = False
    other = np.concatenate([lv.pc(np.flatnonzero(~sel[lv.pmap])).ravel(),
                            lv.fc(np.flatnonzero(~sel[lv.fmap])).ravel()])
    pcs, fcs = lv.pc(pr), lv.fc(fr)
    parts = [_blocks(pcs, pcs, D), _blocks(fcs, fcs, Df),
             (other, other, np.ones(len(other)))] + cols
    # J's columns of the new gauge coordinates (mono) are left out
    parts = [(r[keep[c]], c[keep[c]], v[keep[c]]) for r, c, v in parts]
    n = lv.info.shape[0]
    J = _csr(parts, n, X.dtype)
    JT = _csr(parts, n, X.dtype, transpose=True)
    info = _mm(JT, _mm(lv.info, J, device), device)
    return Level(pid, X, lv.pmap, lv.fid, F, lv.fmap, info, g, lv.K)


# --- the join -------------------------------------------------------------

def _wrap_pi(x):
    two_pi = 2.0 * REF_PI
    k = np.trunc(x / two_pi)
    return x - np.where(x > REF_PI, (k + 1) * two_pi,
                        np.where(x < -REF_PI, (k - 1) * two_pi, 0.0))


def _wrap_near(x, ref):
    d = x - ref
    return x + np.where(d > REF_PI, -2.0 * REF_PI,
                        np.where(d < -REF_PI, 2.0 * REF_PI, 0.0))


def _shared_rows(ids, maps, npair):
    """Rows of a pair's right map (odd map < 2 npair) whose id its left map
    also holds: (those rows, the left rows holding the id, keep mask: the
    rows that stay rows of the joined map)."""
    pair = maps // 2
    inpair = pair < npair
    left = np.flatnonzero(inpair & (maps % 2 == 0))
    right = np.flatnonzero(inpair & (maps % 2 == 1))
    big = int(ids.max()) + 1 if len(ids) else 1
    lk = pair[left] * big + ids[left]
    rk = pair[right] * big + ids[right]
    order = np.argsort(lk, kind="stable")
    pos = np.clip(np.searchsorted(lk, rk, sorter=order), 0,
                  max(len(order) - 1, 0))
    hit = (lk[order[pos]] == rk) if len(order) else np.zeros(len(rk), bool)
    keep = np.ones(len(ids), bool)
    keep[right[hit]] = False
    return right[hit], left[order[pos[hit]]], keep


def join_level(lv: Level, datatype: str, device) -> Level:
    """Fuse maps (2i, 2i+1) of the level (the left one already in the right
    one's gauge) and carry an odd last map: one solve of each pair's
    stacked information for every pose and landmark of both."""
    K, npair = lv.K, lv.K // 2
    # landmarks: the left map's, then the right map's unseen ones
    fdead, ftarget, fkeep = _shared_rows(lv.fid, lv.fmap, npair)
    X = lv.X.copy()
    drop = np.zeros(lv.info.shape[0], bool)
    left = np.arange(0, 2 * npair, 2)
    if datatype == "stereo":
        pdead = ptarget = np.zeros(0, np.int64)
        pkeep = np.ones(lv.NP, bool)
    else:
        # the right map's reference and scale poses are the left map's
        pdead, ptarget, pkeep = _shared_rows(lv.pid, lv.pmap, npair)
        if len(pdead) != 2 * npair:
            raise ValueError("a mono pair does not share exactly 2 poses")
        is_l = np.isin(np.arange(K), left)
        is_r = np.isin(np.arange(K), left + 1)
        pos1 = _row_of(lv, is_l, lv.g["ref"])[left]
        pos2 = _row_of(lv, is_l, lv.g["scap"])[left]
        cref = _row_of(lv, is_r, lv.g["ref"])[left + 1]
        cscap = _row_of(lv, is_r, lv.g["scap"])[left + 1]
        X[pos2, 3:6] = _wrap_pi(lv.X[pos2, 3:6])
        X[cscap, 3:6] = _wrap_near(_wrap_pi(lv.X[cscap, 3:6]), X[pos2, 3:6])
        # the information touching a reference pose (zero by the gauge) is
        # left out
        drop[lv.pc(pos1).ravel()] = True
        drop[lv.pc(cref).ravel()] = True
    # the joined rows: the old ones in order, the shared ones once
    pnew = np.cumsum(pkeep) - 1
    pnew[pdead] = pnew[ptarget]
    fnew = np.cumsum(fkeep) - 1
    fnew[fdead] = fnew[ftarget]
    NP2, NF2 = int(pkeep.sum()), int(fkeep.sum())
    cmap = np.concatenate([(6 * pnew[:, None] + np.arange(6)).ravel(),
                           (6 * NP2 + 3 * fnew[:, None]
                            + np.arange(3)).ravel()])
    n2 = 6 * NP2 + 3 * NF2
    c = lv.info.tocoo()
    ok = ~(drop[c.row] | drop[c.col])
    info = sp.csr_matrix((c.data[ok], (cmap[c.row[ok]], cmap[c.col[ok]])),
                         shape=(n2, n2))
    # e = I x of each map, the left-out information included in neither:
    # its columns hold a reference pose, which is zero, and its rows are
    # left out
    x = lv.state(X)
    if np.any(x[drop]):
        raise ValueError("a mono reference pose is not zero")
    e_old = lv.info @ x
    e_old[drop] = 0.0
    e = np.zeros(n2, lv.X.dtype)
    np.add.at(e, cmap, e_old)
    pmap2, fmap2 = lv.pmap[pkeep] // 2, lv.fmap[fkeep] // 2
    nxt = Level(lv.pid[pkeep], X[pkeep], pmap2, lv.fid[fkeep], lv.F[fkeep],
                fmap2, info, {}, (K + 1) // 2)
    if datatype == "mono":
        fixed = (np.concatenate([nxt.pc(pnew[pos1]).ravel(),
                                 6 * pnew[pos2] + lv.g["fix"][left]]),
                 np.concatenate([np.zeros(6 * npair),
                                 lv.g["sign"][left].astype(float)]))
    else:
        fixed = (np.zeros(0, np.int64), np.zeros(0))
    xp, xf = solve_level(nxt, e, np.arange(npair), fixed, device)
    nxt.X[pmap2 < npair] = xp.reshape(-1, 6)
    nxt.F[fmap2 < npair] = xf.reshape(-1, 3)
    # gauge tags: the right map's (stereo: its reference only) and the left
    # map's final-frame tags; a carry keeps its own
    g = {k: v[0::2].copy() for k, v in lv.g.items()}
    names = ("ref",) if datatype == "stereo" else ("ref", "scap", "fix",
                                                   "sign")
    for k in names:
        g[k][:npair] = lv.g[k][1::2][:npair]
    nxt.g = g
    return nxt


# --- the solve ------------------------------------------------------------

def _dense(csr, device, dtype):
    c = csr.tocoo()
    out = torch.zeros(c.shape, dtype=dtype, device=device)
    if c.nnz:
        out.index_put_((torch.from_numpy(c.row.astype(np.int64)).to(device),
                        torch.from_numpy(c.col.astype(np.int64)).to(device)),
                       torch.from_numpy(c.data).to(device), accumulate=True)
    return out


def _chol_solve(S, b):
    """S^-1 b by Cholesky (two triangular solves), batched or not."""
    L = torch.linalg.cholesky(S)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                         upper=True)[..., 0]


def _sub(M, rows, cols):
    """M[rows][:, cols], by slices where the coordinates are a range."""
    def ix(a):
        a = np.asarray(a)
        if len(a) and a[-1] - a[0] + 1 == len(a) and np.all(np.diff(a) == 1):
            return slice(int(a[0]), int(a[-1]) + 1)
        return a
    return M[ix(rows)][:, ix(cols)]


def _schur_dense(info, e, pc, fc, Vinv, dev, tdt, budget):
    """(S, E) of one map: the dense pose system after eliminating its
    landmarks, landmark columns taken in chunks of `budget` bytes."""
    S = _dense(_sub(info, pc, pc), dev, tdt)
    E = torch.from_numpy(e[pc].copy()).to(dev)
    Ipf = _sub(info, pc, fc).tocsc()
    ef = e[fc]
    nf = len(fc) // 3
    step = max(1, budget // max(1, 3 * len(pc) * S.element_size()))
    for a in range(0, nf, step):
        b = min(nf, a + step)
        Wc = _dense(Ipf[:, 3 * a:3 * b], dev, tdt)
        Yc = torch.einsum("pnk,nkl->pnl", Wc.view(len(pc), b - a, 3),
                          torch.from_numpy(Vinv[a:b]).to(dev))
        Yc = Yc.reshape(len(pc), 3 * (b - a))
        S -= Yc @ Wc.T
        E -= Yc @ torch.from_numpy(ef[3 * a:3 * b].copy()).to(dev)
        del Wc, Yc
    return S, E


def solve_level(lv: Level, e, solved, fixed, device, budget=2**31):
    """Solve info x = e over the pose and landmark rows of each map in
    `solved` alone, with the coordinates fixed[0] held at fixed[1]; returns
    (pose coordinates, landmark coordinates) of those maps' rows in row
    order. Landmarks are eliminated (their information is 3x3
    block-diagonal); the pose systems are factored by Cholesky, those under
    BIG coordinates in one padded batch, larger ones one by one, on
    `device`."""
    dt = lv.X.dtype
    tdt = torch.float64 if dt == np.float64 else torch.float32
    dev = torch.device(device)
    info, n, P6 = lv.info, lv.info.shape[0], 6 * lv.NP
    isin = np.zeros(lv.K, bool)
    isin[solved] = True
    prow = np.flatnonzero(isin[lv.pmap])
    frow = np.flatnonzero(isin[lv.fmap])
    pcs, fcs = lv.pc(prow).ravel(), lv.fc(frow).ravel()
    # every landmark's 3x3 diagonal block, inverted
    c = info.tocoo()
    ff = (c.row >= P6) & (c.col >= P6)
    r, q, v = c.row[ff] - P6, c.col[ff] - P6, c.data[ff]
    if np.any(r // 3 != q // 3):
        raise ValueError("landmark information is not 3x3 block-diagonal")
    V = np.zeros((len(lv.fid), 3, 3), dt)
    np.add.at(V, (r // 3, r % 3, q % 3), v)
    Vinv = np.linalg.inv(V[frow]) if len(frow) else V[:0]
    xfix = np.zeros(n, dt)
    xfix[fixed[0]] = fixed[1]
    isfix = np.zeros(n, bool)
    isfix[fixed[0]] = True
    xp = np.zeros(n, dt)
    npose = np.bincount(lv.pmap, minlength=lv.K)
    first = np.searchsorted(lv.pmap, np.arange(lv.K))
    small = isin & (6 * npose < BIG)
    groups = [np.flatnonzero(small)] + [[k] for k in
                                        np.flatnonzero(isin & ~small)]
    for group in groups:
        if len(group) == 0:
            continue
        gp = np.flatnonzero(np.isin(lv.pmap, group))
        gf = np.flatnonzero(np.isin(lv.fmap, group))
        pc, fc = lv.pc(gp).ravel(), lv.fc(gf).ravel()
        Vg = Vinv[np.searchsorted(frow, gf)]
        fx = isfix[pc]
        if not small[group[0]]:
            S, E = _schur_dense(info, e, pc, fc, Vg, dev, tdt, budget)
            tfx = torch.from_numpy(fx).to(dev)
            E -= S[:, tfx] @ torch.from_numpy(xfix[pc][fx]).to(dev)
            x = torch.from_numpy(xfix[pc]).to(dev)
            x[~tfx] = _chol_solve(S[~tfx][:, ~tfx], E[~tfx])
            xp[pc] = x.cpu().numpy()
            continue
        Ipf = _sub(info, pc, fc)
        Y = _mm(Ipf, _block_diag(Vg), device) if len(Vg) else Ipf
        S = (_sub(info, pc, pc) - _mm(Y, Ipf.T.tocsr(), device)).tocsr()
        E = e[pc] - Y @ e[fc] - S @ xfix[pc]
        S = S.tocoo()
        # one dense system per map, padded to the largest; padding and held
        # coordinates are identity rows whose right side is the value
        loc = (6 * (gp - first[lv.pmap[gp]])[:, None] + np.arange(6)).ravel()
        mof = np.repeat(np.searchsorted(group, lv.pmap[gp]), 6)
        w = 6 * int(npose[group].max())
        ok = ~(fx[S.row] | fx[S.col])
        Sb = torch.zeros((len(group), w, w), dtype=tdt)
        Sb[mof[S.row[ok]], loc[S.row[ok]], loc[S.col[ok]]] = torch.from_numpy(
            S.data[ok])
        rhs = torch.zeros((len(group), w), dtype=tdt)
        rhs[mof, loc] = torch.from_numpy(np.where(fx, xfix[pc], E))
        unit = torch.ones((len(group), w), dtype=torch.bool)
        unit[mof, loc] = torch.from_numpy(fx)
        Sb += torch.diag_embed(unit.to(tdt))
        x = _chol_solve(Sb.to(dev), rhs.to(dev)).cpu()
        xp[pc] = x[mof, loc].numpy()
    # landmarks by back-substitution: x_f = V^-1 (e_f - I_fp x_p)
    z = np.zeros(n, dt)
    z[pcs] = xp[pcs]
    ef = (e[fcs] - (info @ z)[fcs]).reshape(-1, 3)
    xf = np.einsum("nkl,nl->nk", Vinv, ef)
    return xp[pcs], xf.reshape(-1)


# --- the tree -------------------------------------------------------------

def _regauge(lv: Level, sel, datatype: str, device) -> Level:
    sel = sel & (lv.g["ref"] > lv.g["fref"])
    if not sel.any():
        return lv
    return transform(lv, sel, lv.g["fref"], lv.g["fscap"], lv.g["ffix"],
                     datatype, device)


def solve_tree(maps, datatype: str, dtype=np.float64,
               device="cpu") -> Level:
    """The fused map (a one-map `Level`) of a sequence of local maps
    (`gen.LocalMapData`), in the first map's gauge."""
    lv = from_inputs(maps, dtype)
    while lv.K > 1:
        k = np.arange(lv.K)
        left = (k % 2 == 0) & (k < 2 * (lv.K // 2))
        # each left map into its right neighbour's gauge
        nb = np.minimum(k + 1, lv.K - 1)
        lv = transform(lv, left, lv.g["ref"][nb], lv.g["scap"][nb],
                       lv.g["fix"][nb], datatype, device)
        lv = join_level(lv, datatype, device)
        k = np.arange(lv.K)
        lv = _regauge(lv, (k + 1) % 2 == 0, datatype, device)
    return _regauge(lv, np.ones(1, bool), datatype, device)
