"""Synthetic local-map sets for the benchmark: a frozen, vectorised copy of
the repository's generator model (`synth/generate.py`, `make_dataset`).

A ground-truth trajectory (a turning loop, or a lawnmower grid) owns
`feats_per_pose` landmarks per pose; local map k holds pose k+1 in pose k's
frame (stereo) or poses k..k+2 scale-normalised in pose k's frame (mono),
the landmarks its poses own plus up to `covis_max` landmarks of distant
poses within `covis_radius` (loop closures), and block-sparse information
from Gauss-Newton point observations and pose priors. The random draws are
the original's, in its order, so a set equals the original's array for
array; the per-observation information is computed in one batch per set
instead of one 3x3 product at a time.

Nothing here imports the program or JAX: the harness hands the same maps
to the program and to the plain reference.
"""

from __future__ import annotations

import numpy as np


class LocalMapData:
    """One local map as plain numpy arrays, under the field names every
    solver of the port accepts (its `types.host_fields`); `gauge` is a dict
    with `type`, `ref` and, for mono, `scap`, `fix` and `sign`."""

    __slots__ = ("pose_ids", "poses", "feat_ids", "feats", "U", "Uij", "W",
                 "Wpf", "V", "gauge")

    def __init__(self, pose_ids, poses, feat_ids, feats, U, Uij, W, Wpf, V,
                 gauge):
        self.pose_ids, self.poses = pose_ids, poses
        self.feat_ids, self.feats = feat_ids, feats
        self.U, self.Uij, self.W, self.Wpf, self.V = U, Uij, W, Wpf, V
        self.gauge = gauge


def euler_to_r(abg):
    """[..., 3] (alpha, beta, gamma) -> [..., 3, 3], R = Rx(g) Ry(b) Rz(a)."""
    abg = np.asarray(abg)
    a, b, g = abg[..., 0], abg[..., 1], abg[..., 2]
    ca, sa, cb, sb = np.cos(a), np.sin(a), np.cos(b), np.sin(b)
    cg, sg = np.cos(g), np.sin(g)
    r = np.empty(abg.shape[:-1] + (3, 3))
    r[..., 0, 0], r[..., 0, 1], r[..., 0, 2] = cb * ca, cb * sa, -sb
    r[..., 1, 0] = sg * sb * ca - cg * sa
    r[..., 1, 1] = sg * sb * sa + cg * ca
    r[..., 1, 2] = sg * cb
    r[..., 2, 0] = cg * sb * ca + sg * sa
    r[..., 2, 1] = cg * sb * sa - sg * ca
    r[..., 2, 2] = cg * cb
    return r


def r_to_euler(R):
    """[..., 3, 3] -> [..., 3] Euler angles (the inverse of `euler_to_r`)."""
    beta = np.arctan2(-R[..., 0, 2], np.hypot(R[..., 0, 0], R[..., 0, 1]))
    cb = np.cos(beta)
    return np.stack([np.arctan2(R[..., 0, 1] / cb, R[..., 0, 0] / cb), beta,
                     np.arctan2(R[..., 1, 2] / cb, R[..., 2, 2] / cb)],
                    axis=-1)


def _dR(abg):
    """(dR/da, dR/db, dR/dg), each [..., 3, 3]."""
    a, b, g = abg[..., 0], abg[..., 1], abg[..., 2]
    ca, sa, cb, sb = np.cos(a), np.sin(a), np.cos(b), np.sin(b)
    cg, sg = np.cos(g), np.sin(g)
    z, o = np.zeros_like(a), np.ones_like(a)

    def m(rows):
        return np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)

    Rz = m([[ca, sa, z], [-sa, ca, z], [z, z, o]])
    Ry = m([[cb, z, -sb], [z, o, z], [sb, z, cb]])
    Rx = m([[o, z, z], [z, cg, sg], [z, -sg, cg]])
    dRz = m([[-sa, ca, z], [-ca, -sa, z], [z, z, z]])
    dRy = m([[-sb, z, -cb], [z, z, z], [cb, z, -sb]])
    dRx = m([[z, z, z], [z, -sg, cg], [z, -cg, -sg]])
    return Rx @ Ry @ dRz, Rx @ dRy @ Rz, dRx @ Ry @ Rz


def make_world(num_poses: int, feats_per_pose: int = 4, seed: int = 0,
               turn_rate: float = 0.15, step: float = 1.0,
               pattern: str = "loop"):
    """(poses_gt [P, 6], feats_gt [P*F, 3], feat_owner [P*F]); the world
    frame is pose 0's."""
    rng = np.random.default_rng(seed)
    P, F = num_poses, feats_per_pose
    # the original draws, per pose after the first, 3 position normals and
    # then 3 angle normals; one batch gives the same stream
    z = rng.standard_normal((max(P - 1, 0), 6))
    strip = max(8, int(np.sqrt(P) * 1.5))
    i = np.arange(1, P)
    if pattern == "grid":
        rate = np.where(i % strip == 0, np.pi / 2, 0.0)
    else:
        rate = np.full(P - 1, turn_rate)
    dab = np.stack([rate + 0.02 * z[:, 3], 0.02 * z[:, 4], 0.02 * z[:, 5]],
                   axis=1)
    E = euler_to_r(dab)
    noise = 0.05 * z[:, 0:3]
    Rs = np.empty((P, 3, 3))
    ts = np.empty((P, 3))
    R, t = np.eye(3), np.zeros(3)
    Rs[0], ts[0] = R, t
    for k in range(P - 1):
        t = t + R.T @ np.array([step, 0.0, 0.0]) + noise[k]
        R = E[k] @ R
        Rs[k + 1], ts[k + 1] = R, t
    poses = np.concatenate([ts, r_to_euler(Rs)], axis=1)
    feats = (np.repeat(poses[:, 0:3], F, axis=0)
             + rng.normal(0, 2.0, (P * F, 3)) + np.array([0, 0, 3.0]))
    owner = np.repeat(np.arange(P), F)
    return poses, feats, owner


def _covis_all(num_maps, span, poses_gt, feats_gt, owner, radius, cap,
               rng, chunk=128):
    """Yields, map by map, the landmarks owned outside poses [k, k + span -
    1] within `radius` of map k's mean camera position, at most `cap` of
    them drawn by `rng`; the caller draws map k's noise before asking for
    map k + 1, so the stream is the original's."""
    if radius <= 0 or cap <= 0:
        for _ in range(num_maps):
            yield np.zeros(0, np.int64)
        return
    F = len(owner) // len(poses_gt)
    fx, fy, fz = (np.ascontiguousarray(feats_gt[:, i]) for i in range(3))
    for c0 in range(0, num_maps, chunk):
        ks = np.arange(c0, min(c0 + chunk, num_maps))
        # the mean of span rows, added in row order as `mean(axis=0)` does
        mid = poses_gt[ks, 0:3]
        for s in range(1, span):
            mid = mid + poses_gt[ks + s, 0:3]
        mid = mid / span
        # |f - mid| as `linalg.norm` adds the squares: (x + y) + z
        d2 = (fx[None] - mid[:, 0:1]) ** 2
        d2 += (fy[None] - mid[:, 1:2]) ** 2
        d2 += (fz[None] - mid[:, 2:3]) ** 2
        near = np.sqrt(d2, out=d2) <= radius
        for i, k in enumerate(ks):
            # landmarks are owned in pose order, F to a pose
            near[i, k * F:(k + span) * F] = False
            cand = np.flatnonzero(near[i])
            if len(cand) > cap:
                cand = rng.choice(cand, size=cap, replace=False)
                cand.sort()
            yield cand


def _obs_info(pose, feat, w=25.0):
    """Gauss-Newton information of h = R (f - t) for a batch of
    observations: (Hpp [..., 6, 6], Hpf [..., 6, 3], Hff [..., 3, 3])."""
    lead = np.broadcast_shapes(pose.shape[:-1], feat.shape[:-1])
    pose = np.broadcast_to(pose, lead + (6,))
    t, abg = pose[..., 0:3], pose[..., 3:6]
    R = euler_to_r(abg)
    dRa, dRb, dRg = _dR(abg)
    d = (feat - t)[..., None]
    Jp = np.concatenate([-R, dRa @ d, dRb @ d, dRg @ d], axis=-1)
    JpT = np.swapaxes(Jp, -1, -2)
    return w * JpT @ Jp, w * JpT @ R, w * np.swapaxes(R, -1, -2) @ R


def _local(poses_gt, feats_gt, ks, span, fsels):
    """Poses k+1..k+span-1 of each map k in ks in pose k's frame [K, span-1,
    6], and its selected landmarks in that frame (one array per map)."""
    R0 = euler_to_r(poses_gt[ks, 3:6])
    t0 = poses_gt[ks, 0:3]
    poses = []
    for s in range(1, span):
        p = poses_gt[ks + s]
        t = (R0 @ (p[:, 0:3] - t0)[..., None])[..., 0]
        ang = r_to_euler(euler_to_r(p[:, 3:6]) @ np.swapaxes(R0, 1, 2))
        poses.append(np.concatenate([t, ang], axis=1))
    n = np.array([len(f) for f in fsels])
    owner_map = np.repeat(np.arange(len(ks)), n)
    flat = np.concatenate(fsels)
    f = (R0[owner_map] @ (feats_gt[flat] - t0[owner_map])[..., None])[..., 0]
    return np.stack(poses, axis=1), np.split(f, np.cumsum(n)[:-1])


def _stereo_maps(poses_gt, feats_gt, owner, F, num_maps, noise, rng,
                 prior_w, covis_radius, covis_max):
    ks = np.arange(num_maps)
    fsels, pn, fn = [], [], []
    for k, e in zip(ks, _covis_all(num_maps, 2, poses_gt, feats_gt, owner,
                                   covis_radius, covis_max, rng)):
        fsels.append(np.concatenate([np.arange(k * F, (k + 2) * F), e]))
        if noise:
            pn.append(rng.normal(0, noise, (1, 6)))
            fn.append(rng.normal(0, noise, (len(fsels[-1]), 3)))
    lposes, lfeats = _local(poses_gt, feats_gt, ks, 2, fsels)
    poses, feats = [], []
    for k in ks:
        p, f = lposes[k], lfeats[k]
        if noise:
            p, f = p + pn[k], f + fn[k]
        poses.append(p)
        feats.append(f)
    n = np.array([len(f) for f in fsels])
    nmax = int(n.max())
    fpad = np.zeros((num_maps, nmax, 3))
    for k in ks:
        fpad[k, :n[k]] = feats[k]
    Hpp, Hpf, Hff = _obs_info(np.stack(poses), fpad)
    valid = (np.arange(nmax)[None] < n[:, None])[..., None, None]
    Hpp = np.where(valid, Hpp, 0.0)
    U = np.broadcast_to(prior_w * np.eye(6), (num_maps, 6, 6))
    for j in range(nmax):    # the original's order of additions
        U = U + Hpp[:, j]
    V = 25.0 * np.eye(3) + Hff
    maps = []
    for k in ks:
        maps.append(LocalMapData(
            np.array([k + 1]), poses[k], 1000 + fsels[k], feats[k],
            U[k][None], np.array([(0, 0)]), Hpf[k, :n[k]],
            np.stack([np.zeros(n[k], np.int64), np.arange(n[k])], axis=1),
            V[k, :n[k]], dict(type="stereo", ref=int(k))))
    return maps


def _mono_maps(poses_gt, feats_gt, owner, F, num_maps, noise, rng,
               prior_w, covis_radius, covis_max):
    ks = np.arange(num_maps)
    fsels, noises = [], []
    for k, e in zip(ks, _covis_all(num_maps, 3, poses_gt, feats_gt, owner,
                                   covis_radius, covis_max, rng)):
        fsels.append(np.concatenate([np.arange(k * F, (k + 3) * F), e]))
        if noise:
            noises.append((rng.normal(0, noise, 6), rng.normal(0, noise, 6),
                           rng.normal(0, noise, (len(fsels[-1]), 3))))
    lposes, lfeats = _local(poses_gt, feats_gt, ks, 3, fsels)
    fix = np.argmax(np.abs(lposes[:, 0, 0:3]), axis=1)
    p1fix = lposes[ks, 0, fix]
    sign = np.where(p1fix >= 0, 1, -1)
    scale = np.abs(p1fix)
    poses, feats = [], []
    for k in ks:
        p1, p2 = lposes[k, 0].copy(), lposes[k, 1].copy()
        f = lfeats[k] / scale[k]
        p1[0:3] /= scale[k]
        p2[0:3] /= scale[k]
        if noise:
            n2, na, nf = noises[k]
            p2 = p2 + n2
            na[fix[k]] = 0.0
            p1 = p1 + na
            f = f + nf
        p1[fix[k]] = float(sign[k])
        poses.append(np.stack([np.zeros(6), p1, p2]))
        feats.append(f)
    n = np.array([len(f) for f in fsels])
    nmax = int(n.max())
    fpad = np.zeros((num_maps, nmax, 1, 3))
    for k in ks:
        fpad[k, :n[k], 0] = feats[k]
    # slots 1 and 2 observe every landmark: [K, nmax, 2, ...]
    Hpp, Hpf, Hff = _obs_info(np.stack(poses)[:, None, 1:3], fpad)
    valid = (np.arange(nmax)[None] < n[:, None])[..., None, None]
    U0 = np.broadcast_to(prior_w * np.eye(6), (num_maps, 6, 6))
    U1 = U0
    for j in range(nmax):    # the original's order of additions
        U0 = U0 + np.where(valid[:, j], Hpp[:, j, 0], 0.0)
        U1 = U1 + np.where(valid[:, j], Hpp[:, j, 1], 0.0)
    V = 6.25 * np.eye(3) + Hff[:, :, 0] + Hff[:, :, 1]
    maps = []
    for k in ks:
        fx, nk = int(fix[k]), n[k]
        u0 = U0[k].copy()
        # the stored Hessian is the reduced one: the pinned coordinate's
        # row and column are zero (W lists (1, f), (2, f) landmark by
        # landmark, as the original appends them)
        u0[fx, :] = 0.0
        u0[:, fx] = 0.0
        W = Hpf[k, :nk].reshape(2 * nk, 6, 3).copy()
        W[0::2, fx, :] = 0.0
        Wpf = np.stack([np.tile([1, 2], nk), np.repeat(np.arange(nk), 2)],
                       axis=1)
        maps.append(LocalMapData(
            np.array([k, k + 1, k + 2]), poses[k], 1000 + fsels[k], feats[k],
            np.stack([u0, U1[k]]), np.array([(1, 1), (2, 2)]), W, Wpf,
            V[k, :nk],
            dict(type="mono", ref=int(k), scap=int(k) + 1, fix=fx,
                 sign=int(sign[k]))))
    return maps


def make_dataset(num_maps: int, datatype: str = "stereo",
                 feats_per_pose: int = 4, noise: float = 0.0, seed: int = 0,
                 pattern: str = "loop", covis_radius: float = 0.0,
                 covis_max: int = 0, prior_w: float = 100.0):
    """(maps: list[LocalMapData], poses_gt, feats_gt), as the original's
    `make_dataset` gives them; the truth is in the first map's gauge (and,
    for mono, its scale)."""
    span = 2 if datatype == "stereo" else 3
    P = num_maps + span - 1
    poses_gt, feats_gt, owner = make_world(P, feats_per_pose, seed=seed,
                                           pattern=pattern)
    rng = np.random.default_rng(seed + 12345)
    build = _stereo_maps if datatype == "stereo" else _mono_maps
    maps = build(poses_gt, feats_gt, owner, feats_per_pose, num_maps, noise,
                 rng, prior_w, covis_radius, covis_max)
    if datatype == "mono":
        scale = abs(poses_gt[1, maps[0].gauge["fix"]])
        poses_gt = poses_gt.copy()
        poses_gt[:, 0:3] /= scale
        feats_gt = feats_gt / scale
    return maps, poses_gt, feats_gt


def make_set(cfg: dict, mix: dict, seed: int, j: int) -> list:
    """Set j of a run started with `seed`, made from (seed, j) alone: the
    configuration's maps and data type, the traffic mix's parameters."""
    maps, _, _ = make_dataset(
        cfg["maps"], cfg["datatype"], feats_per_pose=mix["feats_per_pose"],
        noise=mix["noise"], seed=set_seed(seed, j), pattern=mix["pattern"],
        covis_radius=mix["covis_radius"], covis_max=mix["covis_max"])
    return maps


def set_seed(seed: int, j: int) -> int:
    """The generator seed of set j (-2**31 <= j < 2**31) of a run started
    with `seed` (any whole number, taken mod 2**96): distinct sets for
    distinct (seed, j)."""
    s, m = seed % 2**96, 0xFFFFFFFF
    ss = np.random.SeedSequence([s & m, (s >> 32) & m, s >> 64,
                                 (j + 2**31) & m])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(2))
