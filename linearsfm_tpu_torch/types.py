"""Core data model: padded block-sparse local maps as torch tensors.

Counterpart of `linearsfm_tpu/types.py`, with the same fields and the same
id-based validity (``-1`` = dead/padding slot). A `LocalMap` is a plain
container: its fields are torch tensors on one device (the working form), or
numpy arrays (the host form that `compact_stack`, the planner and the tests
exchange). Every field carries the same leading shape: ``[]`` for one map,
``[P]`` for P lane-stacked maps — the explicit lane dimension that replaces
the reference's ``vmap`` over the pairs of a tree level. The map-level
functions of `ops/` and `core/` take lane-stacked maps.

Layout (see the reference module for the semantics of each field):

- ``pose_ids[M]``, ``feat_ids[N]``: int64 ids (int32 in the host form, as in
  the reference), ``-1`` padding.
- ``poses[M,6]`` ``(tx,ty,tz, alpha,beta,gamma)``, ``feats[N,3]``.
- ``U[KU,6,6]``/``Uij[KU,2]``, ``W[KW,6,3]``/``Wpf[KW,2]``, ``V[N,3,3]``:
  block-COO information with scatter-add semantics and implied symmetric
  completion of off-diagonal ``U`` blocks.
- ``n_poses``/``n_feats``/``n_U``/``n_W``: valid counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

GAUGE_FIELDS = ("ref", "scap", "fix", "sign", "fref", "fscap", "ffix")
MAP_FIELDS = ("pose_ids", "poses", "feat_ids", "feats", "U", "Uij", "W",
              "Wpf", "V", "n_poses", "n_feats", "n_U", "n_W")
INDEX = torch.int64   # index dtype of the working form


@dataclasses.dataclass(frozen=True)
class Gauge:
    """Gauge tags of a local map (integer scalars, or [P] per lane)."""

    ref: torch.Tensor    # reference pose id
    scap: torch.Tensor   # scale pose id (mono; -1 for stereo)
    fix: torch.Tensor    # pinned coordinate of scap (mono; -1 for stereo)
    sign: torch.Tensor   # sign of the pinned coordinate (+-1; mono)
    fref: torch.Tensor   # final (first map's) reference id
    fscap: torch.Tensor
    ffix: torch.Tensor

    @staticmethod
    def stereo(ref: int, fref: int | None = None) -> "Gauge":
        """Host-form stereo gauge (numpy int32 scalars, as the reference)."""
        i = np.int32
        return Gauge(i(ref), i(-1), i(-1), i(1),
                     i(ref if fref is None else fref), i(-1), i(-1))

    @staticmethod
    def mono(ref: int, scap: int, fix: int, sign: int = 1,
             fref: int | None = None, fscap: int | None = None,
             ffix: int | None = None) -> "Gauge":
        i = np.int32
        return Gauge(i(ref), i(scap), i(fix), i(sign),
                     i(ref if fref is None else fref),
                     i(scap if fscap is None else fscap),
                     i(fix if ffix is None else ffix))


@dataclasses.dataclass(frozen=True)
class LocalMap:
    """A (possibly merged, possibly lane-stacked) local map."""

    pose_ids: torch.Tensor  # [..., M]
    poses: torch.Tensor     # [..., M, 6]
    feat_ids: torch.Tensor  # [..., N]
    feats: torch.Tensor     # [..., N, 3]
    U: torch.Tensor         # [..., KU, 6, 6]
    Uij: torch.Tensor       # [..., KU, 2]
    W: torch.Tensor         # [..., KW, 6, 3]
    Wpf: torch.Tensor       # [..., KW, 2]
    V: torch.Tensor         # [..., N, 3, 3]
    n_poses: torch.Tensor   # [...]
    n_feats: torch.Tensor
    n_U: torch.Tensor
    n_W: torch.Tensor
    gauge: Gauge

    # ---- capacities --------------------------------------------------------
    @property
    def M(self) -> int:
        return self.poses.shape[-2]

    @property
    def N(self) -> int:
        return self.feats.shape[-2]

    @property
    def KU(self) -> int:
        return self.U.shape[-3]

    @property
    def KW(self) -> int:
        return self.W.shape[-3]

    @property
    def dtype(self):
        return self.poses.dtype

    # ---- id-based validity masks (working form) -----------------------------
    def pose_mask(self) -> torch.Tensor:
        return self.pose_ids >= 0

    def feat_mask(self) -> torch.Tensor:
        return self.feat_ids >= 0


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 if none: the
    reference's ``jnp.argmax`` on a bool array (torch's argmax takes no bool,
    and returns the first maximum)."""
    return mask.to(torch.int32).argmax(dim=-1)


def map_fields(lm: LocalMap, fn) -> LocalMap:
    """Apply `fn` to every array of `lm`, gauge tags included."""
    gauge = Gauge(*(fn(getattr(lm.gauge, f)) for f in GAUGE_FIELDS))
    return LocalMap(*(fn(getattr(lm, f)) for f in MAP_FIELDS), gauge=gauge)


def lanes(lm: LocalMap, idx) -> LocalMap:
    """Select lanes of a stacked map: an int, a slice, or a sequence of ints."""
    if not isinstance(idx, (int, slice)):
        idx = torch.as_tensor(idx, dtype=INDEX, device=lm.poses.device)
    return map_fields(lm, lambda a: a[idx].contiguous())


def cat(maps: list[LocalMap]) -> LocalMap:
    """Concatenate lane-stacked maps of equal capacities along the lanes."""
    if len(maps) == 1:
        return maps[0]

    def get(m, f):
        return getattr(m.gauge, f) if f in GAUGE_FIELDS else getattr(m, f)

    gauge = Gauge(*(torch.cat([get(m, f) for m in maps])
                    for f in GAUGE_FIELDS))
    return LocalMap(*(torch.cat([get(m, f) for m in maps])
                      for f in MAP_FIELDS), gauge=gauge)


def stack(maps: list[LocalMap]) -> LocalMap:
    """Stack single maps of equal capacities into [P, ...] lanes."""
    def get(m, f):
        return getattr(m.gauge, f) if f in GAUGE_FIELDS else getattr(m, f)

    gauge = Gauge(*(torch.stack([get(m, f) for m in maps])
                    for f in GAUGE_FIELDS))
    return LocalMap(*(torch.stack([get(m, f) for m in maps])
                      for f in MAP_FIELDS), gauge=gauge)


def host_fields(obj) -> LocalMap:
    """Host-form (numpy) LocalMap from any object with the LocalMap field
    names as arrays: a reference `LocalMap` after ``jax.device_get``, a
    stacked map, a host-form `LocalMap`, or a `synth.generate.SynthMap`
    (whose gauge is a dict and which has no valid counts)."""
    if isinstance(obj, LocalMap) and isinstance(obj.poses, torch.Tensor):
        return to_numpy(obj)
    g = obj.gauge
    if isinstance(g, dict):
        g = (Gauge.mono(g["ref"], g["scap"], g["fix"], g["sign"])
             if g["type"] == "mono" else Gauge.stereo(g["ref"]))
    gauge = Gauge(*(np.asarray(getattr(g, f), np.int32) for f in GAUGE_FIELDS))
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    fl = lambda x: np.asarray(x)  # noqa: E731  (float dtype kept as given)
    pose_ids, feat_ids = i32(obj.pose_ids), i32(obj.feat_ids)
    lead = pose_ids.shape[:-1]
    Uij = i32(obj.Uij).reshape(lead + (-1, 2))
    Wpf = i32(obj.Wpf).reshape(lead + (-1, 2))

    def count(name, default):
        v = getattr(obj, name, None)
        return i32(default) if v is None else i32(v)

    return LocalMap(
        pose_ids=pose_ids, poses=fl(obj.poses).reshape(lead + (-1, 6)),
        feat_ids=feat_ids, feats=fl(obj.feats).reshape(lead + (-1, 3)),
        U=fl(obj.U).reshape(lead + (-1, 6, 6)), Uij=Uij,
        W=fl(obj.W).reshape(lead + (-1, 6, 3)), Wpf=Wpf,
        V=fl(obj.V).reshape(lead + (-1, 3, 3)),
        n_poses=count("n_poses", pose_ids.shape[-1]),
        n_feats=count("n_feats", feat_ids.shape[-1]),
        n_U=count("n_U", Uij.shape[-2]), n_W=count("n_W", Wpf.shape[-2]),
        gauge=gauge)


def make_local_map(pose_ids, poses, feat_ids, feats, U, Uij, W, Wpf, V,
                   gauge: Gauge, dtype=np.float64) -> LocalMap:
    """Host-form LocalMap from exact-size (unpadded) arrays: ids and block
    coordinates int32, values in `dtype`, the valid counts the list
    lengths (the reference's `make_local_map`)."""
    f = lambda x: np.asarray(x, dtype)  # noqa: E731
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    pose_ids, feat_ids = i32(pose_ids), i32(feat_ids)
    Uij, Wpf = i32(Uij).reshape(-1, 2), i32(Wpf).reshape(-1, 2)
    return LocalMap(
        pose_ids=pose_ids, poses=f(poses).reshape(-1, 6),
        feat_ids=feat_ids, feats=f(feats).reshape(-1, 3),
        U=f(U).reshape(-1, 6, 6), Uij=Uij, W=f(W).reshape(-1, 6, 3), Wpf=Wpf,
        V=f(V).reshape(-1, 3, 3),
        n_poses=i32(len(pose_ids)), n_feats=i32(len(feat_ids)),
        n_U=i32(Uij.shape[0]), n_W=i32(Wpf.shape[0]), gauge=gauge)


def to_torch(obj, device) -> LocalMap:
    """Working-form LocalMap on `device`: integer fields become int64, float
    fields keep their dtype (float64 for every map the generator or the
    reference produces)."""
    host = host_fields(obj)

    def conv(a):
        t = torch.as_tensor(np.asarray(a))
        if not t.is_floating_point():
            t = t.to(INDEX)
        return t.to(device)

    return map_fields(host, conv)


def to_numpy(lm: LocalMap) -> LocalMap:
    """Host-form LocalMap: integer fields int32 (the reference's layout),
    float fields as they are."""
    def conv(a):
        a = a.detach().cpu().numpy()
        return a.astype(np.int32) if np.issubdtype(a.dtype, np.integer) else a

    return map_fields(lm, conv)


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def bucket(x: int, mult: int = 64) -> int:
    """Capacity bucket: next multiple of `mult` (at least `mult`)."""
    return max(mult, round_up(x, mult))
