"""Readers and writers of the reference's local-map text format.

Counterpart of `linearsfm_tpu/io/localmap.py`; the writers produce the same
bytes. Format (stereo, lmj_readInformationStereo, LinearSFMImp.cpp:3044-3131):

    Ref
    r                       # state length = 6m + 3n
    (stno stVal) * r        # stno: -poseId repeated 6x | featId repeated 3x
    m n
    nU  U[36*nU]  Ui[nU]  Uj[nU]
    nW  W[18*nW]  photo[nW]  feature[nW]   # feature-grouped, slot indices
    V[9*n]
    FBlock[n]

Mono (lmj_readInformationMono :6660-6753) prefixes the header with
``Ref ScaP Fix Sign``.

Reading is one whitespace-token sweep per file: the C tokenizer of
`native/` where it builds, else the same sweep in Python. Writing formats
each block of numbers with one ``%`` operation over the whole block (one
format string, one tuple) rather than one f-string per number; the text is
the reference writer's byte for byte: ``%.17g`` for local-map values, ``%f``
with the reference's spacing for poses, features and states.
"""

from __future__ import annotations

import os

import numpy as np

from .. import native, types


def _parse_python(path: str, is_mono: bool):
    """The C parser's result, tokenized in Python."""
    with open(path, "r") as fh:
        toks = fh.read().split()
    pos = 0

    def take(k, dt):
        nonlocal pos
        out = np.array(toks[pos:pos + k], dtype=dt)
        if len(out) != k:
            raise ValueError(f"malformed local map {path}")
        pos += k
        return out

    header = take(4 if is_mono else 1, np.int64)
    if not is_mono:
        header = np.array([header[0], -1, -1, 1], np.int64)
    r = int(take(1, np.int64)[0])
    pairs = take(2 * r, np.float64).reshape(r, 2)
    dims = take(2, np.int64)
    nU = int(take(1, np.int64)[0])
    U, Ui, Uj = take(36 * nU, np.float64), take(nU, np.int64), take(nU, np.int64)
    nW = int(take(1, np.int64)[0])
    W = take(18 * nW, np.float64)
    photo, feature = take(nW, np.int64), take(nW, np.int64)
    n = int(dims[1])
    V, fblock = take(9 * n, np.float64), take(n, np.int64)
    return (header, pairs[:, 0].astype(np.int64), pairs[:, 1], dims, U, Ui,
            Uj, W, photo, feature, V, fblock)


def parser_name() -> str:
    """Which tokenizer `read_local_map` uses: "C" or "Python"."""
    return "C" if native.get_fastparse() is not None else "Python"


def read_local_map(path: str, datatype: str,
                   dtype=np.float64) -> types.LocalMap:
    """Parse one localmap_<i>.txt into a host-form (numpy) LocalMap."""
    fp = native.get_fastparse()
    parse = fp.parse if fp is not None else _parse_python
    (hdr, stno, stval, dims, U, Ui, Uj, W, photo, feature, V,
     _fblock) = parse(path, datatype == "mono")
    ref, scap, fix, sign = (int(v) for v in hdr)
    m, n = (int(v) for v in dims)
    if datatype == "mono":
        gauge = types.Gauge.mono(ref, scap, fix, sign)
    else:
        gauge = types.Gauge.stereo(ref)
    return types.make_local_map(
        -stno[0:6 * m:6], stval[:6 * m].reshape(m, 6),
        stno[6 * m::3], stval[6 * m:].reshape(n, 3),
        U.reshape(-1, 6, 6), np.stack([Ui, Uj], 1),
        W.reshape(-1, 6, 3), np.stack([photo, feature], 1),
        V.reshape(-1, 3, 3), gauge, dtype=dtype)


def _lines(fmt: str, rows) -> str:
    """One line per row of `rows` (an [n, k] array), formatted by `fmt`
    (k conversions and the newline) in one `%` operation."""
    rows = np.asarray(rows, dtype=object).reshape(len(rows), -1)
    return (fmt * len(rows)) % tuple(rows.ravel().tolist())


def _numbers(values, conv: str) -> str:
    """Every value of `values` on a line of its own, by the conversion
    `conv` ("%.17g" for floats, "%d" for integers)."""
    flat = np.asarray(values).reshape(-1, 1)
    return _lines(conv + "\n", flat)


def write_local_map(path: str, lm_np: dict, datatype: str) -> None:
    """Write the reference text format from a dict of numpy arrays:
    pose_ids[m], poses[m,6], feat_ids[n], feats[n,3], U[nU,6,6], Uij[nU,2],
    W[nW,6,3], Wpf[nW,2], V[n,3,3] and the gauge dict (ref, and for mono
    scap, fix, sign). W is written grouped by feature (a stable sort) with
    FBlock[f] the first entry of feature f, -1 for an unobserved one.
    """
    g = lm_np["gauge"]
    pose_ids = np.asarray(lm_np["pose_ids"])
    feat_ids = np.asarray(lm_np["feat_ids"])
    m, n = len(pose_ids), len(feat_ids)
    U, Uij = np.asarray(lm_np["U"]), np.asarray(lm_np["Uij"])
    W, Wpf = np.asarray(lm_np["W"]), np.asarray(lm_np["Wpf"])
    order = np.argsort(Wpf[:, 1], kind="stable")
    W, Wpf = W[order], Wpf[order]
    fblock = np.full(n, -1, np.int64)
    feats_seen, first = np.unique(Wpf[:, 1], return_index=True)
    fblock[feats_seen] = first

    head = ([g["ref"], g["scap"], g["fix"], g["sign"]] if datatype == "mono"
            else [g["ref"]])
    # "-id value": the state's stno and value pairs, 6 per pose, 3 per feature
    stno = np.concatenate([np.repeat(-pose_ids.astype(np.int64), 6),
                           np.repeat(feat_ids.astype(np.int64), 3)])
    stval = np.concatenate([np.asarray(lm_np["poses"]).reshape(-1),
                            np.asarray(lm_np["feats"]).reshape(-1)])
    state = np.empty((len(stno), 2), dtype=object)
    state[:, 0] = stno.tolist()
    state[:, 1] = stval.tolist()
    parts = [
        _numbers(head + [6 * m + 3 * n], "%d"),
        _lines("%d %.17g\n", state),
        _numbers([m, n, len(U)], "%d"),
        _numbers(U, "%.17g"), _numbers(Uij[:, 0], "%d"),
        _numbers(Uij[:, 1], "%d"),
        _numbers([len(W)], "%d"),
        _numbers(W, "%.17g"), _numbers(Wpf[:, 0], "%d"),
        _numbers(Wpf[:, 1], "%d"),
        _numbers(lm_np["V"], "%.17g"), _numbers(fblock, "%d"),
    ]
    with open(path, "w") as fh:
        fh.write("".join(parts))


def write_dataset(maps, out_dir: str) -> None:
    """Write `maps` (`synth.generate.SynthMap`s: numpy fields and a gauge
    dict) as `localmap_<i>.txt`, i from 1, into `out_dir` (created if
    missing): the counterpart of `synth.generate.write_dataset`, whose
    `SynthMap.write` goes through the JAX package's writer."""
    os.makedirs(out_dir, exist_ok=True)
    for i, m in enumerate(maps):
        g = m.gauge
        write_local_map(
            os.path.join(out_dir, f"localmap_{i + 1}.txt"),
            dict(pose_ids=m.pose_ids, poses=m.poses, feat_ids=m.feat_ids,
                 feats=m.feats, U=m.U, Uij=m.Uij, W=m.W, Wpf=m.Wpf, V=m.V,
                 gauge=g), "mono" if g["type"] == "mono" else "stereo")


def _id_rows(ids, vals) -> np.ndarray:
    """[k, 1 + c] object rows: the id as a Python int, then the values."""
    vals = np.asarray(vals)
    rows = np.empty((len(ids), 1 + vals.shape[1]), dtype=object)
    rows[:, 0] = np.asarray(ids).astype(np.int64).tolist()
    rows[:, 1:] = vals.tolist()
    return rows


def write_poses(path: str, pose_ids, poses) -> None:
    """Pose file: `id tx ty tz a b g`, sorted by id (lmj_SavePoses_3DPF
    :7938-7948)."""
    order = np.argsort(pose_ids)
    rows = _id_rows(np.asarray(pose_ids)[order], np.asarray(poses)[order])
    with open(path, "w") as fh:
        fh.write(_lines("%d  %f  %f  %f %f  %f  %f\n", rows))


def write_features(path: str, feat_ids, feats) -> None:
    """Feature file: `id x y z`, sorted by id."""
    order = np.argsort(feat_ids)
    rows = _id_rows(np.asarray(feat_ids)[order], np.asarray(feats)[order])
    with open(path, "w") as fh:
        fh.write(_lines("%d  %f  %f %f\n", rows))


def write_state(path: str, pose_ids, poses, feat_ids, feats) -> None:
    """State vector as `(stno, value)` lines (lmj_SaveStateVector
    :2102-2117): 6 per pose (stno = -id), then 3 per feature."""
    stno = np.concatenate([np.repeat(-np.asarray(pose_ids, np.int64), 6),
                           np.repeat(np.asarray(feat_ids, np.int64), 3)])
    vals = np.concatenate([np.asarray(poses).reshape(-1),
                           np.asarray(feats).reshape(-1)])
    with open(path, "w") as fh:
        fh.write(_lines("%d %f\n", _id_rows(stno, vals[:, None])))


def read_poses(path: str):
    """(ids [k] int64, poses [k, 6]) of a pose file."""
    a = np.loadtxt(path).reshape(-1, 7)
    return a[:, 0].astype(np.int64), a[:, 1:7]


def read_features(path: str):
    """(ids [k] int64, feats [k, 3]) of a feature file."""
    a = np.loadtxt(path).reshape(-1, 4)
    return a[:, 0].astype(np.int64), a[:, 1:4]
