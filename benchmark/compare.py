"""The comparison that decides `correct`: a fused map the program returned
against the plain reference's (`reference.solve_tree`) for the same maps.

Both are read by id, so neither's slot order matters:
* `id_mismatch`: pose and landmark ids held by one side and not the other
  (exact: the limit is 0);
* `pose_gap`: the largest difference of a pose coordinate (angles wrapped
  into (-pi, pi]);
* `feat_gap`: the largest difference of a landmark coordinate;
* `info_gap`: the largest difference of an information entry, over the
  reference's largest entry.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from . import reference


def program_map(out) -> reference.Level:
    """The program's fused map `out` (an object with the port's LocalMap
    fields as tensors, on any device) as a one-map reference `Level`: its
    valid poses and landmarks in slot order, and its information lists
    summed into one symmetric matrix."""
    h = {f: getattr(out, f).detach().cpu().numpy()
         for f in ("pose_ids", "poses", "feat_ids", "feats", "U", "Uij",
                   "W", "Wpf", "V")}
    pv, fv = h["pose_ids"] >= 0, h["feat_ids"] >= 0
    pslot, fslot = np.cumsum(pv) - 1, np.cumsum(fv) - 1
    Uij, Wpf = h["Uij"].astype(np.int64), h["Wpf"].astype(np.int64)
    u = pv[Uij[:, 0]] & pv[Uij[:, 1]]
    w = pv[Wpf[:, 0]] & fv[Wpf[:, 1]]
    m = SimpleNamespace(
        pose_ids=h["pose_ids"][pv], poses=h["poses"][pv],
        feat_ids=h["feat_ids"][fv], feats=h["feats"][fv], U=h["U"][u],
        Uij=pslot[Uij[u]], W=h["W"][w],
        Wpf=np.stack([pslot[Wpf[w, 0]], fslot[Wpf[w, 1]]], axis=1),
        V=h["V"][fv], gauge=dict(type="stereo", ref=-1))
    return reference.from_inputs([m], np.float64)


def _by_id(m: reference.Level):
    """(pose order, landmark order, coordinate permutation) putting m's
    rows in ascending id order."""
    po, fo = np.argsort(m.pid), np.argsort(m.fid)
    perm = np.concatenate([m.pc(po).ravel(), m.fc(fo).ravel()])
    return po, fo, perm


def _angle_gap(a, b):
    return np.abs(np.mod(a - b + np.pi, 2 * np.pi) - np.pi)


def gaps(got: reference.Level, want: reference.Level) -> dict:
    """The compared numbers of one fused map (see the module's doc)."""
    mism = (len(np.setxor1d(got.pid, want.pid))
            + len(np.setxor1d(got.fid, want.fid)))
    out = dict(id_mismatch=float(mism), pose_gap=np.inf, feat_gap=np.inf,
               info_gap=np.inf)
    if (mism or len(got.pid) != len(want.pid)
            or len(got.fid) != len(want.fid)):
        out["id_mismatch"] = float(max(mism, 1))
        return out
    gp, gf, gperm = _by_id(got)
    wp, wf, wperm = _by_id(want)
    a = got.X[gp].astype(np.float64)
    b = want.X[wp].astype(np.float64)
    out["pose_gap"] = float(max(np.abs(a[:, 0:3] - b[:, 0:3]).max(),
                                _angle_gap(a[:, 3:6], b[:, 3:6]).max()))
    out["feat_gap"] = float(np.abs(got.F[gf].astype(np.float64)
                                   - want.F[wf]).max())
    gi = got.info.astype(np.float64)[gperm][:, gperm]
    wi = want.info.astype(np.float64)[wperm][:, wperm]
    d = (gi - wi).tocsr()
    out["info_gap"] = float(abs(d).max() / abs(wi).max()) if d.nnz else 0.0
    return {k: (v if np.isfinite(v) else np.inf) for k, v in out.items()}


def finite_flag(out):
    """A one-element device tensor: True when every valid pose and
    landmark state of the program's fused map is finite (read without
    waiting for the device)."""
    import torch
    pv = (out.pose_ids >= 0)[..., None]
    fv = (out.feat_ids >= 0)[..., None]
    return (torch.isfinite(torch.where(pv, out.poses, 0.0)).all()
            & torch.isfinite(torch.where(fv, out.feats, 0.0)).all())

