"""Gauge (coordinate and scale) transforms of local maps.

Counterpart of `linearsfm_tpu/ops/gauge.py`.

* Stereo: gauge = the 6-DOF pose ``g`` of the new reference pose: pose
  ``(tb, Rb) -> (R (tb - t), Rb R^T)``, feature ``f -> R (f - t)``; the slot
  holding the new reference is reused for the old one, with value
  ``invpose(g)`` and the old reference id.
* Mono: gauge = reference pose ``g`` + scale pose ``s`` + pinned axis
  ``fix``: ``scale = |[R (t_s - t)]_fix|``, and every translation and feature
  of the stereo-style transform is divided by it. Every pose, the reference
  included, is an explicit slot; the new reference lands at exactly 0 and the
  scale pose's pinned coordinate at exactly ``sign = +-1``.

The transforms are involutions, which `ops/congruence.py` relies on. `fix` is
an integer or an index tensor broadcast against the leading dims (one per
lane).
"""

from __future__ import annotations

import torch

from . import segment
from .rotations import euler_to_r, mat3_vec, r_to_euler, r_to_euler_t
from ..types import first_true


def invpose(g: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> pose of the old frame origin in g's frame: (-R t, euler(R^T))."""
    t, R = g[..., 0:3], euler_to_r(g[..., 3:6])
    return torch.cat([-mat3_vec(R, t), r_to_euler_t(R)], dim=-1)


def stereo_batched(poses: torch.Tensor, feats: torch.Tensor, g: torch.Tensor):
    """All per-block stereo maps plus the invpose lane.

    poses [..., M, 6], feats [..., N, 3], g [..., 6]. Returns
    (new_poses [..., M, 6] — the generic formula at every slot, not yet
    patched at the reference slot; new_feats [..., N, 3]; inv [..., 6]).
    """
    t = g[..., 0:3]
    angs = torch.cat([poses[..., 3:6], g[..., None, 3:6]], dim=-2)
    Rall = euler_to_r(angs)
    Rx, Rg = Rall[..., :-1, :, :], Rall[..., -1, :, :]
    RgT = Rg.transpose(-1, -2)
    tp = mat3_vec(Rg[..., None, :, :], poses[..., 0:3] - t[..., None, :])
    prods = Rx @ RgT[..., None, :, :]                 # R_i R^T per slot
    eulers = r_to_euler(torch.cat([prods, RgT[..., None, :, :]], dim=-3))
    new_poses = torch.cat([tp, eulers[..., :-1, :]], dim=-1)
    inv = torch.cat([-mat3_vec(Rg, t), eulers[..., -1, :]], dim=-1)
    new_feats = mat3_vec(Rg[..., None, :, :], feats - t[..., None, :])
    return new_poses, new_feats, inv


def stereo_state_at(poses, feats, slot):
    """The stereo re-expression of each lane about the pose at `slot` [P]:
    (poses', feats'), with invpose(g) written at that slot."""
    g = segment.take1(poses, slot)
    new_poses, new_feats, inv = stereo_batched(poses, feats, g)
    return segment.put1(new_poses, slot, inv), new_feats


def transform_state_stereo(pose_ids, poses, feats, new_ref_id, old_ref_id):
    """Re-express every slot of each lane in the frame of pose `new_ref_id`.

    pose_ids [P, M], poses [P, M, 6], feats [P, N, 3], new_ref_id and
    old_ref_id [P]. Returns (pose_ids', poses', feats'); the slot of
    `new_ref_id` is re-tagged `old_ref_id` and holds invpose(g).
    """
    slot = first_true(pose_ids == new_ref_id[:, None])
    new_poses, new_feats = stereo_state_at(poses, feats, slot)
    new_ids = segment.put1(pose_ids, slot, old_ref_id)
    return new_ids, new_poses, new_feats


def _scale_sign(ts: torch.Tensor, fix):
    """(|ts[..., fix]|, sgn0(ts[..., fix])) with sign(0) := +1. The sign
    is a select, so it carries no tangent."""
    fix = torch.as_tensor(fix, device=ts.device).expand(ts.shape[:-1])
    tsf = ts.gather(-1, fix[..., None])[..., 0]
    one = torch.ones_like(tsf)
    sign = torch.where(tsf >= 0, one, -one)
    return tsf * sign, sign


def mono_batched(poses, feats, g, s, fix):
    """All per-block mono maps of each lane in one batched call.

    poses [..., M, 6], feats [..., N, 3], g [..., 6], s [..., 3], fix [...].
    Returns (new_poses — the generic formula, not yet gauge-pinned;
    new_feats; sign [...]). No invpose lane: the mono reference pose is an
    explicit block.
    """
    t = g[..., 0:3]
    angs = torch.cat([poses[..., 3:6], g[..., None, 3:6]], dim=-2)
    Rall = euler_to_r(angs)
    Rx, Rg = Rall[..., :-1, :, :], Rall[..., -1, :, :]
    scale, sign = _scale_sign(mat3_vec(Rg, s - t), fix)
    sc = scale[..., None, None]
    tp = mat3_vec(Rg[..., None, :, :], poses[..., 0:3] - t[..., None, :]) / sc
    eulers = r_to_euler(Rx @ Rg.transpose(-1, -2)[..., None, :, :])
    new_poses = torch.cat([tp, eulers], dim=-1)
    new_feats = mat3_vec(Rg[..., None, :, :], feats - t[..., None, :]) / sc
    return new_poses, new_feats, sign


def transform_state_mono(pose_ids, poses, feats, new_ref_id, new_scap_id,
                         new_fix):
    """Mono re-expression of every slot of each lane; pose ids are unchanged.

    pose_ids [P, M], poses [P, M, 6], feats [P, N, 3], new_ref_id,
    new_scap_id, new_fix [P]. Returns (poses', feats', sign [P]): the new
    reference block is exactly 0 and the new scale pose's pinned coordinate
    exactly `sign`, both written, not computed.
    """
    slot_r = first_true(pose_ids == new_ref_id[:, None])
    slot_s = first_true(pose_ids == new_scap_id[:, None])
    return mono_state_at(poses, feats, slot_r, slot_s, new_fix)


def mono_state_at(poses, feats, slot_r, slot_s, new_fix):
    """The mono re-expression of each lane about the new reference at
    `slot_r` and scale pose at `slot_s` ([P] each): (poses', feats', sign),
    the gauge pins written (see transform_state_mono)."""
    g = segment.take1(poses, slot_r)
    s = segment.take1(poses, slot_s)[:, 0:3]
    new_poses, new_feats, sign = mono_batched(poses, feats, g, s, new_fix)
    new_poses = segment.put1(new_poses, slot_r, 0.0)
    pinned = torch.arange(6, device=poses.device) == new_fix[:, None]
    row = torch.where(pinned, sign[:, None], segment.take1(new_poses, slot_s))
    return segment.put1(new_poses, slot_s, row), new_feats, sign
