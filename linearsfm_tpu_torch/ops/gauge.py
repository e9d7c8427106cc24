"""Stereo gauge (coordinate) transforms of local maps.

Counterpart of `linearsfm_tpu/ops/gauge.py` (stereo part). Gauge = the 6-DOF
pose ``g`` of the new reference pose: pose ``(tb, Rb) -> (R (tb - t),
Rb R^T)``, feature ``f -> R (f - t)``; the slot holding the new reference is
reused for the old one, with value ``invpose(g)`` and the old reference id.
The transform is an involution, which `ops/congruence.py` relies on.
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


def transform_state_stereo(pose_ids, poses, feats, new_ref_id, old_ref_id):
    """Re-express every slot of each lane in the frame of pose `new_ref_id`.

    pose_ids [P, M], poses [P, M, 6], feats [P, N, 3], new_ref_id and
    old_ref_id [P]. Returns (pose_ids', poses', feats'); the slot of
    `new_ref_id` is re-tagged `old_ref_id` and holds invpose(g).
    """
    slot = first_true(pose_ids == new_ref_id[:, None])
    g = segment.take1(poses, slot)
    new_poses, new_feats, inv = stereo_batched(poses, feats, g)
    new_poses = segment.put1(new_poses, slot, inv)
    new_ids = segment.put1(pose_ids, slot, old_ref_id)
    return new_ids, new_poses, new_feats
