"""Differentiable rigid transforms for inverse rendering (twin of
`raytracing_tpu.geometry.transform`): a 6-dof pose (axis-angle rotation and
translation) applied to one object's vertices inside the loss, so the pose
stays a live parameter.
"""

from __future__ import annotations

from typing import Optional

import torch

from raytracing_tpu_torch.geometry.mesh import Mesh


def _hat(w: torch.Tensor) -> torch.Tensor:
    """The cross-product matrix [w]x of w [3]."""
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.stack([torch.stack([zero, -w[2], w[1]]),
                        torch.stack([w[2], zero, -w[0]]),
                        torch.stack([-w[1], w[0], zero])])


def rotation_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula for axis_angle [3] -> [3, 3]; below an angle of
    1e-5 the first-order I + [w]x, so it differentiates at the identity."""
    theta = torch.sqrt((axis_angle * axis_angle).sum() + 1e-20)
    k = _hat(axis_angle / theta)
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    r = eye + torch.sin(theta) * k + (1.0 - torch.cos(theta)) * (k @ k)
    return torch.where(theta < 1e-5, eye + _hat(axis_angle), r)


def apply_pose(mesh: Mesh, pose: torch.Tensor, obj_index: int,
               pivot: Optional[torch.Tensor] = None) -> Mesh:
    """The mesh with pose [rx, ry, rz, tx, ty, tz] applied to the vertices
    of object obj_index (rotation about their centroid unless `pivot` [3]
    is given); differentiable with respect to the pose and the vertices."""
    rot = rotation_matrix(pose[:3])
    verts = mesh.verts
    touched = torch.zeros(verts.shape[0], dtype=torch.bool,
                          device=verts.device)
    touched[mesh.tri_v[mesh.obj_id == obj_index].reshape(-1).long()] = True
    if pivot is None:
        w = touched.to(verts.dtype)[:, None]
        pivot = (verts * w).sum(dim=0) / torch.clamp_min(w.sum(), 1.0)
    moved = (verts - pivot) @ rot.T + pivot + pose[3:]
    return mesh._replace(verts=torch.where(touched[:, None], moved, verts))
