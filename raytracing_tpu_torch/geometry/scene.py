"""The default scene: two teapots and a ground plane (twin of
`raytracing_tpu.geometry.scene`). Teapot #1 at (-0.9, -2, 9), emerald;
teapot #2 at (3, -2, 6), red; a +/-10,000 ground quad at y = -3 with both
normals forced to +y. 12,642 triangles. The sun orbits with time t. Also
the single teapot and its midpoint-subdivided forms (404k triangles at 3
levels, 1.6M at 4, 6.4M at 5).

Every function here places its tensors on the card (`device="cuda"`) unless the
caller names another device; with no card that raises."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from raytracing_tpu_torch import config as cfg
from raytracing_tpu_torch.geometry.mesh import Mesh, Scene, concat_objects
from raytracing_tpu_torch.geometry.obj import read_obj

ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets")
TEAPOT_OBJ = os.path.join(ASSET_DIR, "teapot.obj")


def ground_plane_object(half_extent: float = 10_000.0, y: float = -3.0,
                        color=cfg.GROUND_COLOR,
                        material=cfg.GROUND_MATERIAL) -> dict:
    verts = np.array([[-half_extent, y, -half_extent],
                      [-half_extent, y, half_extent],
                      [half_extent, y, half_extent],
                      [half_extent, y, -half_extent]], dtype=np.float32)
    return {
        "verts": verts,
        "tri_v": np.array([[0, 1, 2], [0, 3, 2]], dtype=np.int32),
        "colors": np.asarray(color, dtype=np.float32),
        "normals": np.array([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]],
                            dtype=np.float32),
        "material": material,
    }


def build_default_mesh(obj_path: Optional[str] = None,
                       device="cuda") -> Mesh:
    obj_path = obj_path or TEAPOT_OBJ
    return concat_objects([
        read_obj(obj_path, offset=(-0.9, -2.0, 9.0), color=cfg.TEAPOT1_COLOR,
                 material=cfg.TEAPOT1_MATERIAL),
        read_obj(obj_path, offset=(3.0, -2.0, 6.0), color=cfg.TEAPOT2_COLOR,
                 material=cfg.TEAPOT2_MATERIAL),
        ground_plane_object(),
    ]).to(device)


def sun_position(t: float) -> torch.Tensor:
    """Far-away point light on the reference's orbit (f32 math)."""
    a = torch.tensor(t / 10.0, dtype=torch.float32)
    return torch.stack([torch.sin(a) * 100_000.0,
                        torch.tensor(25_000.0, dtype=torch.float32),
                        torch.cos(a) * 100_000.0])


def build_default_scene(t: float = 0.0, obj_path: Optional[str] = None,
                        device="cuda") -> Scene:
    return Scene(mesh=build_default_mesh(obj_path, device=device),
                 sun=sun_position(t).to(device))


def teapot_only_mesh(offset=(0.0, 0.0, 3.0), color=(0.8, 0.8, 0.8),
                     material=(1.0, 0.0, 1.0),
                     obj_path: Optional[str] = None, device="cuda") -> Mesh:
    """Single-teapot mesh (6,320 triangles)."""
    return concat_objects([read_obj(obj_path or TEAPOT_OBJ, offset=offset,
                                    color=color, material=material)]
                          ).to(device)


def subdivided_teapot_mesh(levels: int = 3, offset=(0.0, 0.0, 3.0),
                           color=(0.8, 0.8, 0.8), material=(1.0, 0.0, 1.0),
                           obj_path: Optional[str] = None,
                           device="cuda") -> Mesh:
    """Midpoint-subdivided teapot for large scenes: 6,320 * 4^levels
    triangles on exactly the teapot's surface (levels=3 -> 404k,
    4 -> 1.6M, 5 -> 6.4M)."""
    from raytracing_tpu_torch.geometry.subdivide import subdivide_arrays

    ob = read_obj(obj_path or TEAPOT_OBJ, offset=offset, color=color,
                  material=material)
    verts, tri_v = subdivide_arrays(ob["verts"], ob["tri_v"], levels)
    return concat_objects([{
        "verts": verts,
        "tri_v": tri_v,
        "colors": np.asarray(color, dtype=np.float32),
        "material": material,
    }]).to(device)
