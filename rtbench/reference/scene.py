"""The reference's scene: its own OBJ reader, midpoint subdivision and
triangle tables, worked out from a configuration file's `scene` block.

Plain numpy and torch; nothing of the program is imported. Triangle ids
follow the order the configuration lists its objects in, each object's
faces in file order (fans of a polygon in order), and each subdivision
level as four blocks of the level's triangles: (a, ab, ca), (ab, b, bc),
(ca, bc, c), (ab, bc, ca), with one shared midpoint per undirected edge
numbered in the order of the sorted edge keys.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read_obj(path: str):
    """(verts [V, 3] f32, faces [T, 3] i64) from an OBJ's `v` and `f` lines:
    1-based or negative indices, `v/vt/vn` tokens, polygons as fans."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, dtype=np.float32),
            np.asarray(faces, dtype=np.int64).reshape(-1, 3))


def subdivide(verts: np.ndarray, faces: np.ndarray, levels: int):
    """Midpoint (1:4) subdivision, `levels` times."""
    for _ in range(levels):
        nv = verts.shape[0]
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        first = np.concatenate([a, b, c])
        second = np.concatenate([b, c, a])
        key = np.minimum(first, second) * nv + np.maximum(first, second)
        edges, which = np.unique(key, return_inverse=True)
        lo, hi = edges // nv, edges % nv
        verts = np.concatenate(
            [verts, ((verts[lo] + verts[hi]) * np.float32(0.5))
             .astype(np.float32)])
        t = faces.shape[0]
        ab, bc, ca = nv + which[:t], nv + which[t:2 * t], nv + which[2 * t:]
        faces = np.concatenate([np.stack(f, axis=1) for f in (
            (a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca))])
    return verts, faces


class RefScene(NamedTuple):
    """Per-triangle tables, f32 on one device: v0, e1, e2 [T, 3] (v0 = A,
    e1 = B - A, e2 = C - A), normal [T, 3] (stored face normals), color
    [T, 3], albedo_pi, refl, rough [T]."""

    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    normal: torch.Tensor
    color: torch.Tensor
    albedo_pi: torch.Tensor
    refl: torch.Tensor
    rough: torch.Tensor

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]


def _color(ob: dict) -> np.ndarray:
    if "color_u8" in ob:
        return np.asarray([c / 255.0 for c in ob["color_u8"]],
                          dtype=np.float32)
    return np.asarray(ob["color"], dtype=np.float32)


def object_arrays(ob: dict):
    """(verts f32, faces i64, normals f32 or None) of one object entry:
    {"mesh": file under rtbench/scenes, "offset", "subdivide"} or
    {"plane": {"half_extent", "y"}} (two triangles facing +y)."""
    if "plane" in ob:
        h, y = float(ob["plane"]["half_extent"]), float(ob["plane"]["y"])
        verts = np.array([[-h, y, -h], [-h, y, h], [h, y, h], [h, y, -h]],
                         dtype=np.float32)
        faces = np.array([[0, 1, 2], [0, 3, 2]], dtype=np.int64)
        return verts, faces, np.array([[0.0, 1.0, 0.0]] * 2, np.float32)
    verts, faces = read_obj(os.path.join(HERE, "scenes", ob["mesh"]))
    verts = verts + np.asarray(ob.get("offset", (0, 0, 0)), np.float32)
    verts, faces = subdivide(verts, faces, int(ob.get("subdivide", 0)))
    return verts, faces, None


def build_scene(scene_cfg: dict, device="cpu",
                dtype=torch.float32) -> RefScene:
    """The configuration's objects as one triangle table on `device`, its
    floating tables in `dtype` (float32 for the reference; a lower
    precision for the control)."""
    parts = {k: [] for k in RefScene._fields}
    for ob in scene_cfg["objects"]:
        verts, faces, normals = object_arrays(ob)
        va, vb, vc = (verts[faces[:, k]] for k in range(3))
        if normals is None:
            n = np.cross(vb - va, vc - va)
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                               1e-20)
            normals = n.astype(np.float32)
        t = faces.shape[0]
        albedo, refl, rough = ob["material"]
        parts["v0"].append(va)
        parts["e1"].append(vb - va)
        parts["e2"].append(vc - va)
        parts["normal"].append(normals)
        parts["color"].append(np.broadcast_to(_color(ob), (t, 3)))
        for k, v in (("albedo_pi", np.float32(albedo / math.pi)),
                     ("refl", np.float32(refl)), ("rough", np.float32(rough))):
            parts[k].append(np.full(t, v, dtype=np.float32))
    return RefScene(**{
        k: torch.from_numpy(np.ascontiguousarray(np.concatenate(v)))
        .to(device=device, dtype=dtype) for k, v in parts.items()})


def sun_position(t: float) -> np.ndarray:
    """The sun on the upstream orbit at time t: (sin(t/10) 1e5, 2.5e4,
    cos(t/10) 1e5), in f32."""
    a = np.float32(np.float32(t) / np.float32(10.0))
    return np.array([np.sin(a) * np.float32(100_000.0), 25_000.0,
                     np.cos(a) * np.float32(100_000.0)], dtype=np.float32)
