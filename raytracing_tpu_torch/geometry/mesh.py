"""SoA mesh/scene containers (twin of `raytracing_tpu.geometry.mesh`).

One global vertex pool, one triangle pool, a per-triangle object id into a
material table. Fields are torch tensors; `to(device)` moves a container.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from raytracing_tpu_torch.ops.intersect import TriangleSoA


class Mesh(NamedTuple):
    """verts [V, 3] f32, tri_v [T, 3] i32, normals [T, 3] f32 (stored face
    normals), colors [T, 3] f32, obj_id [T] i32, materials [O, 3] f32
    (albedo/pi, reflectivity, roughness), obj_bounds [O, 2, 3] f32."""

    verts: torch.Tensor
    tri_v: torch.Tensor
    normals: torch.Tensor
    colors: torch.Tensor
    obj_id: torch.Tensor
    materials: torch.Tensor
    obj_bounds: torch.Tensor

    @property
    def num_triangles(self) -> int:
        return self.tri_v.shape[0]

    @property
    def num_objects(self) -> int:
        return self.materials.shape[0]

    def to(self, device) -> "Mesh":
        return Mesh(*(f.to(device) for f in self))


class SphereLight(NamedTuple):
    """Spherical area lights: center [L, 3], radius [L], emission [L, 3]
    (radiance of the emitting surface), all f32."""

    center: torch.Tensor
    radius: torch.Tensor
    emission: torch.Tensor

    def to(self, device) -> "SphereLight":
        return SphereLight(*(f.to(device) for f in self))


class Scene(NamedTuple):
    """Mesh, the sun's position [3], and optional area lights."""

    mesh: Mesh
    sun: torch.Tensor
    lights: Optional[SphereLight] = None

    def to(self, device) -> "Scene":
        return Scene(self.mesh.to(device), self.sun.to(device),
                     None if self.lights is None else self.lights.to(device))


def triangle_soa(verts: torch.Tensor, tri_v: torch.Tensor) -> TriangleSoA:
    """v0 | e1 | e2 of triangles tri_v [T, 3] gathered from the vertex pool
    verts, so gradients reach verts (the brute-force backend's input)."""
    tv = tri_v.long()
    va, vb, vc = verts[tv[:, 0]], verts[tv[:, 1]], verts[tv[:, 2]]
    return TriangleSoA(v0=va, e1=vb - va, e2=vc - va)


def concat_objects(objects: Sequence[dict]) -> Mesh:
    """Build a CPU Mesh from per-object dicts: verts [V, 3], tri_v [T, 3],
    colors [T, 3] or [3], material (albedo, reflectivity, roughness) with
    raw albedo (divided by pi here), optional normals [T, 3]."""
    all_v, all_t, all_n, all_c, all_o = [], [], [], [], []
    mats, bounds = [], []
    v_off = 0
    for oi, ob in enumerate(objects):
        verts = np.asarray(ob["verts"], dtype=np.float32)
        tri_v = np.asarray(ob["tri_v"], dtype=np.int32)
        colors = np.asarray(ob["colors"], dtype=np.float32)
        if colors.ndim == 1:
            colors = np.broadcast_to(colors, (tri_v.shape[0], 3)).copy()
        normals = ob.get("normals")
        if normals is None:
            va, vb, vc = (verts[tri_v[:, k]] for k in range(3))
            n = np.cross(vb - va, vc - va)
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            normals = n.astype(np.float32)
        else:
            normals = np.asarray(normals, dtype=np.float32)
        albedo, refl, rough = ob["material"]
        mats.append((albedo / np.pi, refl, rough))
        bounds.append((verts.min(axis=0), verts.max(axis=0)))
        all_v.append(verts)
        all_t.append(tri_v + v_off)
        all_n.append(normals)
        all_c.append(colors)
        all_o.append(np.full(tri_v.shape[0], oi, dtype=np.int32))
        v_off += verts.shape[0]
    return Mesh(
        verts=torch.from_numpy(np.concatenate(all_v)),
        tri_v=torch.from_numpy(np.concatenate(all_t).astype(np.int32)),
        normals=torch.from_numpy(np.concatenate(all_n)),
        colors=torch.from_numpy(np.concatenate(all_c)),
        obj_id=torch.from_numpy(np.concatenate(all_o)),
        materials=torch.from_numpy(np.array(mats, dtype=np.float32)),
        obj_bounds=torch.from_numpy(
            np.stack([np.stack(b) for b in bounds]).astype(np.float32)),
    )


def scene_from_numpy(d: dict, device="cuda") -> Scene:
    """A Scene from numpy arrays under the JAX package's field names (the
    Mesh fields plus "sun", and optionally "lights": a mapping with center
    [L, 3], radius [L] and emission [L, 3]) — how tests hand both packages
    one scene. It lands on the card unless `device` says otherwise."""
    mesh = Mesh(*(torch.tensor(np.ascontiguousarray(d[f]))
                  for f in Mesh._fields))
    sun = torch.tensor(np.asarray(d["sun"], dtype=np.float32))
    lights = d.get("lights")
    if lights is not None:
        lights = SphereLight(*(
            torch.tensor(np.ascontiguousarray(lights[f], dtype=np.float32))
            for f in SphereLight._fields))
    return Scene(mesh=mesh, sun=sun, lights=lights).to(device)
