"""Ray/primitive math (twin of `raytracing_tpu.ops.intersect`).

Misses are t = +inf. `moller_trumbore` is the dense intersector the rest
set (small objects such as the ground plane) runs through; `ray_sphere`
gives an area light's shadow samples their distance to the light.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from raytracing_tpu_torch.ops.linalg import cross, dot

INF = float("inf")


class TriangleSoA(NamedTuple):
    """v0 = A and edges e1 = B - A, e2 = C - A, each [..., T, 3]."""

    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor


def moller_trumbore(o, d, tri: TriangleSoA, t_max,
                    eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Möller–Trumbore; shapes broadcast. Fails iff |det| < eps,
    u < 0, v < 0, u + v > 1, t <= eps or t >= t_max. Returns (t, valid),
    t = +inf where invalid."""
    pvec = cross(d, tri.e2)
    det = dot(tri.e1, pvec)
    ok_det = torch.abs(det) >= eps
    inv_det = 1.0 / torch.where(ok_det, det, torch.ones_like(det))
    s = o - tri.v0
    u = dot(s, pvec) * inv_det
    qvec = cross(s, tri.e1)
    v = dot(d, qvec) * inv_det
    t = dot(tri.e2, qvec) * inv_det
    valid = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps) \
        & (t < t_max)
    return torch.where(valid, t, torch.full_like(t, INF)), valid


def slab_test(o, inv_d, box_min, box_max, t_max) -> torch.Tensor:
    """Batched ray/AABB slab test; shapes broadcast, the last axis is xyz.
    True iff t_near <= min(t_far, t_max) and t_far >= 0."""
    t1 = (box_min - o) * inv_d
    t2 = (box_max - o) * inv_d
    t_near = torch.minimum(t1, t2).amax(dim=-1)
    t_far = torch.maximum(t1, t2).amin(dim=-1)
    if not isinstance(t_max, torch.Tensor):
        t_max = torch.tensor(t_max, dtype=t_far.dtype, device=t_far.device)
    return (t_near <= torch.minimum(t_far, t_max)) & (t_far >= 0.0)


def ray_sphere(o, d, center, radius, t_max,
               eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched ray/sphere, near root only. Returns (t, valid), t = +inf on
    a miss; valid iff the discriminant is positive and eps < t < t_max."""
    oc = o - center
    a = dot(d, d)
    half_b = dot(oc, d)
    c = dot(oc, oc) - radius * radius
    disc = half_b * half_b - a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t = (-half_b - sq) / torch.where(torch.abs(a) >= eps, a,
                                     torch.ones_like(a))
    valid = (disc > 0.0) & (t > eps) & (t < t_max)
    return torch.where(valid, t, torch.full_like(t, INF)), valid


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection r = d - 2 n (d·n)."""
    return d - 2.0 * n * dot(d, n)[..., None]


def triangle_normal(va, vb, vc, eps: float = 1e-20) -> torch.Tensor:
    """Geometric face normal normalize(cross(b - a, c - a))."""
    n = cross(vb - va, vc - va)
    n2 = dot(n, n)[..., None]
    return n / torch.sqrt(torch.clamp_min(n2, eps))
