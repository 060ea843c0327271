"""Scatter and light sampling (twin of `raytracing_tpu.ops.sampling`).

The JAX package draws its uniforms inside `cosine_hemisphere` and
`sample_cone` from a `jax.random` key. Here the caller draws them (from a
`torch.Generator`, or hands in the exact array JAX drew) and passes them
in, so each sampler is a pure function of its uniforms and its axis.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from raytracing_tpu_torch.ops.linalg import cross, normalize, sqrt0


def tangent_frame(n: torch.Tensor, eps: float = 1e-6
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Orthonormal tangents (t1, t2) for normals n [..., 3]: the arbitrary
    axis is Z when |n.z| < eps, else X."""
    z_small = torch.abs(n[..., 2]) < eps
    z_axis = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    arb = torch.where(z_small[..., None], z_axis, x_axis)
    t1 = normalize(cross(n, arb), eps=1e-20)
    t2 = normalize(cross(n, t1), eps=1e-20)
    return t1, t2


def cosine_hemisphere(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted directions about normals n [N, 3] from uniforms
    u [..., N, 2]: sin_theta = sqrt(u0), cos_theta = sqrt(1 - u0),
    psi = 2 pi u1. Returns [..., N, 3]."""
    sin_theta = torch.sqrt(u[..., 0])
    cos_theta = sqrt0(1.0 - u[..., 0])
    psi = 2.0 * math.pi * u[..., 1]
    a = sin_theta * torch.cos(psi)
    b = sin_theta * torch.sin(psi)
    t1, t2 = tangent_frame(n)
    d = a[..., None] * t1 + b[..., None] * t2 + cos_theta[..., None] * n
    return normalize(d, eps=1e-20)


def sample_cone(u: torch.Tensor, axis: torch.Tensor,
                cos_max: torch.Tensor) -> torch.Tensor:
    """Uniform directions inside the cones of half-angle acos(cos_max [N])
    around unit axes [N, 3], from uniforms u [..., N, 2] — the solid-angle
    sampler of a spherical light: cos_theta = 1 - u0 (1 - cos_max),
    psi = 2 pi u1; pdf = 1 / (2 pi (1 - cos_max)). Returns [..., N, 3]."""
    cos_t = 1.0 - u[..., 0] * (1.0 - cos_max)
    sin_t = sqrt0(1.0 - cos_t * cos_t)
    psi = 2.0 * math.pi * u[..., 1]
    t1, t2 = tangent_frame(axis)
    d = ((sin_t * torch.cos(psi))[..., None] * t1
         + (sin_t * torch.sin(psi))[..., None] * t2
         + cos_t[..., None] * axis)
    return normalize(d, eps=1e-20)


def stratified_grid(spp: int) -> Tuple[int, int]:
    """(gx, gy) with gx * gy == spp, closest to square."""
    if spp < 1:
        raise ValueError("spp must be >= 1")
    gx = int(spp ** 0.5)
    while spp % gx:
        gx -= 1
    return gx, spp // gx


def stratified_offsets(spp: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """Sub-pixel sample offsets [spp, 2] at the cell centers of the
    gx x gy grid. Computed on the CPU and moved, so every device gets the
    same bits (CUDA divides by a Python number through its reciprocal)."""
    gx, gy = stratified_grid(spp)
    cx = (torch.arange(gx, dtype=dtype) + 0.5) / gx
    cy = (torch.arange(gy, dtype=dtype) + 0.5) / gy
    xx, yy = torch.meshgrid(cx, cy, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1).to(device)
