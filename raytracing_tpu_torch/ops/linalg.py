"""Small-vector math on trailing-dim-3 tensors (twin of
`raytracing_tpu.ops.linalg`).

Sums over the 3-axis are written out as ((x0 + x1) + x2), the order the
JAX package's reductions use, so CPU and CUDA tensors round the same way.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def normalize(a: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Normalize over the trailing axis; eps > 0 guards the zero vector."""
    n2 = dot(a, a)[..., None]
    if eps:
        n2 = torch.clamp_min(n2, eps)
    return a / torch.sqrt(n2)


def sqrt0(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)) whose gradient is 0 where x <= 0: the same values,
    but no inf (sqrt's slope at 0) that a zero cotangent turns into NaN.
    A cone sampled around a light at 1e4 units has cos_max = 1 in f32 and
    so a sine of exactly 0."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def device_scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """`value` as a 0-dim f32 tensor on `like`'s device. Dividing by it is
    an IEEE division on every device; PyTorch's CUDA division by a Python
    number multiplies by the number's rounded reciprocal instead."""
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)
