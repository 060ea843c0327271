"""Wavefront ray binning (twin of `raytracing_tpu.kernels.binning`).

Bounce rays are sorted by a compact integer key so that each 1024-ray
culling tile holds rays of one direction cone from nearby origins, which
keeps the tile's frustum (and so its visit list) small. Everything here is
permutation bookkeeping: results are moved back to the caller's order, so
binning never changes an image. The sort is a plain stable `torch.sort`
plus an index gather; under autograd a payload's gradient moves back by
the inverse permutation (twin of the JAX package's `_sort_cols` VJP).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raytracing_tpu_torch.utils.profiling import spanned

POS_BITS = 6   # per-axis quantization -> 18-bit Morton (64^3 cells)
DIR_BITS = 4   # 3-bit octant + 1 bit dominant-axis split -> 16 cones
_DEAD_KEY = 1 << 30


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so consecutive bits land 3 apart."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3(p: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
            bits: int = POS_BITS) -> torch.Tensor:
    """Morton code of points p [N, 3] quantized to 2^bits cells per axis
    inside [lo, hi] (clamped outside)."""
    top = 2.0 ** bits - 1.0
    scale = top / torch.clamp_min(hi - lo, 1e-20)
    q = torch.clamp((p - lo) * scale, 0.0, top).to(torch.int32)
    return (_spread3(q[:, 0]) << 2) | (_spread3(q[:, 1]) << 1) \
        | _spread3(q[:, 2])


def _octant(d: torch.Tensor) -> torch.Tensor:
    return ((d[:, 0] > 0).to(torch.int32) * 4
            + (d[:, 1] > 0).to(torch.int32) * 2
            + (d[:, 2] > 0).to(torch.int32))


def direction_bin(d: torch.Tensor) -> torch.Tensor:
    """16 cones: sign octant (3 bits) + dominant-axis bit."""
    ax = torch.abs(d)
    dom_z = (ax[:, 2] >= torch.maximum(ax[:, 0], ax[:, 1])).to(torch.int32)
    return _octant(d) * 2 + dom_z


def fine_direction_bin(d: torch.Tensor, ratio_bits: int = 2) -> torch.Tensor:
    """8 * 4^ratio_bits cones: sign octant + the two |component|/|max|
    ratios quantized to ratio_bits each."""
    ax = torch.abs(d)
    m = torch.clamp_min(torch.amax(ax, dim=1), 1e-9)
    q = 2 ** ratio_bits
    r0 = torch.clamp((ax[:, 0] / m * q).to(torch.int32), 0, q - 1)
    r1 = torch.clamp((ax[:, 1] / m * q).to(torch.int32), 0, q - 1)
    return (_octant(d) << (2 * ratio_bits)) | (r0 << ratio_bits) | r1


def _dead_last(key: torch.Tensor, alive: Optional[torch.Tensor]):
    if alive is None:
        return key
    return torch.where(alive, key, torch.full_like(key, _DEAD_KEY))


def ray_bin_order(o: torch.Tensor, d: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor, alive: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The permutation that groups rays by (origin cell, direction cone)
    (`bin_key`), dead rays last: (order, inv) i32; trace x[order], read
    results back through inv. `bin_sort` / `unsort` move payloads by the
    same stable order."""
    order = torch.argsort(bin_key(o, d, lo, hi, alive), stable=True)
    inv = torch.argsort(order, stable=True)
    return order.to(torch.int32), inv.to(torch.int32)


def bin_key(o, d, lo, hi, alive=None, pos_bits: int = POS_BITS,
            dir_ratio_bits: int = 0) -> torch.Tensor:
    """(origin Morton cell << dir bits) | direction cone; dead lanes get a
    key above every live key so they compact to the end."""
    if dir_ratio_bits > 0:
        db = fine_direction_bin(d, dir_ratio_bits)
        shift = 3 + 2 * dir_ratio_bits
    else:
        db = direction_bin(d)
        shift = DIR_BITS
    return _dead_last((morton3(o, lo, hi, bits=pos_bits) << shift) | db, alive)


def bounce_bin_key(o, d, lo, hi, alive=None) -> torch.Tensor:
    """The bounce-level key: 128 fine cones major x 8^3 origin cells."""
    key = (fine_direction_bin(d, 2) << 9) | morton3(o, lo, hi, bits=3)
    return _dead_last(key, alive)


def bin_sort(key: torch.Tensor, *payloads):
    """Stable sort of the payloads by key. Returns (sidx, sorted payloads);
    sidx[j] is the original index of sorted slot j (see `unsort`).
    Gradients of float payloads move back by the inverse permutation
    (autograd of the index); the permutation itself is detached."""
    sidx = torch.sort(key, stable=True).indices
    return sidx, tuple(p[sidx] for p in payloads)


@spanned("rt.unsort")
def unsort(sidx: torch.Tensor, *payloads):
    """Move payloads from sorted order back to the original order."""
    out = []
    for p in payloads:
        q = torch.empty_like(p)
        q[sidx] = p
        out.append(q)
    return tuple(out)


def scene_bounds(accel) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quantization box of the accel's cluster AABBs (the rest set,
    the ground plane, is not in them): (min, max) [3]."""
    return accel.cluster_min.amin(dim=0), accel.cluster_max.amax(dim=0)


def batch_bounds(o: torch.Tensor, alive: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantization box of the batch's alive ray origins; an all-dead batch
    collapses to the point 0."""
    if alive is None:
        return o.amin(dim=0), o.amax(dim=0)
    m = alive[:, None]
    lo = torch.where(m, o, torch.full_like(o, 3e38)).amin(dim=0)
    hi = torch.where(m, o, torch.full_like(o, -3e38)).amax(dim=0)
    ok = lo[0] <= hi[0]
    zero = torch.zeros_like(lo)
    return torch.where(ok, lo, zero), torch.where(ok, hi, zero)
