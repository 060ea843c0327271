"""Pinhole camera rays in 16x16 pixel-block order (twin of
`raytracing_tpu.models.camera`).

Origin at 0 looking down +z, focal plane z = 1, direction
(xx, yy, 1) with xx = (2 (x + ox) / W - 1) * aspect * scale and
yy = (1 - 2 (y + oy) / H) * scale, left unnormalized. The f32 op order is
the JAX package's, so the rays are bit-identical — on the card too, where
W and H go in as device scalars (`device_scalar`): PyTorch's CUDA division
by a Python number multiplies by its rounded reciprocal instead.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raytracing_tpu_torch.config import RenderConfig
from raytracing_tpu_torch.ops.linalg import device_scalar
from raytracing_tpu_torch.ops.sampling import stratified_grid


def camera_rays(config: RenderConfig, device="cuda"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All primary rays of a frame: (o, d) [spp, H, W, 3], origins 0 —
    `camera_rays_for_ids` of every flat id, so the same bits. They land on
    the card unless `device` names another device."""
    spp, h, w = config.samples_per_pixel, config.height, config.width
    ids = torch.arange(spp * h * w, dtype=torch.int64, device=device)
    o, d = camera_rays_for_ids(ids, config)
    return o.reshape(spp, h, w, 3), d.reshape(spp, h, w, 3)


def camera_rays_for_ids(ids: torch.Tensor, config: RenderConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Primary rays for flat ray ids in [spp, H, W] order -> (o, d) [N, 3]."""
    w, h, spp = config.width, config.height, config.samples_per_pixel
    aspect = float(w) / float(h)
    s = ids // (h * w)
    rem = ids % (h * w)
    y = (rem // w).to(torch.float32)
    x = (rem % w).to(torch.float32)
    g1, g2 = stratified_grid(spp)
    cx = ((np.arange(g1, dtype=np.float32) + np.float32(0.5))
          / np.float32(g1))
    cy = ((np.arange(g2, dtype=np.float32) + np.float32(0.5))
          / np.float32(g2))
    gx, gy = np.meshgrid(cx, cy, indexing="ij")
    offs = torch.from_numpy(np.stack([gx.ravel(), gy.ravel()], axis=1)).to(
        ids.device)
    sl = s.long()
    ox, oy = offs[sl, 0], offs[sl, 1]
    xx = (2.0 * (x + ox) / device_scalar(w, x) - 1.0) * aspect * config.scale
    yy = (1.0 - 2.0 * (y + oy) / device_scalar(h, y)) * config.scale
    d = torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)
    return torch.zeros_like(d), d


def block_ray_ids(i: int, chunk: int, config: RenderConfig,
                  block_h: int = 16, block_w: int = 16,
                  device="cuda") -> torch.Tensor:
    """Flat ray ids of chunk i in block order: each block_h x block_w pixel
    block's spp samples are one contiguous run. Requires block_h | H and
    block_w | W. Ids past the frame end clamp to the last ray (the caller
    keeps only the first spp*H*W results). They land on the card unless
    `device` names another device."""
    spp, h, w = config.samples_per_pixel, config.height, config.width
    run = spp * block_h * block_w
    nbx = w // block_w
    idx = i * chunk + torch.arange(chunk, dtype=torch.int64, device=device)
    idx = torch.clamp_max(idx, spp * h * w - 1)
    b = idx // run
    r = idx % run
    s = r // (block_h * block_w)
    p = r % (block_h * block_w)
    y = (b // nbx) * block_h + p // block_w
    x = (b % nbx) * block_w + p % block_w
    return (s * h + y) * w + x


def blocks_to_image(packed: torch.Tensor, config: RenderConfig,
                    block_h: int = 16, block_w: int = 16) -> torch.Tensor:
    """[spp*H*W, C] in block order -> [H, W, C], averaged over samples."""
    spp, h, w = config.samples_per_pixel, config.height, config.width
    c = packed.shape[-1]
    nby, nbx = h // block_h, w // block_w
    x = packed.reshape(nby, nbx, spp, block_h, block_w, c).mean(dim=2)
    return x.permute(0, 2, 1, 3, 4).reshape(h, w, c)


def block_permutation(spp: int, h: int, w: int, block_h: int = 8,
                      block_w: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, inv) grouping each pixel block's samples into one run, for
    frames that do not divide into whole blocks (the last blocks shrink)."""
    idx = np.arange(spp * h * w, dtype=np.int64).reshape(spp, h, w)
    bh, bw = min(block_h, h), min(block_w, w)
    parts = [idx[:, r:r + bh, c:c + bw].reshape(-1)
             for r in range(0, h, bh) for c in range(0, w, bw)]
    perm = np.concatenate(parts)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int64)
    return perm, inv
