"""The inputs a run makes from `--seed` and hands, the same, to the
program and to the reference: the sun of frame k, the diffuse fan's
uniforms of each chunk of frame k, and the pool of jittered sample
offsets that the calls take in turn. Every draw comes from its own
generator, seeded by a hash of (seed, what, k, ...), so any draw can be
made again on its own."""

from __future__ import annotations

import hashlib
import math

import torch


def subseed(seed: int, *parts) -> int:
    """A 63-bit seed for one draw, from the run's seed and its name."""
    text = ":".join(str(p) for p in (seed,) + parts)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def uniform(seed: int, *parts, lo: float = 0.0, hi: float = 1.0) -> float:
    """One float in [lo, hi) drawn from (seed, parts)."""
    return lo + (hi - lo) * (subseed(seed, *parts) / 2.0 ** 63)


def sun_at(t: float, device) -> torch.Tensor:
    """The sun [3] f32 on the upstream orbit at time t:
    (sin(t/10) 1e5, 2.5e4, cos(t/10) 1e5)."""
    a = t / 10.0
    return torch.tensor([math.sin(a) * 100_000.0, 25_000.0,
                         math.cos(a) * 100_000.0], dtype=torch.float32,
                        device=device)


class Draws:
    """Uniforms on one device: draw(k, *tag, shape=...) is the same tensor
    every time it is asked for."""

    def __init__(self, seed: int, device):
        self.seed = seed
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)

    def __call__(self, *parts, shape) -> torch.Tensor:
        self.gen.manual_seed(subseed(self.seed, *parts))
        return torch.rand(shape, generator=self.gen, device=self.device)


def stratified_grid(spp: int):
    gx = int(spp ** 0.5)
    while spp % gx:
        gx -= 1
    return gx, spp // gx


def jittered_offsets(u: torch.Tensor, spp: int) -> torch.Tensor:
    """Sub-pixel offsets [..., spp, 2] jittered inside the cells of the
    gx x gy stratified grid (x-major) by uniforms u [..., spp, 2]."""
    gx, gy = stratified_grid(spp)
    i = torch.arange(spp, device=u.device)
    cell = torch.stack([(i // gy).float(), (i % gy).float()], dim=1)
    return (cell + u) / torch.tensor([gx, gy], dtype=torch.float32,
                                     device=u.device)
