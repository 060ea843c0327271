"""Render configuration — the PyTorch port's twin of `raytracing_tpu.config`.

`RenderConfig` keeps the JAX package's field names and defaults, so one
dict builds both configs. `backend` names the traversal:
  "cuda"        the hand-written CUDA kernels (their plain PyTorch versions
                on CPU tensors);
  "pallas"      a second name for the same kernel path, so that a JAX
                config dict (whose kernel path is "pallas") builds a port
                config;
  "auto"        the kernel path too, on the card and on the CPU (the JAX
                package resolves "auto" to "cluster" off the TPU; see
                `tracer.resolve_backend`);
  "bruteforce"  every ray against every triangle (`ops.trace`), the oracle;
  "cluster"     the flat cluster structure walked in plain PyTorch
                (`accel.packets.nearest_hit_cluster`).
The last two are plain PyTorch on either device: no kernel runs.

Knobs that only tune the TPU kernels keep their fields so that a config
means the same in both packages; the port documents where it ignores one.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

BACKENDS = ("auto", "cuda", "pallas", "bruteforce", "cluster")


def _u8(r: int, g: int, b: int) -> Tuple[float, float, float]:
    return (r / 255.0, g / 255.0, b / 255.0)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters; defaults are the reference frame
    (800x800, 4 stratified spp, reflect depth 4, a 10-ray diffuse fan to
    depth 2, sky #87ceeb, gamma 2.2, normal offset 1e-5)."""

    width: int = 800
    height: int = 800
    scale: float = 1.0
    samples_per_pixel: int = 4
    reflect_depth: int = 4
    diffuse_depth: int = 2
    diffuse_scatter: int = 10
    sky_color: Tuple[float, float, float] = _u8(0x87, 0xCE, 0xEB)
    gamma: float = 2.2
    normal_offset: float = 1e-5
    eps: float = 1e-8
    # Primary rays per wavefront chunk; the bounce levels hold
    # chunk_size * (1 + diffuse_scatter) rays.
    chunk_size: int = 65536
    # "auto", "cuda" and "pallas" name the kernel traversal (CUDA kernels
    # on CUDA tensors, their plain PyTorch versions on CPU tensors);
    # "bruteforce" and "cluster" the plain PyTorch backends.
    backend: str = "auto"
    # "stored" face normals, or "geometric" ones recomputed from vertices.
    normals: str = "stored"
    # Re-sort bounce levels by (direction cone, origin cell) before
    # tracing; order-invisible, a pure performance knob.
    bin_secondary: bool = True
    bin_reflect_levels: bool = True
    # Re-sort each level's shadow rays by hit position; "auto" = only when
    # there is no coarse bounce accel.
    bin_shadow: object = "auto"
    # Cluster size of the auto-built coarse accel for bounce levels
    # (0 disables it). Exact either way.
    gi_cluster_size: int = 128
    # Culling tile (rays per tile) of the bounce levels' (depth > 1)
    # nearest and shadow queries on the kernel path: bounce rays diverge,
    # so a 1024-ray tile's frustum balloons; a smaller tile tightens it
    # (fewer clusters listed) for more tiles. 0 = the kernels' default
    # (kernels/traverse.RAY_TILE, 1024); else any positive multiple of 128
    # (traverse.check_query_tile; another value raises): a tile outside
    # traverse.RAY_TILES is built from launches at the largest of them that
    # divides it. Exact either way.
    gi_ray_tile: int = 0
    # Per-visit lane-cull pre-test of bounce queries in the K1 walk (the
    # `_walk_groups` entry; not K2, K3 or K4, as on the TPU). It skips
    # visits without changing any result.
    gi_lane_cull: bool = True
    # Bounce queries through per-ray refined visit lists and the combined
    # geometry+attribute table (the `_walk_dma` entry). Exact either way.
    gi_wq: bool = True
    light_samples: int = 4
    # Two-phase capped bounce nearest queries: the cap is this fraction of
    # the primary accel's cluster-box diagonal (0 = off). Exact either way.
    gi_cap_frac: float = 0.0
    # Batched front-to-back early exit for bounce nearest queries. Exact.
    gi_early_exit: bool = True
    # Camera-mode primaries: the first level derives its rays in the walk
    # kernel and tests them with the origin-folded intersector ("pmto").
    # Its association differs from the default intersector's, so a hit on
    # an acceptance boundary can flip within one f32 rounding; off by
    # default, as in the JAX package. Frames that do not divide into 16x16
    # blocks, or chunks that do not divide into whole blocks, take the
    # pack path with the same folded intersector.
    primary_shared_origin: bool = False

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}: one of {BACKENDS}")

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def spp_grid(self):
        from raytracing_tpu_torch.ops.sampling import stratified_grid

        return stratified_grid(self.samples_per_pixel)


TEAPOT1_MATERIAL = (1.0, 0.9, 0.1)
TEAPOT2_MATERIAL = (1.0, 0.025, 0.975)
GROUND_MATERIAL = (1.0, 0.0, 1.0)

TEAPOT1_COLOR = _u8(0x50, 0xC8, 0x78)
TEAPOT2_COLOR = _u8(0xFF, 0x00, 0x00)
GROUND_COLOR = _u8(128, 128, 128)
