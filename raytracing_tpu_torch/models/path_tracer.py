"""Monte-Carlo path tracer (twin of `raytracing_tpu.models.path_tracer`).

Where the Whitted integrator grows a fixed tree of rays, this one follows
one path per sample: each path carries one ray and an RGB throughput, at
every bounce it adds next-event direct light (the sun and its shadow ray)
and continues as EITHER the mirror branch or the cosine-weighted diffuse
branch, chosen in proportion to the material — constant memory per bounce,
any depth. Noise is traded for samples per pixel.

The material convention is the Whitted integrator's, so both agree in
expectation on shared light paths:
  direct  = color * (n·sun) * (albedo/pi) * visibility
  mirror  = reflectivity * L(reflect(d, n))
  diffuse = roughness * color * E[cos(theta) L(w)], w cosine-distributed
            (cosine-sampled rays are weighted by the cosine again, as the
            fan of `models.whitted` weights them).

Random numbers: bounce b of one sample draws two uniform arrays, the branch
choice [R] and the hemisphere sample [R, 2]. `render` takes them from a
`torch.Generator`, or from a `uniforms(chunk, sample, tag, shape)` callable
with tag ("branch", b) or ("scatter", b) — the way tests feed the port the
exact arrays the JAX package draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from raytracing_tpu_torch.accel.packets import ClusterAccel
from raytracing_tpu_torch.config import RenderConfig
from raytracing_tpu_torch.geometry.mesh import Mesh, Scene
from raytracing_tpu_torch.kernels.binning import (batch_bounds, bin_sort,
                                                  bounce_bin_key)
from raytracing_tpu_torch.models.camera import camera_rays_for_ids
from raytracing_tpu_torch.models.whitted import frame_accels, shade
from raytracing_tpu_torch.ops.color import gamma_correct
from raytracing_tpu_torch.ops.intersect import reflect
from raytracing_tpu_torch.ops.sampling import cosine_hemisphere
from raytracing_tpu_torch.tracer import nearest_hit_shaded, uses_kernels


@dataclasses.dataclass(frozen=True)
class PathTracerConfig:
    max_bounces: int = 4
    samples_per_pixel: int = 64
    # Bounds the probability of the mirror branch where both branches are
    # live.
    min_branch_prob: float = 0.05
    # Re-bin the path state every k-th bounce (1 = every bounce). At 2, odd
    # bounces trace in the previous bounce's order. Values other than 1
    # change which position-indexed draw each path receives, so images
    # differ sample by sample (the same estimator, not the same bits).
    bin_every: int = 1


def trace_paths(mesh: Mesh, accel: Optional[ClusterAccel], sun, o, d,
                uniforms: Callable[[tuple, tuple], torch.Tensor],
                config: RenderConfig, pt: PathTracerConfig,
                gi_accel: Optional[ClusterAccel] = None) -> torch.Tensor:
    """One radiance sample per ray o, d [R, 3] -> linear RGB [R, 3] (no
    gamma).

    uniforms(tag, shape): tag ("branch", b) with shape [R] and
    ("scatter", b) with shape [R, 2] for bounce b. gi_accel: an optional
    coarser accel of the same mesh for the segments after the first (the
    same estimator). With `config.bin_secondary` on the kernel path (as in
    the JAX package) the whole path state is re-sorted by (direction cone,
    origin cell) before each bounce after the first, and the result
    returns to the caller's order at the end. accel is None only under
    backend "bruteforce", which brute-forces every query.
    One host sync per bounce: the loop stops once no path is alive (exact:
    a dead path adds nothing)."""
    r = o.shape[0]
    dev = o.device
    sky = torch.tensor(config.sky_color, dtype=o.dtype, device=dev)
    radiance = torch.zeros((r, 3), dtype=o.dtype, device=dev)
    throughput = torch.ones((r, 3), dtype=o.dtype, device=dev)
    alive = torch.ones(r, dtype=torch.bool, device=dev)
    binning = config.bin_secondary and uses_kernels(config)
    orig = torch.arange(r, dtype=torch.int32, device=dev)

    for bounce in range(pt.max_bounces):
        first = bounce == 0
        acc_l = accel if first or gi_accel is None else gi_accel
        if not first and binning and (bounce - 1) % pt.bin_every == 0:
            lo, hi = batch_bounds(o, alive)
            _, (o, d, alive, throughput, radiance, orig) = bin_sort(
                bounce_bin_key(o, d, lo, hi, alive), o, d, alive, throughput,
                radiance, orig)
        wq = config.gi_wq and not first
        lane_cull = config.gi_lane_cull and not first
        h, attrs = nearest_hit_shaded(
            mesh, acc_l, o, d, config, alive=alive,
            early_exit=True if not first and config.gi_early_exit else None,
            wq=wq, lane_cull=lane_cull,
            # Primaries share the pinhole origin; later segments do not.
            shared_origin=(o[0] if first and config.primary_shared_origin
                           else None))
        sh = shade(mesh, acc_l, sun, o, d, h, config, attrs, wq=wq,
                   lane_cull=lane_cull)
        hit = h.hit & alive
        # A miss sees the sky and ends the path.
        radiance = radiance + torch.where((alive & ~h.hit)[:, None],
                                          throughput * sky, 0.0)
        # Next-event direct light (`shade` folds in the visibility).
        radiance = radiance + torch.where(hit[:, None],
                                          throughput * sh.direct, 0.0)
        if bounce == pt.max_bounces - 1:
            break
        refl, rough = sh.refl, sh.rough
        p_spec = torch.clamp(refl / torch.clamp_min(refl + rough, 1e-6),
                             pt.min_branch_prob, 1.0 - pt.min_branch_prob)
        # A dead branch (weight 0) forces the other one.
        p_spec = torch.where(refl <= 0.0, 0.0, p_spec)
        p_spec = torch.where(rough <= 0.0,
                             torch.where(refl > 0.0, 1.0, 0.0), p_spec)
        take_spec = uniforms(("branch", bounce), (r,)) < p_spec

        d_spec = reflect(d, sh.n)
        w_spec = (refl / torch.clamp_min(p_spec, 1e-6))[:, None]
        d_diff = cosine_hemisphere(uniforms(("scatter", bounce), (r, 2)),
                                   sh.n)
        cos = (sh.n * d_diff).sum(dim=-1)
        w_diff = sh.color * (cos * rough
                             / torch.clamp_min(1.0 - p_spec, 1e-6))[:, None]

        d = torch.where(take_spec[:, None], d_spec, d_diff)
        o = sh.pos
        w = torch.where(take_spec[:, None], w_spec, w_diff)
        throughput = throughput * torch.where(hit[:, None], w, 0.0)
        # A path with nothing left to contribute ends.
        alive = hit & (throughput.amax(dim=-1) > 0.0) \
            & ((refl > 0.0) | (rough > 0.0))
        if not bool(alive.any()):
            break

    if binning:
        _, (radiance,) = bin_sort(orig, radiance)
    return radiance


def render(scene: Scene, config: RenderConfig,
           pt: PathTracerConfig = PathTracerConfig(),
           accel: Optional[ClusterAccel] = None,
           generator: Optional[torch.Generator] = None,
           gi_accel: Optional[ClusterAccel] = None,
           uniforms: Optional[Callable[[int, int, tuple, tuple],
                                       torch.Tensor]] = None
           ) -> torch.Tensor:
    """Path-traced frame -> [H, W, 3] gamma-corrected RGB on the scene's
    device.

    Samples per pixel come from `pt.samples_per_pixel`: every sample
    traces the pixel-centre ray with its own draws. Pixels run in chunks
    of `config.chunk_size` in scanline order (the last chunk repeats the
    last pixel and its surplus is dropped); a chunk's samples are averaged
    in linear space and gamma is applied to the mean. accel defaults to
    `build_cluster_accel(mesh)` (none under backend "bruteforce"),
    gi_accel to the auto-built coarse bounce accel on the kernel path.
    Uniforms come from `uniforms(chunk, sample, tag, shape)` when given
    (the tags are `trace_paths`'), else from `generator` (default: seed 0
    on the scene's device)."""
    mesh = scene.mesh
    device = mesh.verts.device
    accel, gi_accel = frame_accels(scene, config, accel, gi_accel)
    if uniforms is None:
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)

        def uniforms(i, s, tag, shape):
            return torch.rand(shape, generator=generator, device=device)

    cam_cfg = config.replace(samples_per_pixel=1)
    h, w = config.height, config.width
    r = h * w
    chunk = min(config.chunk_size, r)
    nc = (r + chunk - 1) // chunk
    mean = torch.empty((nc * chunk, 3), dtype=torch.float32, device=device)
    for i in range(nc):
        ids = i * chunk + torch.arange(chunk, dtype=torch.int64,
                                       device=device)
        o_c, d_c = camera_rays_for_ids(torch.clamp_max(ids, r - 1), cam_cfg)
        acc = torch.zeros((chunk, 3), dtype=torch.float32, device=device)
        for s in range(pt.samples_per_pixel):
            acc = acc + trace_paths(
                mesh, accel, scene.sun, o_c, d_c,
                lambda tag, shape, i=i, s=s: uniforms(i, s, tag, shape),
                config, pt, gi_accel=gi_accel)
        mean[i * chunk:(i + 1) * chunk] = acc / pt.samples_per_pixel
    return gamma_correct(mean[:r].reshape(h, w, 3), config.gamma)
