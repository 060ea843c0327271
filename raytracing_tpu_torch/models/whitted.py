"""Whitted + one-bounce-diffuse integrator (twin of
`raytracing_tpu.models.whitted`).

The reference's recursive trace becomes a wavefront per recursion level:
level l holds every ray at depth l as one batch, children are appended as
[reflect | diffuse fan] blocks with per-ray weights, and radiance is
accumulated on the way back up. Sun shadows are an any-hit query; mirror
reflection to `reflect_depth`; a cosine-weighted fan of `diffuse_scatter`
rays to `diffuse_depth`; misses see the sky; gamma is applied per primary
sample before the spp average. A scene's spherical area lights add a
soft-shadowed direct term at every level (`area_light_term`): per light,
`light_samples` shadow rays into its cone, each an any-hit query that
stops at the light's surface (a per-ray t_max). On the card's kernel
path a sample's rays and its share of the estimate are two launches of
`csrc/light.cu` (`kernels.light`) around its query, with the plain
functions' bits.

Random numbers: the fan at depth l of chunk i draws ONE uniform array
[s, N, 2], and each (depth, light, sample) of the area lights one array
[N, 2]. `render` takes them from a `torch.Generator`, or from a
`uniforms(i, tag, shape)` callable — the way tests feed the port the exact
arrays the JAX package draws. The tag names the draw: the depth (an int)
for the fan, ("light", depth, light, sample) for a light's shadow sample.

A level's N rows, as an unbinned frame lays them out: level 1 is the
chunk's rays in order; a child level is [reflect (n) | fan 0 (n) | ... |
fan s-1 (n)] over its parent level's n rows, the reflect block only where
depth < reflect_depth and the fan blocks only where depth <
diffuse_depth; so the child of parent row p in block b has row b n + p.
A light's draw follows each ray by its row: a ray that `_bin_bounce`
moved, here or at a level above, takes its row of the draw, not its
place (at the first binned level the sorted ray at place i takes row
sidx[i]), so binning changes no ray's light samples. Only the lights'
draws do: the fan's draw at a binned level is taken in sorted order, as
in the JAX package, whose binned frames the tests hold the port to. So a
frame whose fans go below level 1 (diffuse_depth >= 3) changes with
`bin_secondary`; at diffuse_depth <= 2 the only fan is level 1's, which
is never binned, and the frame is the same bit for bit either way. The
rows are carried only where the scene has lights, so a frame without
them makes the launches it made before the rows existed.

Spans (`utils.profiling`): `rt.frame` around `render`, `rt.chunk` around
each chunk, `rt.level` around each level; the glue in `rt.camera_rays`,
`rt.bin`, `rt.shade`, `rt.children`, `rt.radiance` (and the binning's
`rt.unsort`), the area lights' term in `rt.area_light` (its backward,
`_KernelLightSum`'s, in `rt.grad`), the level's one host sync in
`rt.sync`. A level counts its rays in `rays.level<d>` and,
under `counting(True)`, its alive ones in `alive.level<d>`; the area
lights count their shadow rays in `rays.area_light`, those the kernels
prepared in `area_light.fused` and, under `counting(True)`, the alive
ones in `alive.area_light`.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional

import torch

from raytracing_tpu_torch.accel.packets import ClusterAccel, build_cluster_accel
from raytracing_tpu_torch.config import RenderConfig
from raytracing_tpu_torch.geometry.mesh import Mesh, Scene, SphereLight
from raytracing_tpu_torch.kernels import light as light_kernels
from raytracing_tpu_torch.kernels.binning import (
    batch_bounds, bin_key, bin_sort, bounce_bin_key, scene_bounds, unsort)
from raytracing_tpu_torch.kernels.traverse import (Hit, camera_mode_supported,
                                                   check_query_tile)
from raytracing_tpu_torch.models.camera import (
    block_permutation, block_ray_ids, blocks_to_image, camera_rays_for_ids)
from raytracing_tpu_torch.ops.color import gamma_correct
from raytracing_tpu_torch.ops.intersect import (INF, ray_sphere, reflect,
                                                triangle_normal)
from raytracing_tpu_torch.ops.linalg import dot, normalize, sqrt0
from raytracing_tpu_torch.ops.sampling import (cosine_hemisphere, sample_cone,
                                               stratified_offsets)
from raytracing_tpu_torch.tracer import (any_hit, nearest_hit_shaded,
                                         nearest_hit_shaded_camera,
                                         uses_kernels)
from raytracing_tpu_torch.utils.profiling import (COUNTERS, host_sync, span,
                                                  spanned)


def _attribute_rows(mesh: Mesh) -> torch.Tensor:
    """Per-triangle shading attributes as one [T, 9] row table: normal |
    color | albedo/pi, reflectivity, roughness (what the kernel path's
    walk accumulates; the other backends gather it by triangle id)."""
    return torch.cat([mesh.normals, mesh.colors,
                      mesh.materials[mesh.obj_id.long()]], dim=1)


class Shaded(NamedTuple):
    """Per-ray shading state at one level (finite on miss lanes)."""

    direct: torch.Tensor     # [N, 3] direct sun radiance
    n: torch.Tensor          # [N, 3] shading normal
    pos: torch.Tensor        # [N, 3] offset hit position
    color: torch.Tensor      # [N, 3]
    refl: torch.Tensor       # [N]
    rough: torch.Tensor      # [N]
    albedo_pi: torch.Tensor  # [N]


@spanned("rt.shade")
def shade(mesh: Mesh, accel: Optional[ClusterAccel], sun, o, d, hit: Hit,
          config: RenderConfig, attrs: Optional[torch.Tensor] = None,
          bin_shadow: Optional[bool] = None, wq: bool = False,
          lane_cull: bool = False, ray_tile: Optional[int] = None) -> Shaded:
    """Direct sun light at the hit points, with the shadow (any-hit) query.
    attrs [N, 9]: the walk's attribute rows, hit.tri then packed slots (the
    kernel path); None: hit.tri are original triangle ids and one row
    gather of `_attribute_rows` fetches the attributes (the other
    backends). The shadow rays are re-sorted by hit position only on the
    kernel path, as in the JAX package (the order changes no result).
    wq, lane_cull and ray_tile (the culling tile; None: the default): how
    the shadow query walks (no result changes)."""
    t_safe = torch.where(hit.hit, hit.t, 1.0)
    idx_is_slot = attrs is not None
    if attrs is None:
        attrs = _attribute_rows(mesh)[hit.tri.long()]
    if config.normals == "geometric":
        tri_ids = accel.order_ext[hit.tri.long()] if idx_is_slot else hit.tri
        tv = mesh.tri_v[tri_ids.long()].long()
        n = triangle_normal(mesh.verts[tv[:, 0]], mesh.verts[tv[:, 1]],
                            mesh.verts[tv[:, 2]])
    else:
        n = attrs[:, 0:3]
    pos = o + t_safe[:, None] * d + n * config.normal_offset
    color = attrs[:, 3:6]
    albedo_pi, refl, rough = attrs[:, 6], attrs[:, 7], attrs[:, 8]
    sun_dir = normalize(sun - pos, eps=1e-20)
    ndl = dot(n, sun_dir)
    facing = ndl > 0.0  # the reference's backface "cheat"
    sh_alive = hit.hit & facing
    if bin_shadow is None:
        bin_shadow = config.bin_shadow in (True, "auto")
    if bin_shadow and uses_kernels(config) and accel is not None:
        # Sort the shadow rays by hit position so their tiles are compact.
        lo, hi = batch_bounds(pos, sh_alive)
        k = bin_key(pos, sun_dir, lo, hi, sh_alive)
        sidx, (pos_s, alive_s) = bin_sort(k, pos, sh_alive)
        dir_s = normalize(sun - pos_s, eps=1e-20)
        occ_s = any_hit(mesh, accel, pos_s, dir_s, config, alive=alive_s,
                        wq=wq, lane_cull=lane_cull, ray_tile=ray_tile)
        (occluded,) = unsort(sidx, occ_s)
    else:
        occluded = any_hit(mesh, accel, pos, sun_dir, config,
                           alive=sh_alive, wq=wq, lane_cull=lane_cull,
                           ray_tile=ray_tile)
    lit = hit.hit & facing & ~occluded
    direct = torch.where(lit[:, None], color * (ndl * albedo_pi)[:, None],
                         0.0)
    return Shaded(direct=direct, n=n, pos=pos, color=color, refl=refl,
                  rough=rough, albedo_pi=albedo_pi)


class LightCone(NamedTuple):
    """The cone one spherical light subtends from each shaded point."""

    center: torch.Tensor   # [3]
    radius: torch.Tensor   # []
    dist: torch.Tensor     # [N] distance to the light's centre
    axis: torch.Tensor     # [N, 3] unit direction to the centre
    cos_max: torch.Tensor  # [N] cosine of the cone's half-angle
    omega: torch.Tensor    # [N] its solid angle


def light_cone(lights: SphereLight, li: int, pos) -> LightCone:
    c, rad = lights.center[li], lights.radius[li]
    to_c = c - pos
    dist = torch.sqrt(dot(to_c, to_c))
    safe = torch.clamp_min(dist, 1e-20)
    sin_max = torch.clamp(rad / safe, 0.0, 1.0)
    cos_max = sqrt0(1.0 - sin_max * sin_max)
    return LightCone(c, rad, dist, to_c / safe[:, None], cos_max,
                     2.0 * math.pi * (1.0 - cos_max))


def light_shadow_rays(cone: LightCone, pos, n, hit_mask, u):
    """One shadow sample per shaded point from uniforms u [N, 2]:
    (direction [N, 3], n·direction [N], alive [N], t_max [N]). The ray
    stops just short of the light's surface — at the distance to its
    centre where a grazing sample misses the sphere numerically — so an
    occluder beyond the light never counts."""
    w_dir = sample_cone(u, cone.axis, cone.cos_max)
    ndl = dot(n, w_dir)
    t_light, l_hit = ray_sphere(pos, w_dir, cone.center, cone.radius, INF)
    t_light = torch.where(l_hit, t_light, cone.dist)
    return w_dir, ndl, hit_mask & (ndl > 0.0), t_light * (1.0 - 1e-4)


def _fused_light(config: RenderConfig, pos: torch.Tensor) -> bool:
    """True where the lights' glue runs as csrc/light.cu's kernels
    (`kernels.light`): on the kernel path with CUDA tensors, with a
    gradient or without. Elsewhere (the CPU, the other backends) the plain
    functions run; both give the same bits."""
    return uses_kernels(config) and pos.is_cuda


def _light_sum(fused: bool, lights: SphereLight, pos, n, albedo_pi, color,
               hit_mask, rows, ns: int, draw, occluded) -> torch.Tensor:
    """The estimator of `area_light_term` over every (light, sample): draw
    (li, s) gives the sample's uniforms, ray i taking row rows[i] (row i
    with rows None), and occluded(li, s, w_dir, alive, t_stop) its any-hit
    mask. fused: each sample is prepared by `light_sample` and folded by
    `light_fold`, else by the plain functions."""
    rays = pos.shape[0]
    if fused:
        acc = torch.empty(rays, dtype=pos.dtype, device=pos.device)
        total = torch.empty((rays, 3), dtype=pos.dtype, device=pos.device)
    else:
        total = torch.zeros_like(pos)
    for li in range(lights.center.shape[0]):
        if not fused:
            cone = light_cone(lights, li, pos)
            acc = torch.zeros_like(cone.dist)
        for s in range(ns):
            u = draw(li, s)
            if fused:
                w_dir, ndl, alive, t_stop = light_kernels.light_sample(
                    pos, n, hit_mask, u, rows, lights, li)
            else:
                w_dir, ndl, alive, t_stop = light_shadow_rays(
                    cone, pos, n, hit_mask, u if rows is None else u[rows])
            occ = occluded(li, s, w_dir, alive, t_stop)
            if fused:
                light_kernels.light_fold(acc, total, alive, occ, ndl, s, ns,
                                         li, lights, pos, albedo_pi, color)
            else:
                acc = acc + torch.where(alive & ~occ,
                                        torch.clamp_min(ndl, 0.0), 0.0)
        if not fused:
            total = total + ((acc / ns * cone.omega)[:, None]
                             * lights.emission[li])
    return total if fused else total * albedo_pi[:, None] * color


class _KernelLightSum(torch.autograd.Function):
    """`_light_sum` on the kernels where its inputs take a gradient: the
    forward launches them around each sample's query and keeps each
    sample's draw and occlusion mask; the backward replays the plain
    functions on those (the masks have no gradient) and differentiates
    them. The kernels give the plain functions' bits, so the gradient is
    the plain path's."""

    @staticmethod
    def forward(ctx, pos, n, albedo_pi, color, center, radius, emission,
                hit_mask, rows, ns, draw, occluded):
        ctx.draws, ctx.masks = {}, {}

        def keep_draw(li, s):
            ctx.draws[li, s] = draw(li, s)
            return ctx.draws[li, s]

        def keep_mask(li, s, *ray):
            ctx.masks[li, s] = occluded(li, s, *ray)
            return ctx.masks[li, s]

        ctx.save_for_backward(pos, n, albedo_pi, color, center, radius,
                              emission)
        ctx.hit_mask, ctx.rows, ctx.ns = hit_mask, rows, ns
        return _light_sum(True, SphereLight(center, radius, emission), pos,
                          n, albedo_pi, color, hit_mask, rows, ns, keep_draw,
                          keep_mask)

    @staticmethod
    def backward(ctx, grad):
        ins = [t.detach().requires_grad_(need) for t, need in
               zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with span("rt.grad", kind="light_sum"):
            with torch.enable_grad():
                out = _light_sum(
                    False, SphereLight(*ins[4:]), *ins[:4], ctx.hit_mask,
                    ctx.rows, ctx.ns, lambda li, s: ctx.draws[li, s],
                    lambda li, s, *ray: ctx.masks[li, s])
            wrt = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(out, wrt, grad,
                                           allow_unused=True))
            return (*(next(got) if t.requires_grad else None for t in ins),
                    None, None, None, None, None)


def area_light_term(accel: Optional[ClusterAccel], lights: SphereLight,
                    sh: Shaded, hit_mask, uniforms, config: RenderConfig,
                    wq: bool = False, mesh: Optional[Mesh] = None,
                    lane_cull: bool = False,
                    ray_tile: Optional[int] = None,
                    rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Soft-shadowed direct radiance [N, 3] from spherical area lights at
    the shaded points. Per light: `config.light_samples` directions drawn
    uniformly in the cone the light subtends, each a visibility ray whose
    any-hit query has its own t_max (`light_shadow_rays`). The estimator is
    mean(emission cos_theta V) x cone solid angle x albedo/pi x color.
    uniforms((light, sample), [N, 2]) returns each draw's uniforms; ray i
    takes row rows[i] of it (rows: a permutation of [0, N) as int64 [N],
    None for row i). mesh: the scene's mesh, which the brute-force and
    cluster backends read (the kernel path needs only the accel). wq,
    lane_cull and ray_tile (the culling tile): how the shadow queries walk.
    Where `_fused_light`, a sample is two launches around its query
    (`kernels.light`; under autograd the backward replays the plain
    functions), else the plain functions' ~100. Runs in the span
    `rt.area_light` (lights, samples, rays) and counts its shadow rays in
    `rays.area_light`, those the kernels prepared in `area_light.fused`,
    the alive ones in `alive.area_light`."""
    pos = sh.pos
    nl, ns, rays = lights.center.shape[0], config.light_samples, pos.shape[0]
    fused = _fused_light(config, pos)
    COUNTERS.add("rays.area_light", rays * nl * ns)
    COUNTERS.add("area_light.fused", rays * nl * ns if fused else 0)

    def draw(li, s):
        return uniforms((li, s), (rays, 2))

    def occluded(li, s, w_dir, alive, t_stop):
        if COUNTERS.counting:
            COUNTERS.add_device("alive.area_light", alive.sum())
        return any_hit(mesh, accel, pos, w_dir, config, t_max=t_stop,
                       alive=alive, wq=wq, lane_cull=lane_cull,
                       ray_tile=ray_tile)

    ins = (pos, sh.n, sh.albedo_pi, sh.color, *lights)
    with span("rt.area_light", lights=nl, samples=ns, rays=rays):
        if fused and torch.is_grad_enabled() and any(
                t.requires_grad for t in ins):
            return _KernelLightSum.apply(*ins, hit_mask, rows, ns, draw,
                                         occluded)
        return _light_sum(fused, lights, *ins[:4], hit_mask, rows, ns, draw,
                          occluded)


def bounce_cap(accel: Optional[ClusterAccel],
               config: RenderConfig) -> Optional[float]:
    """The two-phase cap of the bounce levels' nearest queries:
    gi_cap_frac x the diagonal of the union of the primary accel's cluster
    boxes (the JAX package's `binning.scene_bounds`: the rest set's ground
    plane is left out), or None with gi_cap_frac 0 or no accel. Exact
    either way: the capped query gives the uncapped one's result. (The
    JAX package skips the cap when the accel is traced.)"""
    if config.gi_cap_frac <= 0.0 or accel is None:
        return None
    lo, hi = scene_bounds(accel)
    return config.gi_cap_frac * float(torch.linalg.norm(hi - lo))


@spanned("rt.bin")
def _bin_bounce(o_l, d_l, alive_l):
    """Sort a bounce level by (direction cone, origin cell); returns
    (sidx, (o, d, alive)) for `unsort`."""
    lo, hi = batch_bounds(o_l, alive_l)
    return bin_sort(bounce_bin_key(o_l, d_l, lo, hi, alive_l),
                    o_l, d_l, alive_l)


@spanned("rt.children")
def _children(d_l, h: Hit, sh: Shaded, config: RenderConfig, depth: int,
              uniforms):
    """The next level's rays [reflect | diffuse fan] and their weights:
    (o_c, d_c, alive_c, w_refl | None, w_diff | None)."""
    n_l = d_l.shape[0]
    s = config.diffuse_scatter
    parts_o, parts_d, parts_a = [], [], []
    w_refl = w_diff = None
    if depth < config.reflect_depth:
        parts_o.append(sh.pos)
        parts_d.append(reflect(d_l, sh.n))
        parts_a.append(h.hit & (sh.refl > 0.0))
        w_refl = torch.where(h.hit[:, None], sh.refl[:, None], 0.0)
    if depth < config.diffuse_depth:
        wdirs = cosine_hemisphere(uniforms(depth, (s, n_l, 2)), sh.n)
        cosj = dot(sh.n[None].expand_as(wdirs), wdirs)
        w_d = sh.color[None] * (cosj * sh.rough[None])[..., None]
        w_diff = torch.where(h.hit[None, :, None], w_d, 0.0)
        parts_o.append(sh.pos[None].expand(s, n_l, 3).reshape(-1, 3))
        parts_d.append(wdirs.reshape(-1, 3))
        parts_a.append((h.hit & (sh.rough > 0.0))[None].expand(s, n_l)
                       .reshape(-1))
    return (torch.cat(parts_o), torch.cat(parts_d), torch.cat(parts_a),
            w_refl, w_diff)


def bounce_wavefront(mesh: Mesh, accel: ClusterAccel, sun, o, d,
                     config: RenderConfig, uniforms):
    """The depth-2 wavefront of primary rays o, d as the renderer traces
    it: children of the primary hits, binned. Returns (o, d, alive)."""
    h, attrs = nearest_hit_shaded(mesh, accel, o, d, config)
    sh = shade(mesh, accel, sun, o, d, h, config, attrs, bin_shadow=False)
    o_c, d_c, a_c, _, _ = _children(d, h, sh, config, 1, uniforms)
    return _bin_bounce(o_c, d_c, a_c)[1]


def render_rays(mesh: Mesh, accel: Optional[ClusterAccel], sun, o, d,
                config: RenderConfig,
                uniforms: Callable[[object, tuple], torch.Tensor],
                gi_accel: Optional[ClusterAccel] = None,
                lights: Optional[SphereLight] = None,
                camera_chunk=None) -> torch.Tensor:
    """Gamma-corrected radiance [R, 3] for primary rays o, d [R, 3].

    accel: the cluster structure the kernel path and the "cluster" backend
    walk (None under backend "bruteforce", which brute-forces every query).
    uniforms(tag, shape) returns a draw's uniforms: tag = depth for the
    diffuse fan at `depth`, ("light", depth, light, sample) for one shadow
    sample of an area light.
    gi_accel: an optional coarser accel of the same mesh for every level
    below the first (exact either way) — trace, sun shadow and area
    lights. lights: the scene's area lights.
    camera_chunk: (first block, offs [spp, 2], bh, bw) when o, d are
    config's camera rays of whole bh x bw blocks from that block on, in
    block order: the first level then runs in camera mode and reads o, d
    only for shading.

    Differentiable with respect to the mesh (verts, normals, colors,
    materials), the lights (center, radius, emission), the sun and the
    rays: on the kernel path the nearest queries are `_ShadedWalk`s when
    something requires grad (camera mode stays detached, as in the JAX
    package), off it autograd runs through the plain queries; which
    triangle a ray hits, every occlusion query and the per-ray t_max of a
    light's shadow ray stay detached."""
    s = config.diffuse_scatter
    sky = torch.tensor(config.sky_color, dtype=o.dtype, device=o.device)
    bin_sh = (config.bin_shadow if isinstance(config.bin_shadow, bool)
              else gi_accel is None)
    # Bounce levels are re-sorted on the kernel path only (JAX package).
    kernels = uses_kernels(config)
    t_cap = bounce_cap(accel, config) if kernels else None
    # The bounce levels' culling tile (the kernel path's; checked up front).
    rt_gi = check_query_tile(config.gi_ray_tile or None) if kernels else None

    def level_radiance(o_l, d_l, alive_l, depth, rows=None):
        n_l = o_l.shape[0]
        COUNTERS.add(f"rays.level{depth}", n_l)
        if COUNTERS.counting:
            COUNTERS.add_device(f"alive.level{depth}",
                                n_l if alive_l is None else alive_l.sum())
        with span("rt.level", depth=depth, rays=n_l):
            return level(o_l, d_l, alive_l, depth, rows)

    def level(o_l, d_l, alive_l, depth, rows):
        # rows: each ray's row of the level (module docstring) where it
        # differs from its place, which only a binned level above or here
        # makes; kept for the lights' draws alone.
        n_l = o_l.shape[0]
        sidx = None
        bounce = depth > 1
        acc_l = gi_accel if (bounce and gi_accel is not None) else accel
        if (bounce and config.bin_secondary and kernels
                and (depth <= config.diffuse_depth
                     or config.bin_reflect_levels)):
            sidx, (o_l, d_l, alive_l) = _bin_bounce(o_l, d_l, alive_l)
            if lights is not None:
                rows = sidx if rows is None else rows[sidx]
        wq = config.gi_wq and bounce
        lane_cull = config.gi_lane_cull and bounce
        ray_tile = rt_gi if bounce else None
        if not bounce and camera_chunk is not None:
            tb, offs_c, bh_c, bw_c = camera_chunk
            rt_c = config.samples_per_pixel * bh_c * bw_c
            if n_l % rt_c:
                raise ValueError(
                    f"camera_chunk needs the chunk's ray count ({n_l}) to "
                    f"divide into whole {bh_c}x{bw_c}x"
                    f"{config.samples_per_pixel}spp blocks of {rt_c} rays")
            h, attrs = nearest_hit_shaded_camera(
                acc_l, offs_c, config, tb, n_l // rt_c, bh_c, bw_c)
        else:
            h, attrs = nearest_hit_shaded(
                mesh, acc_l, o_l, d_l, config, alive=alive_l,
                early_exit=True if bounce and config.gi_early_exit else None,
                wq=wq, t_cap=t_cap if bounce else None, lane_cull=lane_cull,
                ray_tile=ray_tile,
                # Primaries share the pinhole origin; bounce levels do not.
                shared_origin=(o_l[0] if not bounce
                               and config.primary_shared_origin else None))
        sh = shade(mesh, acc_l, sun, o_l, d_l, h, config, attrs,
                   bin_shadow=bin_sh, wq=wq, lane_cull=lane_cull,
                   ray_tile=ray_tile)
        contrib = sh.direct
        if lights is not None:
            area = area_light_term(
                acc_l, lights, sh, h.hit,
                lambda ls, shape: uniforms(("light", depth) + ls, shape),
                config, wq=wq, mesh=mesh, lane_cull=lane_cull,
                ray_tile=ray_tile, rows=rows)
            contrib = contrib + torch.where(h.hit[:, None], area, 0.0)
        rad_c = None
        if depth < config.reflect_depth or depth < config.diffuse_depth:
            o_c, d_c, a_c, w_refl, w_diff = _children(d_l, h, sh, config,
                                                      depth, uniforms)
            # Skip the whole subtree when every child is dead (sky chunks):
            # exact, since dead children carry zero weight. This costs one
            # host sync per level; a later change can keep it on the device.
            with host_sync("level"):
                more = bool(a_c.any())
            rows_c = None
            if more and rows is not None:
                # The child of row r in block b has row b n_l + r.
                blocks = torch.arange(o_c.shape[0] // n_l, device=rows.device)
                rows_c = (rows[None] + n_l * blocks[:, None]).reshape(-1)
            rad_c = (level_radiance(o_c, d_c, a_c, depth + 1, rows_c) if more
                     else torch.zeros_like(o_c))
        with span("rt.radiance"):
            if rad_c is not None:
                off = 0
                if w_refl is not None:
                    contrib = contrib + w_refl * rad_c[:n_l]
                    off = n_l
                if w_diff is not None:
                    wr = w_diff * rad_c[off:].reshape(s, n_l, 3)
                    acc = wr[0]
                    for j in range(1, s):
                        acc = acc + wr[j]
                    contrib = contrib + acc / s
            rad = torch.where(h.hit[:, None], contrib, sky)
        if sidx is not None:
            (rad,) = unsort(sidx, rad)
        return rad

    return gamma_correct(level_radiance(o, d, None, 1), config.gamma)


# Auto-built coarse bounce accels, keyed on (mesh id, cluster size,
# device); entries keep the mesh so its id cannot be reused while cached.
_GI_ACCEL_CACHE: OrderedDict = OrderedDict()
_GI_ACCEL_CACHE_MAX = 8


def _auto_gi_accel(mesh: Mesh, accel: Optional[ClusterAccel],
                   config: RenderConfig) -> Optional[ClusterAccel]:
    """The coarse accel for bounce levels (config.gi_cluster_size), built
    once per (mesh, size, device); None when disabled, off the kernel path
    (as in the JAX package) or when the primary accel is already at least
    that coarse."""
    cs = config.gi_cluster_size
    if (cs <= 0 or accel is None or not uses_kernels(config)
            or accel.cluster_size >= cs):
        return None
    key = (id(mesh), cs, str(mesh.verts.device))
    hit = _GI_ACCEL_CACHE.get(key)
    if hit is not None:
        _GI_ACCEL_CACHE.move_to_end(key)
        return hit[0]
    if len(_GI_ACCEL_CACHE) >= _GI_ACCEL_CACHE_MAX:
        _GI_ACCEL_CACHE.popitem(last=False)
    # Bounce queries walk the Baldwin–Weber table only (JAX package).
    gi = build_cluster_accel(mesh, cluster_size=cs, variants=("pmt",))
    _GI_ACCEL_CACHE[key] = (gi, mesh)
    return gi


def default_accel(mesh: Mesh, config: RenderConfig,
                  accel: Optional[ClusterAccel]) -> Optional[ClusterAccel]:
    """accel, else `build_cluster_accel(mesh)` for a backend that walks
    one: no query brute-forces for want of an accel; None only under
    "bruteforce"."""
    if accel is None and config.backend != "bruteforce":
        accel = build_cluster_accel(mesh)
    return accel


def frame_accels(scene: Scene, config: RenderConfig,
                 accel: Optional[ClusterAccel],
                 gi_accel: Optional[ClusterAccel]):
    """The (accel, gi_accel) a frame renders with: `default_accel`, and
    the auto-built bounce accel on the kernel path when none is given."""
    accel = default_accel(scene.mesh, config, accel)
    if gi_accel is None:
        gi_accel = _auto_gi_accel(scene.mesh, accel, config)
    return accel, gi_accel


def render(scene: Scene, config: RenderConfig,
           accel: Optional[ClusterAccel] = None,
           generator: Optional[torch.Generator] = None,
           gi_accel: Optional[ClusterAccel] = None,
           uniforms: Optional[Callable[[int, object, tuple],
                                       torch.Tensor]] = None
           ) -> torch.Tensor:
    """Render a frame -> [H, W, 3] float RGB on the scene's device.

    Primary rays run in chunks of config.chunk_size in 16x16 pixel-block
    order; the last chunk repeats the frame's last ray and its surplus
    results are dropped. With config.primary_shared_origin the primary
    level runs in camera mode (see RenderConfig), where a chunk past the
    frame's end repeats the last block instead. accel and gi_accel
    default as `frame_accels` chooses them: `build_cluster_accel(mesh)`
    except under backend "bruteforce", which needs none, and the
    auto-built coarse bounce accel on the kernel path. Uniforms come from
    `uniforms(chunk_index, tag, shape)` when given (the tags are
    `render_rays`'), else from `generator` (default: seed 0 on the scene's
    device). A scene with `lights` gets their soft-shadowed direct term."""
    spp, h, w = config.samples_per_pixel, config.height, config.width
    r = spp * h * w
    chunk = min(config.chunk_size, r)
    nc = (r + chunk - 1) // chunk
    with span("rt.frame", chunks=nc):
        return _render_chunks(scene, config, accel, generator, gi_accel,
                              uniforms, chunk, nc)


def _render_chunks(scene: Scene, config: RenderConfig, accel, generator,
                   gi_accel, uniforms, chunk: int, nc: int) -> torch.Tensor:
    """`render`'s frame in nc chunks of `chunk` rays."""
    mesh = scene.mesh
    device = mesh.verts.device
    accel, gi_accel = frame_accels(scene, config, accel, gi_accel)
    if uniforms is None:
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)

        def uniforms(i, tag, shape):
            return torch.rand(shape, generator=generator, device=device)

    spp, h, w = config.samples_per_pixel, config.height, config.width
    r = spp * h * w
    bh = bw = 16
    by_formula = h % bh == 0 and w % bw == 0
    # Camera-mode primaries: whole blocks per chunk, rays derived in the
    # walk kernel from the chunk's first block index.
    rt_cam = spp * bh * bw
    use_camera = (by_formula and config.primary_shared_origin
                  and chunk % rt_cam == 0 and uses_kernels(config)
                  and camera_mode_supported(accel))
    offs_cam = stratified_offsets(spp, device=device) if use_camera else None
    if not by_formula:
        perm, inv = block_permutation(spp, h, w, bh, bw)
        perm = torch.from_numpy(perm).to(device)
        inv = torch.from_numpy(inv).to(device)
        pad = nc * chunk - r
        if pad:
            perm = torch.cat([perm, perm[-1:].expand(pad)])
    rgb = torch.empty((nc * chunk, 3), dtype=torch.float32, device=device)
    for i in range(nc):
        with span("rt.chunk", i=i):
            with span("rt.camera_rays"):
                if by_formula:
                    ids = block_ray_ids(i, chunk, config, bh, bw,
                                        device=device)
                else:
                    ids = perm[i * chunk:(i + 1) * chunk]
                o_c, d_c = camera_rays_for_ids(ids, config)
            cam = ((i * (chunk // rt_cam), offs_cam, bh, bw) if use_camera
                   else None)
            rgb[i * chunk:(i + 1) * chunk] = render_rays(
                mesh, accel, scene.sun, o_c, d_c, config,
                lambda tag, shape, i=i: uniforms(i, tag, shape),
                gi_accel=gi_accel, lights=scene.lights, camera_chunk=cam)
    if by_formula:
        return blocks_to_image(rgb[:r], config, bh, bw)
    return rgb[:r][inv].reshape(spp, h, w, 3).mean(dim=0)
