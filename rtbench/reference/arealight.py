"""The reference Whitted frame with spherical area lights at chosen pixels:
`Whitted`'s frame plus a soft-shadowed direct term at every level. Plain
torch, every step in the scene's dtype (float32 for the reference, lower
for the control); nothing of the program is imported.

The area-light term at a shaded point p (the offset hit position) with
normal n, per light (centre c, radius r, emission e):
- the cone the light subtends from p: dist = |c - p|, axis (c - p) /
  dist, sin_max = clamp(r / dist, 0, 1), cos_max = sqrt(max(1 -
  sin_max^2, 0)), solid angle 2 pi (1 - cos_max);
- `light_samples` directions uniform in the cone from uniforms u [2]:
  cos = 1 - u0 (1 - cos_max), sin = sqrt(max(1 - cos^2, 0)), angle
  2 pi u1 in the tangent frame of the axis (the fan's convention);
- a sample counts where the point is a hit and n.w > 0, and no triangle
  lies at eps < t < t_stop along it: t_stop = 0.9999 t_light, t_light the
  near root of the ray-sphere test (discriminant > 0, eps < t), else the
  distance to the centre (a grazing sample that misses numerically);
- the term mean over samples of (n.w where it counts, else 0) x the
  solid angle x e, summed over the lights, x albedo / pi x color; added
  to the sun's term before the children's radiance.

A light reaches a ray where one of its samples counts at the ray's hit
with n.w > 0, or reaches one of the ray's children; `pixels(...,
with_lit=True)` also says which pixels it reaches in some sample: those
whose value the lights move.

Each (depth, light, sample) takes one draw [N, 2] over its level's N
rows, indexed by the ray's row: level 1 is the chunk's rays in order
(the ray's place in its chunk); a child level is [reflect (n) | fan 0
(n) | ... | fan s-1 (n)] over its parent's n rows, the reflect block only
where depth < reflect_depth and the fan blocks only where depth <
diffuse_depth, so fan ray j of the primary at place p of a chunk of n
sits at row n + j n + p of the level-2 draw when mirror rays run to
depth 2. This is the program's row layout (`models/whitted.py`, "Random
numbers"), which a binned level keeps.

Departures from the program's semantics: none in what is computed. The
any-hit test is brute force under the conservative cull of
`tracer.Groups`, so a triangle the program's walk tests in another order
gives the same flag; sums run in this file's order, so float32 results
differ from the program's by rounding, which the cell's limits allow.
"""

from __future__ import annotations

import math

import torch

from rtbench.reference.tracer import cross, dot
from rtbench.reference.whitted import (Whitted, block_order_index,
                                       camera_dirs, cosine_fan, gamma,
                                       normalize)

RAY_EPS = 1e-8           # the ray-sphere test's |a| floor and t > eps
T_STOP = 1.0 - 1e-4      # a shadow ray stops this far short of the light


def cone_dirs(u, axis, cos_max):
    """Uniform directions [N, 3] in the cones of half-angle acos(cos_max)
    [N] about unit axes [N, 3], from uniforms u [N, 2]."""
    cos_t = 1.0 - u[..., 0] * (1.0 - cos_max)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    psi = 2.0 * math.pi * u[..., 1]
    z = torch.zeros_like(axis)
    z[..., 2] = 1.0
    xa = torch.zeros_like(axis)
    xa[..., 0] = 1.0
    arb = torch.where((axis[..., 2].abs() < 1e-6)[..., None], z, xa)
    t1 = normalize(cross(axis, arb))
    t2 = normalize(cross(axis, t1))
    d = ((sin_t * torch.cos(psi))[..., None] * t1
         + (sin_t * torch.sin(psi))[..., None] * t2
         + cos_t[..., None] * axis)
    return normalize(d)


def sphere_t(o, d, center, radius):
    """The near root t [N] of rays o, d [N, 3] against a sphere, and
    whether it counts (discriminant > 0, t > eps)."""
    oc = o - center
    a = dot(d, d)
    half_b = dot(oc, d)
    c = dot(oc, oc) - radius * radius
    disc = half_b * half_b - a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t = (-half_b - sq) / torch.where(a.abs() >= RAY_EPS, a,
                                     torch.ones_like(a))
    return t, (disc > 0.0) & (t > RAY_EPS)


class AreaLight(Whitted):
    """Radiance of chosen primary samples of one frame with area lights.
    lights: the configuration's list of {"center", "radius", "emission"};
    render["light_samples"]: the samples a light takes at each point."""

    def __init__(self, scene, render: dict, lights: list):
        super().__init__(scene, render)
        dt, dev = scene.v0.dtype, scene.v0.device
        self.lights = [
            tuple(torch.tensor(li[k], dtype=dt, device=dev)
                  for k in ("center", "radius", "emission"))
            for li in lights]

    def _area_term(self, pos, n, hit, color, albedo_pi, light_u):
        """The lights' radiance [N, 3] at points pos with normals n, and
        whether a sample counts there with n.w > 0 [N]; light_u(li, s)
        gives the draw's uniforms [N, 2] of each ray."""
        ns = self.cfg["light_samples"]
        total = torch.zeros_like(pos)
        lit = torch.zeros_like(hit)
        for li, (c, r, e) in enumerate(self.lights):
            to_c = c - pos
            dist = torch.sqrt(dot(to_c, to_c))
            safe = torch.clamp_min(dist, 1e-20)
            sin_max = torch.clamp(r / safe, 0.0, 1.0)
            cos_max = torch.sqrt(torch.clamp_min(1.0 - sin_max * sin_max,
                                                 0.0))
            axis = to_c / safe[:, None]
            omega = 2.0 * math.pi * (1.0 - cos_max)
            acc = torch.zeros_like(dist)
            for s in range(ns):
                w = cone_dirs(light_u(li, s).to(pos.dtype), axis, cos_max)
                ndl = dot(n, w)
                t_light, on = sphere_t(pos, w, c, r)
                t_stop = torch.where(on, t_light, dist) * T_STOP
                alive = hit & (ndl > 0.0)
                occluded = torch.zeros_like(alive)
                live = alive.nonzero().squeeze(1)
                if live.numel():
                    occluded[live] = self.groups.query(
                        pos[live], w[live], t_max=t_stop[live], any_hit=True)
                acc = acc + torch.where(alive & ~occluded,
                                        torch.clamp_min(ndl, 0.0),
                                        torch.zeros_like(ndl))
            lit = lit | (acc > 0.0)
            total = total + (acc / ns * omega)[:, None] * e
        return total * albedo_pi[:, None] * color, lit

    def _level(self, o, d, sun, depth, fan_u, chunks, rows, n_rows,
               light_u):
        """Radiance [N, 3] of rays o, d at `depth`, and whether a light
        reaches each [N] (module docstring), from the chunks `chunks` at
        rows `rows` of their level of n_rows; fan_u(alive_index) gives the
        depth-1 fan's uniforms [k, M, 2] of the listed rays; light_u(depth,
        n_rows, li, s, chunks, rows) the light draws' uniforms [M, 2] of the
        listed rays."""
        cfg, sc = self.cfg, self.sc
        t, tri = self.groups.query(o, d)
        hit = tri >= 0
        ti = tri.clamp_min(0)
        n = sc.normal[ti]
        tt = torch.where(hit, t, torch.ones_like(t)).to(o.dtype)
        pos = o + tt[:, None] * d + n * cfg["normal_offset"]
        color = sc.color[ti]
        albedo_pi, refl, rough = sc.albedo_pi[ti], sc.refl[ti], sc.rough[ti]
        to_sun = normalize(sun.to(o.dtype) - pos)
        ndl = dot(n, to_sun)
        facing = hit & (ndl > 0.0)
        occluded = torch.zeros_like(hit)
        live = facing.nonzero().squeeze(1)
        if live.numel():
            occluded[live] = self.groups.query(pos[live], to_sun[live],
                                               any_hit=True)
        lit = facing & ~occluded
        contrib = torch.where(lit[:, None], color * (ndl * albedo_pi)[:, None],
                              torch.zeros_like(color))
        area, reached = self._area_term(
            pos, n, hit, color, albedo_pi,
            lambda li, s: light_u(depth, n_rows, li, s, chunks, rows))
        contrib = contrib + torch.where(hit[:, None], area,
                                        torch.zeros_like(area))
        reached = hit & reached
        reflect = depth < cfg["reflect_depth"]
        fan = depth < cfg["diffuse_depth"]
        k = cfg["diffuse_scatter"]
        child_rows = (int(reflect) + (k if fan else 0)) * n_rows
        if reflect:
            rad = torch.zeros_like(contrib)
            go = (hit & (refl > 0.0)).nonzero().squeeze(1)
            if go.numel():
                dr = d[go] - 2.0 * n[go] * dot(d[go], n[go])[:, None]
                rad[go], reached_c = self._level(
                    pos[go], dr, sun, depth + 1, None, chunks[go], rows[go],
                    child_rows, light_u)
                reached[go] = reached[go] | reached_c
            w = torch.where(hit, refl, torch.zeros_like(refl))
            contrib = contrib + w[:, None] * rad
        if fan:
            acc = torch.zeros_like(contrib)
            go = (hit & (rough > 0.0)).nonzero().squeeze(1)
            if go.numel():
                u = fan_u(go).to(o.dtype)                     # [k, M, 2]
                dirs = cosine_fan(u, n[go][None].expand(k, -1, 3))
                m = go.numel()
                first = (n_rows if reflect else 0) + rows[go]
                fan_rows = (first[None] + n_rows * torch.arange(
                    k, device=rows.device)[:, None]).reshape(-1)
                rad, reached_c = self._level(
                    pos[go][None].expand(k, m, 3).reshape(-1, 3),
                    dirs.reshape(-1, 3), sun, depth + 1, None,
                    chunks[go].repeat(k), fan_rows, child_rows, light_u)
                rad = rad.reshape(k, m, 3)
                reached[go] = reached[go] | reached_c.reshape(k, m).any(dim=0)
                cosj = dot(n[go][None].expand(k, m, 3), dirs)
                w = color[go][None] * (cosj * rough[go][None])[..., None]
                wr = w * rad
                fan_sum = wr[0]
                for j in range(1, k):
                    fan_sum = fan_sum + wr[j]
                acc[go] = fan_sum
            contrib = contrib + acc / k
        return (torch.where(hit[:, None], contrib,
                            self.sky.expand_as(contrib)), reached)

    def pixels(self, ys, xs, sun, offs, fan_draw, light_draw,
               with_lit=False):
        """Gamma-corrected pixel values [P, 3] (float32) at pixels (xs, ys):
        the mean of their samples; with_lit, also whether a light reaches
        some sample of each [P]. fan_draw(chunk) gives that chunk's tag-1 uniforms
        [k, chunk_size, 2]; light_draw(chunk, depth, light, sample, n_rows)
        that chunk's light draw [n_rows, 2] of the level at `depth`."""
        cfg = self.cfg
        spp, w, h = cfg["samples_per_pixel"], cfg["width"], cfg["height"]
        dt, dev = self.sc.v0.dtype, self.sc.v0.device
        p = ys.shape[0]
        s = torch.arange(spp, device=dev).repeat_interleave(p)
        y, x = ys.to(dev).repeat(spp), xs.to(dev).repeat(spp)
        d = camera_dirs(s, y, x, offs, w, h, cfg.get("scale", 1.0), dt)
        o = torch.zeros_like(d)
        place = block_order_index(s, y, x, spp, w)
        chunk = min(cfg["chunk_size"], spp * w * h)
        ci, ri = place // chunk, place % chunk

        def fan_u(idx):
            out = torch.empty((cfg["diffuse_scatter"], idx.numel(), 2),
                              dtype=torch.float32, device=dev)
            for c in torch.unique(ci[idx]).tolist():
                sel = (ci[idx] == c).nonzero().squeeze(1)
                out[:, sel] = fan_draw(c).to(dev)[:, ri[idx[sel]]]
            return out

        def light_u(depth, n_rows, li, s_, chunks, rows):
            out = torch.empty((rows.numel(), 2), dtype=torch.float32,
                              device=dev)
            for c in torch.unique(chunks).tolist():
                sel = (chunks == c).nonzero().squeeze(1)
                out[sel] = light_draw(c, depth, li, s_, n_rows).to(dev)[
                    rows[sel]]
            return out

        rad, lit = self._level(o, d, sun.to(dev), 1, fan_u, ci, ri, chunk,
                               light_u)
        rgb = gamma(rad.float(), cfg["gamma"]).reshape(spp, p, 3).mean(0)
        return (rgb, lit.reshape(spp, p).any(dim=0)) if with_lit else rgb
