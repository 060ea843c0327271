"""The reference Whitted frame at chosen pixels and the reference
primary query at chosen rays: plain torch, every step in the scene's
dtype (float32 for the reference, lower for the control).

The semantics followed (the upstream renderer's, as the configuration's
`render` block sets them):
- a pinhole at the origin looking down +z; sample s of pixel (x, y) has
  the direction ((2 (x + ox_s) / W - 1) W / H, 1 - 2 (y + oy_s) / H, 1),
  left unnormalised; the offsets are the stratified cell centres;
- at a hit, the stored face normal n; the shaded point p = o + t d +
  n * normal_offset; the sun term color * (n.l * albedo / pi) where
  n.l > 0 and the sun ray from p is not blocked;
- below reflect_depth a mirror ray from p, weight refl; below
  diffuse_depth a fan of `diffuse_scatter` cosine-weighted rays from p,
  weights color * cos * rough, summed and divided by the fan's size;
- a miss sees the sky; each sample is gamma-corrected (values <= 0 give
  0, else max(v, 1e-6) ** (1 / gamma)) and a pixel averages its samples.

The fan at depth 1 takes its uniforms from the draw of the primary
ray's chunk: rays run in chunks of `chunk_size` in 16x16 block order
(each block's samples one run, sample-major), and the chunk's draw for
tag 1 is [fan, chunk_size, 2], indexed by the ray's place in its chunk.
Deeper fans draw from re-sorted levels, which this reference does not
follow: it refuses a diffuse_depth above 2.
"""

from __future__ import annotations

import math

import torch

from rtbench.reference.scene import RefScene
from rtbench.reference.tracer import Groups, cross, dot

BLOCK = 16


def normalize(a, eps=1e-20):
    return a / torch.sqrt(torch.clamp_min(dot(a, a), eps))[..., None]


def stratified_offsets(spp: int) -> torch.Tensor:
    """[spp, 2] cell centres of the gx x gy grid (gx the largest divisor of
    spp not above its square root), x-major."""
    gx = int(spp ** 0.5)
    while spp % gx:
        gx -= 1
    gy = spp // gx
    return torch.tensor([[(i + 0.5) / gx, (j + 0.5) / gy]
                         for i in range(gx) for j in range(gy)],
                        dtype=torch.float32)


def block_order_index(s, y, x, spp: int, width: int):
    """The place of sample s of pixel (x, y) in 16x16 block order."""
    run = spp * BLOCK * BLOCK
    b = (y // BLOCK) * (width // BLOCK) + x // BLOCK
    return b * run + s * BLOCK * BLOCK + (y % BLOCK) * BLOCK + x % BLOCK


def ray_of_block_index(l, spp: int, width: int):
    """(s, y, x) of the ray at place l of block order."""
    run = spp * BLOCK * BLOCK
    b, r = l // run, l % run
    s, p = r // (BLOCK * BLOCK), r % (BLOCK * BLOCK)
    y = (b // (width // BLOCK)) * BLOCK + p // BLOCK
    x = (b % (width // BLOCK)) * BLOCK + p % BLOCK
    return s, y, x


def camera_dirs(s, y, x, offs, width: int, height: int, scale: float, dtype):
    """Unnormalised pinhole directions [N, 3] of samples s at pixels (x, y)
    under offsets offs [spp, 2]."""
    offs = offs.to(device=x.device, dtype=dtype)
    ox, oy = offs[s, 0], offs[s, 1]
    xf, yf = x.to(dtype), y.to(dtype)
    xx = (2.0 * (xf + ox) / width - 1.0) * (width / height) * scale
    yy = (1.0 - 2.0 * (yf + oy) / height) * scale
    return torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)


def cosine_fan(u, n):
    """Cosine-weighted directions [k, N, 3] about normals n [N, 3] from
    uniforms u [k, N, 2]: sin = sqrt(u0), cos = sqrt(max(1 - u0, 0)),
    angle 2 pi u1 in the tangent frame (t1 = n x a, t2 = n x t1, a = +z
    where |n.z| < 1e-6, else +x)."""
    sin_t = torch.sqrt(u[..., 0])
    cos_t = torch.sqrt(torch.clamp_min(1.0 - u[..., 0], 0.0))
    psi = 2.0 * math.pi * u[..., 1]
    z = torch.zeros_like(n)
    z[..., 2] = 1.0
    xa = torch.zeros_like(n)
    xa[..., 0] = 1.0
    arb = torch.where((n[..., 2].abs() < 1e-6)[..., None], z, xa)
    t1 = normalize(cross(n, arb))
    t2 = normalize(cross(n, t1))
    d = ((sin_t * torch.cos(psi))[..., None] * t1
         + (sin_t * torch.sin(psi))[..., None] * t2
         + cos_t[..., None] * n)
    return normalize(d)


def gamma(rgb, g: float):
    y = torch.pow(torch.clamp_min(rgb, 1e-6), 1.0 / g)
    return torch.where(rgb <= 0.0, torch.zeros_like(y), y)


class Whitted:
    """Radiance of chosen primary samples of one frame."""

    def __init__(self, scene: RefScene, render: dict):
        if render.get("diffuse_depth", 2) > 2:
            raise ValueError("the reference follows fans at depth 1 only")
        if render.get("normals", "stored") != "stored":
            raise ValueError("the reference shades with stored normals")
        self.sc = scene
        self.cfg = render
        self.groups = Groups(scene)
        dt = scene.v0.dtype
        self.sky = torch.tensor(render["sky_color"], dtype=dt,
                                device=scene.v0.device)

    def _shade_level(self, o, d, sun, depth, fan_u):
        """Radiance [N, 3] of rays o, d at `depth`; fan_u(alive_index) gives
        the depth-1 fan's uniforms [k, M, 2] of the listed rays."""
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
        if depth < cfg["reflect_depth"]:
            rad = torch.zeros_like(contrib)
            go = (hit & (refl > 0.0)).nonzero().squeeze(1)
            if go.numel():
                dr = d[go] - 2.0 * n[go] * dot(d[go], n[go])[:, None]
                rad[go] = self._shade_level(pos[go], dr, sun, depth + 1, None)
            w = torch.where(hit, refl, torch.zeros_like(refl))
            contrib = contrib + w[:, None] * rad
        if depth < cfg["diffuse_depth"]:
            k = cfg["diffuse_scatter"]
            acc = torch.zeros_like(contrib)
            go = (hit & (rough > 0.0)).nonzero().squeeze(1)
            if go.numel():
                u = fan_u(go).to(o.dtype)                     # [k, M, 2]
                dirs = cosine_fan(u, n[go][None].expand(k, -1, 3))
                m = go.numel()
                rad = self._shade_level(
                    pos[go][None].expand(k, m, 3).reshape(-1, 3),
                    dirs.reshape(-1, 3), sun, depth + 1, None
                ).reshape(k, m, 3)
                cosj = dot(n[go][None].expand(k, m, 3), dirs)
                w = color[go][None] * (cosj * rough[go][None])[..., None]
                wr = w * rad
                fan = wr[0]
                for j in range(1, k):
                    fan = fan + wr[j]
                acc[go] = fan
            contrib = contrib + acc / k
        return torch.where(hit[:, None], contrib, self.sky.expand_as(contrib))

    def pixels(self, ys, xs, sun, offs, fan_draw):
        """Gamma-corrected pixel values [P, 3] (float32) at pixels (xs, ys):
        the mean of their samples. fan_draw(chunk) gives that chunk's
        tag-1 uniforms [k, chunk_size, 2]."""
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

        rad = self._shade_level(o, d, sun.to(dev), 1, fan_u)
        return gamma(rad.float(), cfg["gamma"]).reshape(spp, p, 3).mean(0)


def primary(groups: Groups, ls, offs, width: int, height: int, spp: int,
            scale: float = 1.0):
    """The nearest hit (t [N] f32, triangle id [N], -1 on a miss) of the
    rays at places ls of a whole frame's block order."""
    dt = groups.v0.dtype
    s, y, x = ray_of_block_index(ls, spp, width)
    d = camera_dirs(s, y, x, offs, width, height, scale, dt)
    return groups.query(torch.zeros_like(d), d)
