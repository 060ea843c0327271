"""The reference of one step of an inverse fit of pose + vertices: the
step's loss and its gradients with respect to the pose and every vertex,
in plain torch, every floating step in one dtype (float32 for the
reference, a lower precision for the control).

The semantics followed (the renderer's of `reference/whitted.py`, with
autograd through the geometry):
- the vertex pool is the configuration's objects' vertices in the order
  it lists them, each object's in file order (`object_arrays`), and the
  triangles, those of `reference/scene.py`, index it; the fitted pose
  [rx, ry, rz, tx, ty, tz] moves the vertices of the triangles of object
  `pose_obj`: the rotation of
  axis-angle w (Rodrigues' formula, I + [w]x below an angle of 1e-5)
  about their centroid, then the translation;
- the step's rays are flat ids in [spp, H, W] order (sample s, pixel
  (x, y)); each is traced as `reference/whitted.py` traces a sample: the
  stored face normals, the sun term, the mirror below reflect_depth, the
  diffuse fan below diffuse_depth with its uniforms given per ray
  (fan_u [k, R, 2], ray i taking column i), the sky on a miss, gamma per
  sample;
- the loss is the mean over the rays and channels of the squared gap to
  the target's pixel (y, x), given per ray;
- which triangle a ray hits is brute force's under the cull of
  `reference/tracer.py` (the nearest valid t, ties to the smallest id),
  on the posed vertices, detached; so is every occlusion query. t is
  then re-derived by Moller-Trumbore from the live vertices of the
  winning triangle (edges B - A and C - A), and autograd runs through t,
  the hit points, the sun's direction, the children's origins and
  their own t, into the posed vertices, the pose and the vertices.

Departures from the port, none of which changes a value beyond
rounding: the port's forward t comes from its walk's Baldwin-Weber
planes, and its backward re-derives t from the corners v0, v0 + e1,
v0 + e2 of its planes (e1 = B - A rounded), where this reference takes
A, B and C; the port sums the loss in one reduction and scatters its
gradients by atomic adds, where this one sums blocks of rays in order.
The port's bounce levels are re-sorted for its walks; the only draw is
the first level's fan, which is never re-sorted, so the result is the
same.

- Adam's update (`adam`), written out as torch.optim.Adam's defaults
  state it (betas 0.9 and 0.999, eps 1e-8, no weight decay): from the
  state before the step (its count, first and second moments) and the
  gradient, the moments, their bias corrections and the change
  -lr m^ / (sqrt(v^) + eps).

The whole step's rays are computed in blocks of `block` rays, each
block's graph freed after its backward."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from rtbench.reference.scene import build_scene, object_arrays
from rtbench.reference.tracer import Groups, moller_trumbore
from rtbench.reference.whitted import (cosine_fan, dot, gamma, normalize,
                                       stratified_offsets)


BETAS, EPS = (0.9, 0.999), 1e-8


class Numbers(NamedTuple):
    """What a step gives and the check compares: the loss, the gradients
    of the pose [6] and of the vertices [V, 3], and the change Adam made
    to the fitted numbers (flat, in the fit's order of parameters)."""
    loss: float
    pose_grad: torch.Tensor
    verts_grad: torch.Tensor
    change: torch.Tensor


def adam(params: list, grads: list, state: list, lr: float, dtype):
    """One step of Adam, in `dtype`: params and grads lists of tensors,
    state a list of (count, first moment, second moment) before the
    step, one per parameter. Returns (the parameters after the step, the
    state after it)."""
    b1, b2 = BETAS
    out, new = [], []
    for p, g, (count, m, v) in zip(params, grads, state):
        p, g, m, v = (x.detach().to(dtype) for x in (p, g, m, v))
        t = count + 1
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * (g * g)
        m_hat = m / (1.0 - b1 ** t)
        v_hat = v / (1.0 - b2 ** t)
        out.append(p - lr * m_hat / (torch.sqrt(v_hat) + EPS))
        new.append((t, m, v))
    return out, new


def _hat(w):
    z = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def rotation(w):
    """Rodrigues' rotation [3, 3] of axis-angle w [3]."""
    theta = torch.sqrt((w * w).sum() + 1e-20)
    k = _hat(w / theta)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    r = eye + torch.sin(theta) * k + (1.0 - torch.cos(theta)) * (k @ k)
    return torch.where(theta < 1e-5, eye + _hat(w), r)


class Fit:
    """The reference of a fit's steps on one scene and frame."""

    def __init__(self, scene_cfg: dict, render: dict, pose_obj: int = 0,
                 device="cpu", dtype=torch.float32, block: int = 65536):
        if render.get("diffuse_depth", 2) > 2:
            raise ValueError("the reference follows fans at depth 1 only")
        if render.get("normals", "stored") != "stored":
            raise ValueError("the reference shades with stored normals")
        self.cfg, self.dtype, self.block = render, dtype, block
        self.device = torch.device(device)
        self.sc = build_scene(scene_cfg, self.device, dtype)
        verts, faces, obj = [], [], []
        base = 0
        for i, ob in enumerate(scene_cfg["objects"]):
            v, f, _ = object_arrays(ob)
            verts.append(v)
            faces.append(f + base)
            obj.append(np.full(f.shape[0], i))
            base += v.shape[0]
        self.verts = torch.from_numpy(np.concatenate(verts)).to(self.device)
        self.tri_v = torch.from_numpy(np.concatenate(faces)).to(self.device)
        obj = torch.from_numpy(np.concatenate(obj)).to(self.device)
        self.moved = torch.zeros(self.verts.shape[0], dtype=torch.bool,
                                 device=self.device)
        self.moved[self.tri_v[obj == pose_obj].reshape(-1)] = True
        self.sky = torch.tensor(render["sky_color"], dtype=dtype,
                                device=self.device)
        self.offs = stratified_offsets(render["samples_per_pixel"])

    def posed(self, verts, pose):
        """The vertices with the pose applied to the moved object's."""
        w = self.moved.to(verts.dtype)[:, None]
        pivot = (verts * w).sum(dim=0) / torch.clamp_min(w.sum(), 1.0)
        out = (verts - pivot) @ rotation(pose[:3]).T + pivot + pose[3:]
        return torch.where(self.moved[:, None], out, verts)

    def rays(self, ids):
        """(o, d) [R, 3] of flat ray ids in [spp, H, W] order."""
        w, h = self.cfg["width"], self.cfg["height"]
        s, rem = ids // (h * w), ids % (h * w)
        y, x = rem // w, rem % w
        offs = self.offs.to(self.device, self.dtype)
        xx = ((2.0 * (x.to(self.dtype) + offs[s, 0]) / w - 1.0)
              * (w / h) * self.cfg.get("scale", 1.0))
        yy = (1.0 - 2.0 * (y.to(self.dtype) + offs[s, 1]) / h) \
            * self.cfg.get("scale", 1.0)
        d = torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)
        return torch.zeros_like(d), d

    def _groups(self, v):
        """The culled brute force over the triangles of vertices v."""
        va, vb, vc = (v[self.tri_v[:, k]] for k in range(3))
        return Groups(self.sc._replace(v0=va, e1=vb - va, e2=vc - va))

    def _level(self, v, groups, o, d, sun, depth, fan_u):
        """Radiance [N, 3] of rays o, d at `depth`, differentiable through
        o and the vertices v; fan_u(index) gives the depth-1 fan's
        uniforms [k, M, 2] of the listed rays."""
        cfg = self.cfg
        _, tri = groups.query(o.detach(), d.detach())
        hit = tri >= 0
        ti = tri.clamp_min(0)
        tv = self.tri_v[ti]
        va, vb, vc = (v[tv[:, k]] for k in range(3))
        t = moller_trumbore(o, d, va, vb - va, vc - va,
                            torch.full_like(o[:, 0], float("inf")))
        t = torch.where(hit & torch.isfinite(t), t, torch.ones_like(t))
        sc = self.sc
        n = sc.normal[ti]
        pos = o + t[:, None] * d + n * cfg["normal_offset"]
        color = sc.color[ti]
        albedo_pi, refl, rough = sc.albedo_pi[ti], sc.refl[ti], sc.rough[ti]
        to_sun = normalize(sun - pos)
        ndl = dot(n, to_sun)
        facing = hit & (ndl > 0.0)
        occluded = torch.zeros_like(hit)
        live = facing.nonzero().squeeze(1)
        if live.numel():
            occluded[live] = groups.query(pos[live].detach(),
                                          to_sun[live].detach(),
                                          any_hit=True)
        lit = facing & ~occluded
        contrib = torch.where(lit[:, None], color * (ndl * albedo_pi)[:, None],
                              torch.zeros_like(color))
        if depth < cfg["reflect_depth"]:
            go = (hit & (refl > 0.0)).nonzero().squeeze(1)
            rad = torch.zeros_like(contrib)
            if go.numel():
                dr = d[go] - 2.0 * n[go] * dot(d[go], n[go])[:, None]
                rad = rad.index_put(
                    (go,), self._level(v, groups, pos[go], dr, sun,
                                       depth + 1, None))
            w = torch.where(hit, refl, torch.zeros_like(refl))
            contrib = contrib + w[:, None] * rad
        if depth < cfg["diffuse_depth"]:
            k = cfg["diffuse_scatter"]
            acc = torch.zeros_like(contrib)
            go = (hit & (rough > 0.0)).nonzero().squeeze(1)
            if go.numel():
                u = fan_u(go).to(self.dtype)
                dirs = cosine_fan(u, n[go][None].expand(k, -1, 3))
                m = go.numel()
                rad = self._level(
                    v, groups, pos[go][None].expand(k, m, 3).reshape(-1, 3),
                    dirs.reshape(-1, 3), sun, depth + 1, None
                ).reshape(k, m, 3)
                cosj = dot(n[go][None].expand(k, m, 3), dirs)
                w = color[go][None] * (cosj * rough[go][None])[..., None]
                wr = w * rad
                fan = wr[0]
                for j in range(1, k):
                    fan = fan + wr[j]
                acc = acc.index_put((go,), fan)
            contrib = contrib + acc / k
        return torch.where(hit[:, None], contrib, self.sky.expand_as(contrib))

    def step(self, verts, pose, ids, fan_u, target, sun):
        """(loss, grad of the pose [6], grad of the vertices [V, 3]), all
        float32, of the step on rays `ids` [R] with the parameters verts
        [V, 3] and pose [6]; fan_u [k, R, 2] the first level's fan
        uniforms, target [R, 3] each ray's pixel of the fitted image,
        sun [3]."""
        dt, dev = self.dtype, self.device
        vp = verts.detach().to(dev, dt).requires_grad_()
        pp = pose.detach().to(dev, dt).requires_grad_()
        ids = ids.to(dev)
        with torch.no_grad():
            groups = self._groups(self.posed(vp, pp))
        r = ids.shape[0]
        tgt = target.to(dev, dt)
        sun = sun.to(dev, dt)
        fan_u = fan_u.to(dev)
        total = torch.zeros((), dtype=torch.float64, device=dev)
        for a in range(0, r, self.block):
            sel = ids[a:a + self.block]
            o, d = self.rays(sel)
            v = self.posed(vp, pp)
            rad = self._level(v, groups, o, d, sun, 1,
                              lambda i: fan_u[:, a + i])
            rgb = gamma(rad, self.cfg["gamma"])
            part = ((rgb - tgt[a:a + self.block]) ** 2).sum() / (3 * r)
            part.backward()
            total += part.detach().double()
        return (float(total), pp.grad.float(), vp.grad.float())


def compare(got: Numbers, ref: Numbers) -> dict:
    """The check's numbers of a step's `Numbers` against the reference's;
    NaN reads as infinite. `step_rel_err` is the gap of the change Adam
    made over the norm of the reference's: a state left unchanged reads
    1."""

    def rel(a, b):
        a = a.to(b.device)
        gap = float(torch.linalg.norm((a.float() - b.float()).reshape(-1)))
        base = float(torch.linalg.norm(b.float().reshape(-1)))
        x = gap / base if base > 0 else (0.0 if gap == 0 else math.inf)
        return math.inf if math.isnan(x) else x

    r_loss = ref.loss
    loss_err = (abs(float(got.loss) - r_loss) / abs(r_loss) if r_loss
                else math.inf)
    return {"loss_rel_err": math.inf if math.isnan(loss_err) else loss_err,
            "pose_grad_rel_err": rel(got.pose_grad, ref.pose_grad),
            "verts_grad_rel_err": rel(got.verts_grad, ref.verts_grad),
            "step_rel_err": rel(got.change, ref.change)}
