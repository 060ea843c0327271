"""The reference's ray queries: every ray against every triangle by
Möller–Trumbore, with a conservative cull by groups of triangles so that
a million-triangle scene fits in seconds.

The groups come from a median split of the triangles' centroids (numpy,
on the host); a group's box is its triangles' bounds widened by a margin,
and a ray tests a group's triangles whenever the slab test cannot rule the
box out (NaN counts as entered). So the cull drops only triangles that the
ray cannot hit, and the answer is brute force's: the nearest valid t, ties
to the smallest triangle id; any valid t below t_max for occlusion.

Every floating step runs in the scene's dtype: float32 for the reference,
a lower precision for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rtbench.reference.scene import RefScene

EPS = 1e-8           # RenderConfig.eps: |det| floor and t > eps
INF = float("inf")


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def moller_trumbore(o, d, v0, e1, e2, t_max):
    """t where the ray hits the triangle (eps < t < t_max, |det| >= eps,
    u, v >= 0, u + v <= 1), else +inf; shapes broadcast."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = det.abs() >= EPS
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    s = o - v0
    u = dot(s, pvec) * inv
    qvec = cross(s, e1)
    v = dot(d, qvec) * inv
    t = dot(e2, qvec) * inv
    valid = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > EPS) & (t < t_max)
    return torch.where(valid, t, torch.full_like(t, INF))


def median_split_order(cent: np.ndarray, group: int) -> np.ndarray:
    """A permutation of the triangles whose consecutive runs of `group`
    are spatially compact: each range (starting on a multiple of `group`)
    splits at a multiple of `group` along its longest centroid axis."""
    order = np.arange(cent.shape[0])
    stack = [(0, cent.shape[0])]
    while stack:
        lo, hi = stack.pop()
        if hi - lo <= group:
            continue
        mid = lo + (math.ceil((hi - lo) / group) // 2) * group
        sub = order[lo:hi]
        c = cent[sub]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        part = np.argpartition(c[:, ax], mid - lo)
        order[lo:hi] = sub[part]
        stack += [(lo, mid), (mid, hi)]
    return order


class Groups:
    """The scene's triangles in groups of `group` (the last padded with
    degenerate triangles, id -1) with a widened box each."""

    def __init__(self, scene: RefScene, group: int = 128):
        dt, dev = scene.v0.dtype, scene.v0.device
        v0 = scene.v0.float().cpu().numpy()
        e1 = scene.e1.float().cpu().numpy()
        e2 = scene.e2.float().cpu().numpy()
        order = median_split_order(v0 + (e1 + e2) / 3.0, group)
        t = order.shape[0]
        ng = -(-t // group)
        pad = ng * group - t
        ids = np.concatenate([order, np.full(pad, -1)]).reshape(ng, group)
        safe = np.maximum(ids, 0)
        corners = np.stack([v0, v0 + e1, v0 + e2])[:, safe]  # [3, G, g, 3]
        lo = corners.min(axis=(0, 2))
        hi = corners.max(axis=(0, 2))
        margin = 1e-4 * np.maximum(np.abs(lo), np.abs(hi)).max(axis=1,
                                                               keepdims=True)
        margin = margin + 1e-6
        self.group = group
        self.ids = torch.from_numpy(ids).to(dev)
        self.lo = torch.from_numpy(lo - margin).to(dev, dt)
        self.hi = torch.from_numpy(hi + margin).to(dev, dt)
        live = torch.from_numpy(ids >= 0).to(dev)
        take = self.ids.clamp_min(0)
        zero = torch.zeros((), dtype=dt, device=dev)
        self.v0 = scene.v0[take]
        self.e1 = torch.where(live[..., None], scene.e1[take], zero)
        self.e2 = torch.where(live[..., None], scene.e2[take], zero)

    def _entered(self, o, d, t_max):
        """[R, G] bool: the slab test cannot rule group g out for ray r."""
        inv = 1.0 / d
        t1 = (self.lo[None] - o[:, None]) * inv[:, None]
        t2 = (self.hi[None] - o[:, None]) * inv[:, None]
        near = torch.minimum(t1, t2).amax(dim=-1)
        far = torch.maximum(t1, t2).amin(dim=-1)
        return ~(near > torch.minimum(far, t_max[:, None])) & ~(far < 0)

    def query(self, o, d, t_max=None, any_hit=False, budget=1 << 27):
        """Nearest (t [R] f32, tri [R] with -1 on a miss) or, with any_hit,
        occluded [R] bool, for rays o, d [R, 3] in the scene's dtype below
        t_max [R] (None: no limit)."""
        r, dev = o.shape[0], o.device
        if t_max is None:
            t_max = torch.full((r,), INF, dtype=o.dtype, device=dev)
        best = torch.full((r,), INF, dtype=torch.float32, device=dev)
        ng, g = self.ids.shape
        big = torch.iinfo(torch.int64).max
        found = []
        step = max(1, budget // (ng * 8))
        pstep = max(1, budget // (g * 16))
        for a in range(0, r, step):
            ri, gi = self._entered(o[a:a + step], d[a:a + step],
                                   t_max[a:a + step]).nonzero(as_tuple=True)
            ri = ri + a
            for p in range(0, ri.shape[0], pstep):
                rr, gg = ri[p:p + pstep], gi[p:p + pstep]
                t = moller_trumbore(o[rr][:, None], d[rr][:, None],
                                    self.v0[gg], self.e1[gg], self.e2[gg],
                                    t_max[rr][:, None])
                tp = t.amin(dim=1)
                best.scatter_reduce_(0, rr, tp.float(), "amin")
                if not any_hit:
                    ids = self.ids[gg]
                    found.append((rr, tp.float(), torch.where(
                        t == tp[:, None], ids, torch.full_like(ids, big)
                    ).amin(dim=1)))
        hit = torch.isfinite(best)
        if any_hit:
            return hit
        sel = torch.full((r,), big, dtype=torch.int64, device=dev)
        for rr, tp, ip in found:
            win = (tp == best[rr]) & torch.isfinite(tp)
            sel.scatter_reduce_(0, rr[win], ip[win], "amin")
        return best, torch.where(hit, sel, torch.full_like(sel, -1))
