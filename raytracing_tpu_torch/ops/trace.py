"""Scene-level nearest-hit / any-hit queries, the brute-force backend (twin
of `raytracing_tpu.ops.trace`).

Every ray is tested against every triangle, in blocks of `block` triangles
so that the [R, block] intermediate stays bounded (the JAX package's scan
over blocks becomes a Python loop). It is the oracle the accelerated
backends are held against, and plain PyTorch end to end: t differentiates
into the triangles (and so into `mesh.verts`) through autograd.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from raytracing_tpu_torch.ops.intersect import INF, TriangleSoA, moller_trumbore


class Hit(NamedTuple):
    """Nearest-hit result for a ray batch: t [R] (+inf on miss), tri [R]
    (original triangle id, 0 on miss), hit [R] bool."""

    t: torch.Tensor
    tri: torch.Tensor
    hit: torch.Tensor


def _pad_tris(tri: TriangleSoA, block: int) -> Tuple[TriangleSoA, int]:
    """The triangles padded to whole blocks with degenerate ones (e1 = e2 =
    0: det 0, never hit), and the block count."""
    t = tri.v0.shape[0]
    n_blocks = max(1, -(-t // block))
    pad = n_blocks * block - t
    if pad:
        zp = tri.v0.new_zeros((pad, 3))
        tri = TriangleSoA(*(torch.cat([x, zp]) for x in tri))
    return tri, n_blocks


def nearest_hit_brute(tri: TriangleSoA, o: torch.Tensor, d: torch.Tensor,
                      eps: float = 1e-8, block: int = 512) -> Hit:
    """Nearest hit of rays o, d [R, 3] against all T triangles. Ties go to
    the lowest triangle id: `argmin` takes the first index of a block, and
    a later block replaces the best only when strictly nearer."""
    tri_p, n_blocks = _pad_tris(tri, block)
    ob, db = o[:, None, :], d[:, None, :]
    best_t = torch.full((o.shape[0],), INF, dtype=o.dtype, device=o.device)
    best_i = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
    for b in range(n_blocks):
        sl = slice(b * block, (b + 1) * block)
        t, _ = moller_trumbore(ob, db, TriangleSoA(tri_p.v0[sl], tri_p.e1[sl],
                                                   tri_p.e2[sl]),
                               best_t.detach()[:, None], eps)
        j = torch.argmin(t, dim=1)
        tj = torch.gather(t, 1, j[:, None])[:, 0]
        better = tj < best_t
        best_t = torch.where(better, tj, best_t)
        best_i = torch.where(better, (j + b * block).to(torch.int32), best_i)
    return Hit(t=best_t, tri=best_i, hit=torch.isfinite(best_t))


def any_hit_brute(tri: TriangleSoA, o: torch.Tensor, d: torch.Tensor,
                  t_max=INF, eps: float = 1e-8, block: int = 512
                  ) -> torch.Tensor:
    """Occlusion: does any triangle intersect ray (o, d) with eps < t <
    t_max? t_max: a number or an [R] tensor. Returns bool [R]."""
    tri_p, n_blocks = _pad_tris(tri, block)
    ob, db = o[:, None, :], d[:, None, :]
    tm = torch.as_tensor(t_max, dtype=o.dtype, device=o.device)
    tm = tm.expand(o.shape[0])[:, None]
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for b in range(n_blocks):
        sl = slice(b * block, (b + 1) * block)
        _, valid = moller_trumbore(ob, db, TriangleSoA(
            tri_p.v0[sl], tri_p.e1[sl], tri_p.e2[sl]), tm, eps)
        occ = occ | valid.any(dim=1)
    return occ
