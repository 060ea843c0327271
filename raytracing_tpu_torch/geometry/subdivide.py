"""Midpoint (1:4) triangle subdivision (twin of
`raytracing_tpu.geometry.subdivide`): each level splits every triangle at
its edge midpoints, sharing midpoint vertices between neighbours, so the
mesh stays watertight and indexed (T -> 4T triangles, V -> V + E vertices)
and lies on exactly the same surface. It scales the teapot to the 404k /
1.6M / 6.4M-triangle scenes. Host-side numpy, with the native library's
one-level routine (same output) where it is built."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from raytracing_tpu_torch.geometry import native


def subdivide_arrays(verts: np.ndarray, tri_v: np.ndarray, levels: int = 1
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(verts [V, 3], tri_v [T, 3]) -> subdivided (verts' f32, tri_v' i32)."""
    verts = np.asarray(verts, dtype=np.float32)
    tri_v = np.asarray(tri_v, dtype=np.int64)
    for _ in range(levels):
        out = native.subdivide_level(verts, tri_v) if native.available() \
            else None
        if out is not None:
            verts, tri_v = out[0], out[1].astype(np.int64)
            continue
        a, b, c = tri_v[:, 0], tri_v[:, 1], tri_v[:, 2]
        # One int64 key per undirected edge: np.unique on a 1-D integer
        # array is a plain sort.
        e0 = np.concatenate([a, b, c])
        e1 = np.concatenate([b, c, a])
        lo = np.minimum(e0, e1)
        hi = np.maximum(e0, e1)
        v0 = verts.shape[0]
        uniq, inv = np.unique(lo * np.int64(v0) + hi, return_inverse=True)
        ulo = uniq // v0
        uhi = uniq - ulo * v0
        mid = (verts[ulo] + verts[uhi]) * 0.5  # [E, 3]
        verts = np.concatenate([verts, mid.astype(np.float32)])
        t = tri_v.shape[0]
        mab = v0 + inv[:t]
        mbc = v0 + inv[t:2 * t]
        mca = v0 + inv[2 * t:]
        tri_v = np.concatenate([
            np.stack([a, mab, mca], 1),
            np.stack([mab, b, mbc], 1),
            np.stack([mca, mbc, c], 1),
            np.stack([mab, mbc, mca], 1),
        ])
    return verts, tri_v.astype(np.int32)
