"""Host-side build of the flat cluster structure (twin of
`raytracing_tpu.accel.packets`), and the "cluster" backend that walks it in
plain PyTorch (`nearest_hit_cluster`, `any_hit_cluster`).

Each object's triangles are ordered into contiguous runs of
`cluster_size` — by the exact-sweep SAH split (the default), its
recursive oracle, a median split, a Morton sort or the reference's vertex
index sort — padded so no cluster spans two objects. Objects smaller than
a cluster go to a dense "rest set" (the ground plane). Beside the
Baldwin–Weber blocks every walk reads, the build makes the tables of the
other intersector families a query can pick (`variant=` in
`kernels.traverse`: "mt", "pmtt", "woop"). Every field is built with
numpy (or the host library, `geometry.native`, which gives the same bits)
exactly as the JAX package builds it, so the tables are bit-identical;
`accel_from_numpy` takes the JAX package's tables as they are.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from raytracing_tpu_torch.geometry.mesh import Mesh, triangle_soa
from raytracing_tpu_torch.ops.intersect import (INF, TriangleSoA,
                                                moller_trumbore, slab_test)


# Bytes of cluster table (12 geometry rows plus the attribute rows, f32)
# that one walk launch takes as a whole; a bigger table is walked in groups
# of this size (`kernels.traverse._group_clusters`). Sized for the H100's
# 50 MB L2: the thread blocks resident at one time walk the same group, so
# its slice of the table should stay in L2 beside their rays and lists
# (a few MB). Tables below it — the reference frame's, the 404k-triangle
# scene's — are walked in one piece.
_GROUP_BLOCK_BUDGET_BYTES = 32 * 1024 * 1024


class ClusterAccel(NamedTuple):
    """order [S] i32 (packed slot -> triangle id, padding repeats 0);
    slot_valid [S] bool; cluster_min/max [C, 3] f32;
    pmt_blocks [C, 12, CS] f32 — rows n(3), d0 = n·v0, U(3), u0, V(3), v0c
    (Baldwin–Weber form: t from one plane dot, u/v from two dots);
    attr_blocks [C, A, CS] f32 — shading planes per slot, A = 4 in objid
    mode (normal(3) | obj_id) with attr_tables [O, 6] (color | material),
    A = 9 otherwise (normal | color | material) with attr_tables None;
    rest_blocks [Rr, 9] (v0 | e1 | e2), rest_ids [Rr] i32,
    rest_attrs [Rr, A] — the dense rest set, None when empty;
    grad_blocks [C, 11, CS] f32 — the backward's planes per slot, v0(3) |
    e1(3) | e2(3) | tri_id | obj_id (padding: e1 = e2 = 0, ids of triangle
    0), which a differentiated query carries beside the shading planes
    (`attr_kind="both"` in `kernels.traverse`) so that its backward needs
    no second walk; rest_grad [Rr, 11] — the same rows of the rest set.
    The ids are exact in f32 up to 2^24 triangles.

    The tables of the other intersector families, None when not built
    (`build_cluster_accel(variants=...)`): tri_blocks [C, 9, CS] — v0 |
    e1 | e2 rows (Möller–Trumbore, "mt"; padding e1 = e2 = 0);
    pmt_t_blocks [C, CS, 12] — pmt_blocks transposed (the TPU layout of
    "pmtt"; the card walks pmt_blocks, which hold the same numbers);
    woop_blocks [C, 8, 6 CS] — the Woop unit-triangle transforms in the TPU
    matmul layout ("woop"; `kernels.traverse._woop_table` rearranges them
    for the card). order_blocks [C, CS] i32 (order by cluster) and
    attr_t_blocks [C, CS, A] (attr_blocks transposed) are built with
    every accel, as in the JAX package.

    Every field is a detached value of the mesh it was built from:
    gradients reach the live mesh through `kernels.traverse`'s autograd
    functions, never through these tables. After the mesh's attributes
    change, `refit_attr_planes` refreshes the shading planes; after its
    vertices move, rebuild."""

    order: torch.Tensor
    slot_valid: torch.Tensor
    cluster_min: torch.Tensor
    cluster_max: torch.Tensor
    pmt_blocks: torch.Tensor
    attr_blocks: torch.Tensor
    attr_tables: Optional[torch.Tensor]
    rest_blocks: Optional[torch.Tensor]
    rest_ids: Optional[torch.Tensor]
    rest_attrs: Optional[torch.Tensor]
    grad_blocks: torch.Tensor
    rest_grad: Optional[torch.Tensor]
    tri_blocks: Optional[torch.Tensor] = None
    pmt_t_blocks: Optional[torch.Tensor] = None
    woop_blocks: Optional[torch.Tensor] = None
    order_blocks: Optional[torch.Tensor] = None
    attr_t_blocks: Optional[torch.Tensor] = None

    @property
    def num_clusters(self) -> int:
        return self.cluster_min.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.order.shape[0] // self.cluster_min.shape[0]

    @property
    def order_ext(self) -> torch.Tensor:
        """slot -> triangle id including rest slots (rest slot j is S + j)."""
        if self.rest_ids is None:
            return self.order
        return torch.cat([self.order, self.rest_ids])

    def to(self, device) -> "ClusterAccel":
        return ClusterAccel(*(None if f is None else f.to(device)
                              for f in self))


def accel_from_numpy(d: dict, device="cuda") -> ClusterAccel:
    """A ClusterAccel from numpy arrays under the JAX package's field names
    (e.g. `{k: np.asarray(v) for k, v in jax_accel._asdict().items()}`);
    fields the port does not use are ignored. It lands on the card unless
    `device` says otherwise."""
    fields = {}
    for name in ClusterAccel._fields:
        v = d.get(name)
        fields[name] = None if v is None else torch.tensor(
            np.ascontiguousarray(v))
    return ClusterAccel(**fields).to(device)


def _sah_sweep_order(cent: np.ndarray, blo: np.ndarray, bhi: np.ndarray,
                     cs: int) -> np.ndarray:
    """Level-synchronous exact-sweep SAH split into cs-aligned runs: at each
    node every cs-aligned split position on all three axes is costed by
    surface area x triangle count over exact swept boxes. The numpy
    fallback of the native `rt_sah_sweep_order` (same output)."""
    n = cent.shape[0]
    if n <= cs:
        return np.arange(n)
    nb = (n + cs - 1) // cs

    def sa(lo, hi):
        e = np.maximum(hi - lo, 0.0)
        return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] \
            + e[..., 2] * e[..., 0]

    ids3 = [np.argsort(cent[:, a], kind="stable") for a in range(3)]
    bounds = np.array([0, n], dtype=np.int64)
    pos = np.arange(n, dtype=np.int64)
    big = np.float32(1e30)
    blo = blo.astype(np.float32)
    bhi = bhi.astype(np.float32)
    pad = nb * cs - n

    while True:
        lens = np.diff(bounds)
        live = lens > cs
        if not live.any():
            break
        starts = bounds[:-1]
        blo_b3, bhi_b3 = [], []
        for a in range(3):
            lo_t = blo[ids3[a]]
            hi_t = bhi[ids3[a]]
            if pad:
                lo_t = np.concatenate(
                    [lo_t, np.full((pad, 3), big, np.float32)])
                hi_t = np.concatenate(
                    [hi_t, np.full((pad, 3), -big, np.float32)])
            blo_b3.append(lo_t.reshape(nb, cs, 3).min(axis=1))
            bhi_b3.append(hi_t.reshape(nb, cs, 3).max(axis=1))
        s_starts = starts[live]
        s_lens = lens[live]
        s_blocks = (s_lens + cs - 1) // cs
        s_bstart = s_starts // cs

        best_axis = np.zeros(len(s_lens), dtype=np.int64)
        best_kb = np.ones(len(s_lens), dtype=np.int64)
        order_by_len = np.argsort(-s_blocks, kind="stable")
        area_budget = 1 << 24
        g0 = 0
        while g0 < len(order_by_len):
            lmax = int(s_blocks[order_by_len[g0]])
            g1 = min(len(order_by_len),
                     g0 + max(1, area_budget // max(lmax, 1)))
            sel = order_by_len[g0:g1]
            g0 = g1
            G = len(sel)
            L = int(s_blocks[sel].max())
            bidx = s_bstart[sel][:, None] + np.arange(L)[None, :]
            inseg = np.arange(L)[None, :] < s_blocks[sel][:, None]
            bidx = np.minimum(bidx, nb - 1)
            cost = np.full((G, L), np.inf)
            axis_best = np.zeros((G, L), dtype=np.int64)
            kcand = np.arange(1, L + 1, dtype=np.int64)[None, :] * cs
            n_left = np.minimum(kcand, s_lens[sel][:, None])
            n_right = s_lens[sel][:, None] - n_left
            for a in range(3):
                glo = np.where(inseg[..., None], blo_b3[a][bidx], big)
                ghi = np.where(inseg[..., None], bhi_b3[a][bidx], -big)
                lo_pre = np.minimum.accumulate(glo, axis=1)
                hi_pre = np.maximum.accumulate(ghi, axis=1)
                lo_suf = np.minimum.accumulate(glo[:, ::-1], axis=1)[:, ::-1]
                hi_suf = np.maximum.accumulate(ghi[:, ::-1], axis=1)[:, ::-1]
                c_a = np.full((G, L), np.inf)
                c_a[:, :-1] = (
                    sa(lo_pre[:, :-1], hi_pre[:, :-1]) * n_left[:, :-1]
                    + sa(lo_suf[:, 1:], hi_suf[:, 1:]) * n_right[:, :-1])
                valid = (np.arange(1, L + 1)[None, :]
                         < s_blocks[sel][:, None])
                c_a = np.where(valid, c_a, np.inf)
                upd = c_a < cost
                cost = np.where(upd, c_a, cost)
                axis_best = np.where(upd, a, axis_best)
            j = np.argmin(cost, axis=1)
            rows = np.arange(G)
            best_axis[sel] = axis_best[rows, j]
            best_kb[sel] = j + 1

        k_seg = lens.copy()
        w_seg = np.zeros(len(lens), dtype=np.int64)
        k_seg[live] = best_kb * cs
        w_seg[live] = best_axis

        seg_of = np.searchsorted(bounds, pos, side="right") - 1
        off_in_seg = pos - starts[seg_of]
        left_mask = np.zeros(n, dtype=bool)
        for a in range(3):
            take = (w_seg[seg_of] == a) & (off_in_seg < k_seg[seg_of])
            left_mask[ids3[a][take]] = True

        c0_starts = starts[seg_of]
        for a in range(3):
            f = left_mask[ids3[a]]
            c = np.cumsum(f)
            cz = np.concatenate([[0], c])
            c_before_seg = cz[c0_starts]
            left_rank = c - c_before_seg - 1
            taken_left = k_seg[seg_of]
            right_rank = off_in_seg - (c - c_before_seg)
            newpos = np.where(f, c0_starts + left_rank,
                              c0_starts + taken_left + right_rank)
            out = np.empty(n, dtype=np.int64)
            out[newpos] = ids3[a]
            ids3[a] = out

        new_b = (starts + k_seg)[live]
        bounds = np.unique(np.concatenate([bounds, new_b]))

    return ids3[0]


def _kernel_blocks_host(tri_verts: np.ndarray, valid: np.ndarray, c: int,
                        cs: int, build_woop: bool = True):
    """(tri_blocks [C, 9, CS]: v0 | e1 | e2 rows, pmt_blocks [C, 12, CS]:
    the Baldwin–Weber rows n = e1 x e2, d0 = n·v0, U = (e2 x n)/|n|^2,
    u0 = -U·v0, V = (n x e1)/|n|^2, v0c = -V·v0, woop_blocks [C, 8, 6 CS]
    or None without `build_woop`). Padding slots have e1 = e2 = 0, so
    n = 0 and they never pass the |den| >= eps test.

    woop_blocks: per triangle M = [e1 | e2 | n]^-1 (rows c23 / det,
    c31 / det, n / det with c23 = e2 x n, c31 = n x e1, det = e1·c23) and
    const = -M v0, so that oL = M o + const and dL = M d; laid out as the
    TPU's [8, 6] matmul block per triangle (rows ox oy oz 1 dx dy dz alive,
    columns oLx oLy oLz dLx dLy dLz), quantity-major over the cluster's
    lanes. A degenerate triangle (|det| <= 1e-20) gets M = 0."""
    from raytracing_tpu_torch.geometry import native

    if native.available():
        nat = native.kernel_blocks(tri_verts, valid, c, cs, build_woop)
        if nat is not None:
            return nat
    m = valid[:, None].astype(np.float32)
    v0 = tri_verts[:, 0]
    e1 = (tri_verts[:, 1] - v0) * m
    e2 = (tri_verts[:, 2] - v0) * m
    tri_blocks = np.concatenate([v0, e1, e2], axis=1).reshape(
        c, cs, 9).transpose(0, 2, 1)
    nbw = np.cross(e1, e2)
    n2 = np.einsum("sk,sk->s", nbw, nbw)
    inv_n2 = np.where(n2 > 0, 1.0 / np.where(n2 > 0, n2, 1.0), 0.0)[:, None]
    U = np.cross(e2, nbw) * inv_n2
    V = np.cross(nbw, e1) * inv_n2
    pmt = np.concatenate(
        [nbw, np.einsum("sk,sk->s", nbw, v0)[:, None],
         U, -np.einsum("sk,sk->s", U, v0)[:, None],
         V, -np.einsum("sk,sk->s", V, v0)[:, None]],
        axis=1).astype(np.float32)
    tri_blocks = np.ascontiguousarray(tri_blocks, dtype=np.float32)
    pmt_blocks = np.ascontiguousarray(
        pmt.reshape(c, cs, 12).transpose(0, 2, 1))
    if not build_woop:
        return tri_blocks, pmt_blocks, None
    n = np.cross(e1, e2)
    c23 = np.cross(e2, n)
    c31 = np.cross(n, e1)
    det = np.einsum("sk,sk->s", e1, c23)  # = |n|^2
    ok = np.abs(det) > 1e-20
    inv_det = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)[:, None]
    m_rows = np.stack([c23 * inv_det, c31 * inv_det, n * inv_det], axis=1)
    const = -np.einsum("sqk,sk->sq", m_rows, v0)  # [S, 3]
    w = np.zeros((v0.shape[0], 8, 6), dtype=np.float32)
    w[:, 0:3, 0:3] = m_rows.transpose(0, 2, 1)
    w[:, 3, 0:3] = const
    w[:, 4:7, 3:6] = m_rows.transpose(0, 2, 1)
    woop_blocks = w.reshape(c, cs, 8, 6).transpose(0, 2, 3, 1).reshape(
        c, 8, 6 * cs)
    return tri_blocks, pmt_blocks, np.ascontiguousarray(woop_blocks)


# Orders of the build (`build_cluster_accel(method=...)`), each of one
# object's triangles into contiguous cluster-size runs.


def _morton_codes(centroids: np.ndarray) -> np.ndarray:
    """30-bit Morton (Z-order) codes of points normalized to their AABB."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    q = ((centroids - lo) / np.maximum(hi - lo, 1e-20) * 1023.0).astype(
        np.uint32)
    q = np.minimum(q, 1023)

    def expand(v):  # spread 10 bits to every 3rd bit
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (expand(q[:, 0]) << 2) | (expand(q[:, 1]) << 1) | expand(q[:, 2])


def _median_split_order(cent: np.ndarray, cs: int) -> np.ndarray:
    """Longest-axis median split into contiguous `cs`-sized runs (the leaf
    layer of an object-median BVH, flattened), level-synchronous: one
    lexsort per depth over every segment. Split counts stay multiples of
    cs so that clusters never straddle a split plane."""
    n = cent.shape[0]
    order = np.arange(n)
    bounds = np.array([0, n], dtype=np.int64)
    while True:
        lens = np.diff(bounds)
        if (lens <= cs).all():
            return order
        starts = bounds[:-1]
        c = cent[order]
        mins = np.minimum.reduceat(c, starts, axis=0)
        maxs = np.maximum.reduceat(c, starts, axis=0)
        axis = np.argmax(maxs - mins, axis=1)  # each segment's split axis
        seg_id = np.searchsorted(bounds, np.arange(n), side="right") - 1
        keyc = c[np.arange(n), axis[seg_id]]
        idx = np.lexsort((keyc, seg_id))  # stable within a segment
        order = order[idx]
        half = np.where(lens > cs,
                        np.maximum((lens // 2 // cs) * cs, cs), 0)
        new_b = (starts + half)[half > 0]
        bounds = np.unique(np.concatenate([bounds, new_b]))


def _sah_split_order(cent: np.ndarray, blo: np.ndarray, bhi: np.ndarray,
                     cs: int) -> np.ndarray:
    """Recursive SAH sweep split into contiguous `cs`-sized runs: at each
    node all three axes and every cs-aligned split position, the one of
    least surface area x triangle count. The per-node oracle of
    `_sah_sweep_order` (same objective and candidates); minutes at a
    million triangles."""
    out = []

    def sa(lo, hi):
        e = np.maximum(hi - lo, 0.0)
        return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] \
            + e[..., 2] * e[..., 0]

    def rec(ids: np.ndarray) -> None:
        k = len(ids)
        if k <= cs:
            out.append(ids)
            return
        best = None
        for ax in range(3):
            srt = ids[np.argsort(cent[ids, ax], kind="stable")]
            lo_pre = np.minimum.accumulate(blo[srt], axis=0)
            hi_pre = np.maximum.accumulate(bhi[srt], axis=0)
            lo_suf = np.minimum.accumulate(blo[srt][::-1], axis=0)[::-1]
            hi_suf = np.maximum.accumulate(bhi[srt][::-1], axis=0)[::-1]
            cands = np.arange(cs, k, cs)
            costs = (sa(lo_pre[cands - 1], hi_pre[cands - 1]) * cands
                     + sa(lo_suf[cands], hi_suf[cands]) * (k - cands))
            j = int(np.argmin(costs))
            if best is None or costs[j] < best[0]:
                best = (costs[j], srt, int(cands[j]))
        _, srt, half = best
        rec(srt[:half])
        rec(srt[half:])

    rec(np.arange(cent.shape[0]))
    return np.concatenate(out)


def _index_sort_order(tri_v: np.ndarray) -> np.ndarray:
    """The reference's locality sort: stable sort by min vertex index
    ascending, max vertex index descending."""
    mn = tri_v.min(axis=1).astype(np.int64)
    mx = tri_v.max(axis=1).astype(np.int64)
    return np.lexsort((-mx, mn)).astype(np.int32)


def _object_order(method: str, verts: np.ndarray, tv: np.ndarray,
                  cs: int) -> np.ndarray:
    """One object's triangles (corner ids tv [n, 3]) in the order of
    `method` (the JAX package's dispatch), as positions into tv."""
    from raytracing_tpu_torch.geometry import native

    if method == "index":
        return _index_sort_order(tv)
    tvv = verts[tv]
    if method == "sah":
        cent_s, blo_s, bhi_s = tvv.mean(axis=1), tvv.min(axis=1), \
            tvv.max(axis=1)
        sub = (native.sah_sweep_order(cent_s, blo_s, bhi_s, cs)
               if native.available() else None)
        return sub if sub is not None else _sah_sweep_order(
            cent_s, blo_s, bhi_s, cs)
    if method == "sah-recursive":
        return _sah_split_order(tvv.mean(axis=1), tvv.min(axis=1),
                                tvv.max(axis=1), cs)
    cent = tvv.mean(axis=1)
    if method == "median":
        return _median_split_order(cent, cs)
    nat = native.morton_order(cent) if native.available() else None
    return nat if nat is not None else np.argsort(_morton_codes(cent),
                                                  kind="stable")


def first_tri_per_object(obj_id: np.ndarray, n_obj: int) -> np.ndarray:
    """[O] index of each object's first triangle (the objid-mode table
    row); an object with no triangles gets a clamped, unused row."""
    obj_id = np.asarray(obj_id)
    if obj_id.size == 0:
        return np.zeros(n_obj, dtype=np.int64)
    ft = np.minimum(np.searchsorted(np.sort(obj_id), np.arange(n_obj)),
                    obj_id.size - 1)
    return np.argsort(obj_id, kind="stable")[ft]


METHODS = ("sah", "sah-recursive", "median", "morton", "index")
VARIANTS = ("pmt", "mt", "pmtt", "woop")
# variants="auto" builds every family up to this many triangles, only
# "pmt" above (the JAX package's rule: the woop blocks alone are 307 MB at
# 1.6M triangles).
_AUTO_VARIANTS_MAX_TRIANGLES = 100_000


def build_cluster_accel(mesh: Mesh, cluster_size: int = 128,
                        method: str = "auto", rest_max: int = 64,
                        variants="auto", device=None) -> ClusterAccel:
    """Host-side (numpy) build from the mesh's detached values; tensors
    land on `device` (default: the mesh's).

    method: "auto" (= "sah"), "sah" (the exact-sweep SAH split,
    level-synchronous), "sah-recursive" (its per-node oracle, minutes at a
    million triangles), "median" (longest-axis median split), "morton"
    (Z-order sort of the centroids; the host library's when it is there)
    or "index" (the reference's vertex-index locality sort). The JAX
    package takes any other name for "morton"; the port raises ValueError.

    variants: which intersector families' tables to build beside "pmt",
    which is always built: "auto" = all of VARIANTS up to 100,000
    triangles, ("pmt",) above; or a tuple of VARIANTS. A query that picks
    a family whose table was not built raises."""
    if method == "auto":
        method = "sah"
    if method not in METHODS:
        # The JAX package's `else` branch takes any unknown name for
        # "morton"; a misspelt method is refused here instead.
        raise ValueError(f"accel method {method!r}: one of "
                         f"{('auto',) + METHODS}")
    if variants == "auto":
        variants = (VARIANTS if mesh.tri_v.shape[0]
                    <= _AUTO_VARIANTS_MAX_TRIANGLES else ("pmt",))
    unknown = [v for v in tuple(variants) if v not in VARIANTS]
    if unknown or isinstance(variants, str):
        raise ValueError(f"block variants {variants!r}: a tuple of "
                         f"{VARIANTS} or 'auto'")
    device = mesh.verts.device if device is None else device

    def host(x):
        return x.detach().cpu().numpy()

    verts = host(mesh.verts)
    tri_v = host(mesh.tri_v)
    obj_id = host(mesh.obj_id)

    n_obj = int(obj_id.max()) + 1 if obj_id.size else 0
    counts = [int((obj_id == oi).sum()) for oi in range(n_obj)]
    any_big = any(k >= cluster_size for k in counts)
    rest_parts: list = []
    rest_budget = rest_max
    order_parts = []
    for oi in range(n_obj):
        sel = np.nonzero(obj_id == oi)[0]
        if len(sel) == 0:
            continue
        if any_big and len(sel) < cluster_size and len(sel) <= rest_budget:
            rest_parts.append(sel)
            rest_budget -= len(sel)
            continue
        part = sel[_object_order(method, verts, tri_v[sel], cluster_size)]
        pad = (-len(part)) % cluster_size
        if pad:
            part = np.concatenate([part, np.full(pad, -1, dtype=part.dtype)])
        order_parts.append(part)

    order = np.concatenate(order_parts).astype(np.int64)
    valid = order >= 0
    order = np.where(valid, order, 0)

    c = len(order) // cluster_size
    tri_verts = verts[tri_v[order]]  # [S, 3 verts, 3]
    big = np.float32(1e30)
    vmin = np.where(valid[:, None, None], tri_verts, big).reshape(
        c, -1, 3).min(axis=1)
    vmax = np.where(valid[:, None, None], tri_verts, -big).reshape(
        c, -1, 3).max(axis=1)
    tri_blocks, pmt_blocks, woop_blocks = _kernel_blocks_host(
        tri_verts.astype(np.float32), valid, c, cluster_size,
        build_woop="woop" in variants)

    normals = host(mesh.normals).astype(np.float32)
    colors = host(mesh.colors).astype(np.float32)
    materials = host(mesh.materials).astype(np.float32)
    n_obj = materials.shape[0]
    obj_colors = colors[first_tri_per_object(obj_id, n_obj)]
    uniform = n_obj <= 32 and bool((colors == obj_colors[obj_id]).all())
    if uniform:
        attrs = np.concatenate(
            [normals[order], obj_id[order][:, None].astype(np.float32)],
            axis=1) * valid[:, None]
        attr_tables = np.concatenate([obj_colors, materials], axis=1)
    else:
        attrs = np.concatenate(
            [normals[order], colors[order], materials[obj_id[order]]],
            axis=1) * valid[:, None]
        attr_tables = None
    attr_t = attrs.reshape(c, cluster_size, attrs.shape[1])
    attr_blocks = attr_t.transpose(0, 2, 1)
    # The backward's planes: v0 | e1 | e2, triangle id, object id.
    grad_blocks = np.concatenate(
        [tri_blocks,
         order.astype(np.float32).reshape(c, 1, cluster_size),
         obj_id[order].astype(np.float32).reshape(c, 1, cluster_size)],
        axis=1)

    rest_blocks = rest_ids = rest_attrs = rest_grad = None
    if rest_parts:
        rest = np.concatenate(rest_parts).astype(np.int64)
        rv = verts[tri_v[rest]].astype(np.float32)
        r_v0 = rv[:, 0]
        rest_blocks = np.concatenate([r_v0, rv[:, 1] - r_v0, rv[:, 2] - r_v0],
                                     axis=1)
        rest_ids = rest.astype(np.int32)
        if uniform:
            rest_attrs = np.concatenate(
                [normals[rest], obj_id[rest][:, None].astype(np.float32)],
                axis=1)
        else:
            rest_attrs = np.concatenate(
                [normals[rest], colors[rest], materials[obj_id[rest]]],
                axis=1)
        rest_grad = np.concatenate(
            [rest_blocks, rest.astype(np.float32)[:, None],
             obj_id[rest].astype(np.float32)[:, None]], axis=1)

    def f32(a):
        return None if a is None else np.asarray(a, dtype=np.float32)

    return accel_from_numpy(dict(
        order=order.astype(np.int32),
        slot_valid=valid,
        cluster_min=f32(vmin),
        cluster_max=f32(vmax),
        pmt_blocks=f32(pmt_blocks),
        attr_blocks=f32(attr_blocks),
        attr_tables=f32(attr_tables),
        rest_blocks=f32(rest_blocks),
        rest_ids=rest_ids,
        rest_attrs=f32(rest_attrs),
        grad_blocks=f32(grad_blocks),
        rest_grad=f32(rest_grad),
        tri_blocks=tri_blocks if "mt" in variants else None,
        pmt_t_blocks=(np.ascontiguousarray(pmt_blocks.transpose(0, 2, 1))
                      if "pmtt" in variants else None),
        woop_blocks=woop_blocks,
        order_blocks=order.astype(np.int32).reshape(c, cluster_size),
        attr_t_blocks=f32(np.ascontiguousarray(attr_t)),
    ), device)


def refit_attr_planes(accel: ClusterAccel, mesh: Mesh,
                      first_tri: Optional[np.ndarray] = None
                      ) -> ClusterAccel:
    """The accel with its shading planes (`attr_blocks`, `rest_attrs` and,
    in objid mode, `attr_tables`) rebuilt from the mesh's live, detached
    normals, colors and materials — what an inverse fit does inside every
    step, so that the walk shades with the values it differentiates
    (`attr_t_blocks` follows). Bounds, triangle blocks and `grad_blocks`
    are left as they are: after
    the vertices move, rebuild. first_tri: each object's first triangle
    (`first_tri_per_object`); computed from mesh.obj_id when not given."""
    cs, c = accel.cluster_size, accel.num_clusters
    order = accel.order.long()
    valid = accel.slot_valid[:, None].to(accel.attr_blocks.dtype)
    normals = mesh.normals.detach()
    if accel.attr_tables is not None:
        obj_plane = accel.attr_blocks[:, 3:4, :]  # the object ids stay
        nrm = (normals[order] * valid).reshape(c, cs, 3).transpose(1, 2)
        if first_tri is None:
            first_tri = first_tri_per_object(mesh.obj_id.cpu().numpy(),
                                             accel.attr_tables.shape[0])
        ft = torch.as_tensor(np.asarray(first_tri), dtype=torch.int64,
                             device=normals.device)
        tbl = torch.cat([mesh.colors.detach()[ft], mesh.materials.detach()],
                        dim=1)
        accel = _with_attr_planes(
            accel, torch.cat([nrm, obj_plane], dim=1)
        )._replace(attr_tables=tbl.contiguous())
        if accel.rest_ids is not None:
            rn = normals[accel.rest_ids.long()]
            accel = accel._replace(rest_attrs=torch.cat(
                [rn, accel.rest_attrs[:, 3:4]], dim=1).contiguous())
        return accel
    attrs = torch.cat([normals, mesh.colors.detach(),
                       mesh.materials.detach()[mesh.obj_id.long()]], dim=1)
    planes = (attrs[order] * valid).reshape(c, cs, -1).transpose(1, 2)
    accel = _with_attr_planes(accel, planes)
    if accel.rest_ids is not None:
        accel = accel._replace(
            rest_attrs=attrs[accel.rest_ids.long()].contiguous())
    return accel


def _with_attr_planes(accel: ClusterAccel, planes) -> ClusterAccel:
    """The accel with shading planes [C, A, CS], and their transposed copy
    where the accel keeps one."""
    accel = accel._replace(attr_blocks=planes.contiguous())
    if accel.attr_t_blocks is None:
        return accel
    return accel._replace(
        attr_t_blocks=planes.transpose(1, 2).contiguous())


# ---------------------------------------------------------------------------
# The cluster backend: the flat cluster structure walked in plain PyTorch
# (the JAX package's pure-XLA backend; no kernel)
# ---------------------------------------------------------------------------

# Elements of one [R, clusters, CS] temporary of the occlusion scan, which
# takes its clusters in groups (the nearest scan goes one by one), by the
# device's type: small enough to stay in the CPU's caches, large enough to
# fill a card.
_SCAN_TEMP_ELEMS = {"cpu": 1 << 20, "cuda": 1 << 26}


def packed_triangles(mesh: Mesh, accel: ClusterAccel) -> TriangleSoA:
    """The triangles in packed (cluster) order from the live vertex pool,
    so gradients reach mesh.verts; padding slots get e1 = e2 = 0 (det 0:
    never hit)."""
    tri = triangle_soa(mesh.verts, mesh.tri_v[accel.order.long()])
    m = accel.slot_valid[:, None].to(mesh.verts.dtype)
    return TriangleSoA(v0=tri.v0, e1=tri.e1 * m, e2=tri.e2 * m)


def rest_triangles(mesh: Mesh, accel: ClusterAccel) -> TriangleSoA:
    """The rest set's triangles from the live vertex pool."""
    return triangle_soa(mesh.verts, mesh.tri_v[accel.rest_ids.long()])


def _cluster_scan(tri: TriangleSoA, accel: ClusterAccel, o, d, eps,
                  nearest: bool, t_max=INF):
    """The cluster walk of the JAX package's XLA backend: every cluster's
    slab test and its members' intersections, culled work masked, not
    skipped. The nearest scan runs the clusters in order, each bounded by
    the best t so far (ties keep the earlier cluster, then the lower
    slot); occlusion ORs over groups of clusters under one fixed t_max.
    Returns (t, slot, occluded)."""
    cs, c = accel.cluster_size, accel.num_clusters
    v0, e1, e2 = (x.reshape(c, cs, 3) for x in tri)
    # Near-zero direction components are clamped before the reciprocal, so
    # that a ray starting on a box face gives no 0 * inf = NaN.
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-20, 1e-20, d)
    r = o.shape[0]
    ob, db = o[:, None, :], d[:, None, :]
    if nearest:
        best_t = torch.full((r,), INF, dtype=o.dtype, device=o.device)
        best_i = torch.zeros(r, dtype=torch.int32, device=o.device)
        for k in range(c):
            limit = best_t.detach()
            in_box = slab_test(o, inv_d, accel.cluster_min[k],
                               accel.cluster_max[k], limit)
            t, _ = moller_trumbore(ob, db, TriangleSoA(v0[k], e1[k], e2[k]),
                                   limit[:, None], eps)
            t = torch.where(in_box[:, None], t, INF)
            j = torch.argmin(t, dim=1)
            tj = torch.gather(t, 1, j[:, None])[:, 0]
            better = tj < best_t
            best_t = torch.where(better, tj, best_t)
            best_i = torch.where(better, (j + k * cs).to(torch.int32), best_i)
        return best_t, best_i, None
    tm = torch.as_tensor(t_max, dtype=o.dtype, device=o.device).expand(r)
    occ = torch.zeros(r, dtype=torch.bool, device=o.device)
    g = max(1, _SCAN_TEMP_ELEMS.get(o.device.type, 1 << 20)
            // max(1, r * cs))
    for k0 in range(0, c, g):
        ks = slice(k0, min(c, k0 + g))
        in_box = slab_test(ob, inv_d[:, None, :], accel.cluster_min[ks],
                           accel.cluster_max[ks], tm[:, None])  # [R, g]
        _, valid = moller_trumbore(
            ob[:, :, None, :], db[:, :, None, :],
            TriangleSoA(v0[ks], e1[ks], e2[ks]), tm[:, None, None], eps)
        occ = occ | (in_box & valid.any(dim=2)).any(dim=1)
    return None, None, occ


def nearest_hit_cluster(mesh: Mesh, accel: ClusterAccel, o, d,
                        eps: float = 1e-8):
    """Nearest hit through the cluster structure, with ORIGINAL triangle
    ids; the rest set merges in through a brute-force pass over the live
    vertex pool. t differentiates into mesh.verts."""
    from raytracing_tpu_torch.ops.trace import Hit, nearest_hit_brute

    t, slot, _ = _cluster_scan(packed_triangles(mesh, accel), accel, o, d,
                               eps, nearest=True)
    tri_id = accel.order[slot.long()]
    if accel.rest_ids is not None:
        hb = nearest_hit_brute(rest_triangles(mesh, accel), o, d, eps,
                               block=max(8, accel.rest_ids.shape[0]))
        better = hb.t < t
        t = torch.minimum(t, hb.t)
        tri_id = torch.where(better, accel.rest_ids[hb.tri.long()], tri_id)
    return Hit(t=t, tri=tri_id, hit=torch.isfinite(t))


def any_hit_cluster(mesh: Mesh, accel: ClusterAccel, o, d, t_max=INF,
                    eps: float = 1e-8) -> torch.Tensor:
    """Occlusion through the cluster structure and the rest set: [R] bool.
    t_max: a number or an [R] tensor."""
    from raytracing_tpu_torch.ops.trace import any_hit_brute

    _, _, occ = _cluster_scan(packed_triangles(mesh, accel), accel, o, d,
                              eps, nearest=False, t_max=t_max)
    if accel.rest_ids is not None:
        occ = occ | any_hit_brute(rest_triangles(mesh, accel), o, d, t_max,
                                  eps, block=max(8, accel.rest_ids.shape[0]))
    return occ


# ---------------------------------------------------------------------------
# Accel caches: the JAX package's .npz format (`save_accel`/`load_accel`)
# ---------------------------------------------------------------------------

_ACCEL_FORMAT_VERSION = 2
# The fields every cache must hold; the rest of ClusterAccel may be absent
# (None), as the tables of intersector families that were not built are.
_REQUIRED_FIELDS = ("order", "slot_valid", "cluster_min", "cluster_max",
                    "pmt_blocks", "attr_blocks", "grad_blocks")


def _mesh_fingerprint(mesh: Mesh) -> np.ndarray:
    """64-bit content hash of the geometry an accel was built from: sha1 of
    the verts' f32 bytes and tri_v's i32 bytes, truncated — the JAX
    package's, so either package validates the other's caches."""
    import hashlib

    h = hashlib.sha1()
    for t, dt in ((mesh.verts, np.float32), (mesh.tri_v, np.int32)):
        a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
        h.update(np.ascontiguousarray(np.asarray(a, dt)).tobytes())
    return np.frombuffer(h.digest()[:8], dtype=np.int64).copy()


def save_accel(path: str, accel: ClusterAccel,
               mesh: Optional[Mesh] = None) -> None:
    """Write a built accel to one .npz in the JAX package's format (a
    `_version` field, one array per field, absent fields left out), copied
    to the host; the file is replaced only once it is whole. With `mesh`, a
    fingerprint of its geometry is stored, which `load_accel` checks."""
    import os

    arrays = {"_version": np.int64(_ACCEL_FORMAT_VERSION)}
    if mesh is not None:
        arrays["_mesh_fp"] = _mesh_fingerprint(mesh)
    for name, value in accel._asdict().items():
        if value is not None:
            arrays[name] = value.detach().cpu().numpy()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_accel(path: str, mesh: Optional[Mesh] = None,
               cluster_size: Optional[int] = None,
               device="cuda") -> ClusterAccel:
    """Read a `save_accel` archive of either package onto `device` (the
    card unless told otherwise). Raises ValueError for a file that is not
    such an archive (no `_version`, another format version, a missing
    field), with `mesh` for a cache built from other geometry, and with
    `cluster_size` for another cluster size."""
    with np.load(path, allow_pickle=False) as z:
        files = set(z.files)
        if "_version" not in files:
            raise ValueError(f"accel file {path}: not a save_accel archive "
                             f"(no _version field)")
        version = int(z["_version"])
        if version != _ACCEL_FORMAT_VERSION:
            raise ValueError(f"accel file {path}: format v{version}, "
                             f"expected v{_ACCEL_FORMAT_VERSION}")
        missing = [k for k in _REQUIRED_FIELDS if k not in files]
        if missing:
            raise ValueError(f"accel file {path}: fields {missing} missing")
        if mesh is not None:
            if "_mesh_fp" not in files:
                raise ValueError(
                    f"accel file {path}: no mesh fingerprint recorded; "
                    f"cannot validate against the current scene")
            if int(z["_mesh_fp"][0]) != int(_mesh_fingerprint(mesh)[0]):
                raise ValueError(
                    f"accel file {path}: built from different geometry "
                    f"than the current scene (mesh fingerprint mismatch)")
        arrays = {k: z[k] for k in ClusterAccel._fields if k in files}
    accel = accel_from_numpy(arrays, device=device)
    if cluster_size is not None and accel.cluster_size != cluster_size:
        raise ValueError(f"accel file {path}: cluster_size "
                         f"{accel.cluster_size}, expected {cluster_size}")
    return accel
