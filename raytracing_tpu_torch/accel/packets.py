"""Host-side build of the flat cluster structure (twin of
`raytracing_tpu.accel.packets`, SAH method and Baldwin–Weber blocks only).

Each object's triangles are ordered by an exact-sweep SAH split into
contiguous runs of `cluster_size`, padded so no cluster spans two objects.
Objects smaller than a cluster go to a dense "rest set" (the ground plane).
Every field is built with numpy exactly as the JAX package builds it, so
the tables are bit-identical; `accel_from_numpy` takes the JAX package's
tables as they are.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from raytracing_tpu_torch.geometry.mesh import Mesh


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
    rest_attrs [Rr, A] — the dense rest set, None when empty."""

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
                     cs: int) -> np.ndarray:
    """Baldwin–Weber rows [C, 12, CS]: n = e1 x e2, d0 = n·v0,
    U = (e2 x n)/|n|^2, u0 = -U·v0, V = (n x e1)/|n|^2, v0c = -V·v0.
    Padding slots have n = 0 and never pass the |den| >= eps test."""
    from raytracing_tpu_torch.geometry import native

    if native.available():
        nat = native.kernel_blocks(tri_verts, valid, c, cs)
        if nat is not None:
            return nat
    m = valid[:, None].astype(np.float32)
    v0 = tri_verts[:, 0]
    e1 = (tri_verts[:, 1] - v0) * m
    e2 = (tri_verts[:, 2] - v0) * m
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
    return np.ascontiguousarray(pmt.reshape(c, cs, 12).transpose(0, 2, 1))


def first_tri_per_object(obj_id: np.ndarray, n_obj: int) -> np.ndarray:
    """[O] index of each object's first triangle (the objid-mode table
    row); an object with no triangles gets a clamped, unused row."""
    obj_id = np.asarray(obj_id)
    if obj_id.size == 0:
        return np.zeros(n_obj, dtype=np.int64)
    ft = np.minimum(np.searchsorted(np.sort(obj_id), np.arange(n_obj)),
                    obj_id.size - 1)
    return np.argsort(obj_id, kind="stable")[ft]


def build_cluster_accel(mesh: Mesh, cluster_size: int = 128,
                        method: str = "auto", rest_max: int = 64,
                        variants="auto", device=None) -> ClusterAccel:
    """Host-side (numpy) build; tensors land on `device` (default: the
    mesh's). Only the SAH method ("auto" = "sah") and the Baldwin–Weber
    ("pmt") block family are ported."""
    if method not in ("auto", "sah"):
        raise NotImplementedError(
            f"accel method {method!r}: only the SAH build is ported "
            "(ROADMAP Queue 1 item 3)")
    if variants not in ("auto", ("pmt",)):
        raise NotImplementedError(
            f"block variants {variants!r}: only 'pmt' is ported "
            "(ROADMAP Queue 1 item 13)")
    device = mesh.verts.device if device is None else device
    verts = mesh.verts.cpu().numpy()
    tri_v = mesh.tri_v.cpu().numpy()
    obj_id = mesh.obj_id.cpu().numpy()

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
        tvv = verts[tri_v[sel]]
        cent_s, blo_s, bhi_s = tvv.mean(axis=1), tvv.min(axis=1), tvv.max(axis=1)
        from raytracing_tpu_torch.geometry import native

        sub = (native.sah_sweep_order(cent_s, blo_s, bhi_s, cluster_size)
               if native.available() else None)
        if sub is None:
            sub = _sah_sweep_order(cent_s, blo_s, bhi_s, cluster_size)
        part = sel[sub]
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
    pmt_blocks = _kernel_blocks_host(tri_verts.astype(np.float32), valid,
                                     c, cluster_size)

    normals = mesh.normals.cpu().numpy().astype(np.float32)
    colors = mesh.colors.cpu().numpy().astype(np.float32)
    materials = mesh.materials.cpu().numpy().astype(np.float32)
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
    attr_blocks = attrs.reshape(c, cluster_size, attrs.shape[1]).transpose(
        0, 2, 1)

    rest_blocks = rest_ids = rest_attrs = None
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
    ), device)
