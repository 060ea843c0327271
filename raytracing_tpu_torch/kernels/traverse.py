"""Cluster traversal: visit lists, the hand-written CUDA kernels and their
plain PyTorch versions (twin of `raytracing_tpu.kernels.traverse`).

A pack query runs in three phases over tiles of consecutive rays, 1024 by
default (`RAY_TILE`; a query's `ray_tile=` picks any positive multiple of
128, `check_query_tile`: the renderer's bounce levels take
`RenderConfig.gi_ray_tile`, whose smaller tiles give their incoherent rays
tighter frustums). A kernel launch takes a tile of `RAY_TILES`; a wrapper
given another tile T launches at s, the largest of them dividing T, and
folds the k = T / s launch tiles of each tile into it (`_split_tile`):

  phase 1 — per-tile min/max of the alive rays' origins and directions
      (K6's extents);
  phase 2 — an interval slab test of each tile's frustum against every
      cluster AABB, compacted into a front-to-back list (ids sorted by
      entry-t lower bound). Phases 1 and 2 are one launch of `tile_lists`
      (csrc/lists.cu); where the extents come from elsewhere —
      `refine_dense_extents` (K5, which reduces them in its own launch;
      bounce queries AND in its bits: the clusters some alive ray of the
      tile actually enters), K3's groups, a tile composed from launch
      tiles (K6 alone, `tile_extents`) — one launch of
      `lists_from_extents`; camera mode derives its frustums in the list
      kernel itself (`camera_lists`). Above 512 clusters a bounce query
      re-tests the listed candidates with `refine_lists` (K5, gathered
      form) and compacts again;
  phase 3 — `walk` (K1/K2): intersect each listed cluster's triangles,
      with the Baldwin–Weber test "pmt" or, for a pack whose rays share
      one origin (`shared_origin=`), its origin-folded form "pmto"; a
      query may pick another intersector family (`variant=`: "mt"
      Möller–Trumbore, "woop" the Woop transform, "pmtt" the TPU's
      transposed pmt layout, whose arithmetic the card runs as "pmt"). A
      table bigger than the group budget (`_group_clusters`) is walked in
      groups of clusters: one launch of `walk_gstream` (K3) over per-group
      lists. With `_WQ_IMPL = "grid"` a `wq` query takes `walk_wq` (K4),
      whose unit of work is a few visits of a tile for one 128-lane warp,
      each warp culling the visits none of its rays enters, instead of
      K2. An occlusion query may carry a per-ray limit
      (`tmax_row`) in place of the scalar `t_max`. K1/K2 cut a tile's list
      into segments for many blocks themselves (`_walk_segment`), merged
      per ray in any order, with the early exit kept exact across blocks.
      With `lane_cull=` K1 skips a visit none of a warp's alive rays
      enters (the TPU's lane-cull pre-test).

A capped nearest query (`nearest_hit_attrs_soa(t_cap=)`) runs in two
phases: the first accepts only hits before the cap, with the frustum lists
and the refinement clipped to it; the rays it settles are done, the rest
are walked again uncapped.

Camera mode (`nearest_hit_camera_soa`) answers the primary level without a
ray pack: a tile is one bh x bw pixel block x spp samples, its frustum
comes from a closed form (`_camera_tile_extents`; in the list kernel on
the card, `camera_lists`), and `walk_camera`
(K1 camera / K2 camera) derives each ray's direction from its tile index.

Each kernel has a public function that runs its plain PyTorch version for
a CPU tensor and launches the kernel for a CUDA tensor (raising if it
cannot), and a launch count in `LAUNCHES`; each walk wrapper and list
build runs in its span (`rt.walk`, `rt.lists`; `utils.profiling`) and,
under `counting(True)`, adds its visits to `COUNTERS`; the glue around
them runs in `rt.pack` (ray packs), `rt.tables` (a walk's tables: the
origin fold, the combined geometry and attribute table, boxes),
`rt.merge` (the rest set's merge: the triangles of objects too small for a
cluster, tested against every ray of a query, one launch of csrc/rest.cu
on the card) and `rt.attrs` (a hit's attribute rows).

Ray packs are SoA [8, N] with rows (ox oy oz 1 dx dy dz ALIVE), N a
multiple of the tile (a public query pads its pack to whole tiles of its
own tile and of `RAY_TILE`, `_pad_rays_soa`, so a tile is T consecutive
rays from ray 0, as in the JAX package); dead lanes (row 7 == 0) are
left out of the culling and their results are meaningless.

Gradients: which triangle a ray hits is a traversal decision and stays
detached. A nearest query that something differentiates (`_ShadedWalk`)
walks with the backward's 11 planes of the winner (v0 | e1 | e2 | tri_id
| obj_id, `attr_kind="both"`) beside its shading planes, through the
same kernels, and its backward re-derives t from them and adds the
gradients into the mesh's tables (`ops.scatter`); `nearest_hit`'s t
(`_LazyT`) re-derives from the live vertices instead.

A visit list is as wide as the cluster table: the card has no scratch
budget that forces the TPU's narrower lists, so no list is ever cut short
and the TPU walk's overflow rescan (and the work-queue walk's residual
launch) has no counterpart here.
"""

from __future__ import annotations

import ctypes
import math
import numbers
import weakref
from typing import NamedTuple, Optional, Tuple

import torch

from raytracing_tpu_torch.accel import packets
from raytracing_tpu_torch.accel.packets import ClusterAccel
from raytracing_tpu_torch.kernels import cuda
from raytracing_tpu_torch.ops.intersect import (INF, TriangleSoA,
                                                moller_trumbore)
from raytracing_tpu_torch.ops.linalg import device_scalar
from raytracing_tpu_torch.ops.scatter import segment_scatter_add
from raytracing_tpu_torch.utils.profiling import (COUNTERS, host_sync, span,
                                                  spanned)

RAY_TILE = 1024
# The culling tiles one kernel launch takes (csrc/common.cuh's ray_tile_ok):
# whole warps of 4-ray threads, a block of ray_tile / 4, that divide
# RAY_TILE. A query takes any multiple of the 128-lane row (`RAY_ROW`), as
# the JAX package does: the wrappers build it from launches at these.
RAY_TILES = (128, 256, 512, 1024)
RAY_ROW = 128
# Visits per early-exit vote for a 16-triangle cluster; scaled down for
# bigger clusters (_ee_batch_for), as the TPU walk does.
EARLY_EXIT_BATCH = 4
_EARLY_EXIT_MIN_CLUSTERS = 64
# Largest cluster table the dense refinement (K5) takes; bigger tables go
# through its gathered form, `refine_lists`.
_REFINE_DENSE_MAX_C = 512
# The gathered form deals a tile's list to blocks in runs of this many
# positions, to at most `_MAX_REFINE_BLOCKS` blocks a tile (`_refine_grid`).
_REFINE_RUN = 64
_MAX_REFINE_BLOCKS = 64
# Camera mode pools tile frustums into ~32x32-pixel supertiles above this
# many clusters (the TPU package's rule).
_SUPERTILE_MIN_C = 2048
# Widest list row csrc/lists.cu sorts in shared memory (its kSortCap); a
# wider row sorts through device-memory scratch (`_lists_scratch`).
_LISTS_SORT_CAP = 16384
_TINY = 1e-20
_BIG = 3e38
_BIG_ID = 2 ** 30
# Tiles per step of the plain walk and refinement, and the elements of one
# of their temporaries (bound their memory).
_PLAIN_TILE_GROUP = 64
_PLAIN_TEMP_ELEMS = 1 << 24
# What a `wq` query runs: "dma", the `_walk_dma` entry (K2), or "grid", the
# work-queue walk (K4). Both equal the `_walk_groups` entry bit for bit.
_WQ_IMPL = "dma"
# Visits per work item of K4, and the work units (one item of a 128-lane
# warp of a tile) a warp of K4 takes at a time: csrc/wq.cu's kRun, for
# counting what a launch merges.
WQ_U = 4
WQ_RUN = 2
# K1/K2 split a tile's list over blocks: a block walks a segment of about
# this many triangles (`_walk_segment`), whole stages of the kernels'
# 128-triangle staging ring.
_SEGMENT_TRIANGLES = 256
_STAGE_TRIANGLES = 128
# The camera walk's and K3's segments follow the launch (`_split_segment`):
# one stage a segment for a launch of few tiles, four for one of many.
_SHORT_SEGMENT_TRIANGLES = 128
_LONG_SEGMENT_TRIANGLES = 512
_MANY_TILES = 1024
# ... and the most blocks one tile's list is dealt to: a list of more
# segments gives each block several, so a table far wider than the lists
# listed from it does not fill the grid with blocks that find nothing.
_MAX_TILE_BLOCKS = 64

# The intersector families a query may pick (`variant=`; the accel build's
# names), and the codes the walk kernels take for them (csrc/walk_core.cuh's
# Family): "pmto" is "pmt" with a shared origin folded into the table,
# "pmtt" runs as "pmt".
VARIANTS = packets.VARIANTS
PMT, PMTO, MT, WOOP = 0, 1, 2, 3
# Geometry rows a family's table holds per cluster.
_FAMILY_ROWS = {PMT: 12, PMTO: 12, MT: 9, WOOP: 12}

# Kernel launches since the last reset: "extents" counts K6 alone,
# "lists" the list build from a ray pack (K6's extents and the lists in one
# launch), "lists_ext" the list build from extents given, "lists_camera"
# camera mode's lists from the camera itself (`camera_lists`), and for the
# pooled lists "lists_camera_pooled" (the supertiles' lists) and
# "lists_camera_members" (the blocks' re-test of their candidates),
# "refine" the dense
# refinement with tile-alive flags given (K5), "refine_extents" the dense
# refined-list query (K5 with K6's extents), "walk" the `_walk_groups`
# entry (the TPU's K1), "walk_dma" the `_walk_dma` entry (K2),
# "walk_both" / "walk_dma_both" the same two carrying the backward's planes
# beside the shading planes (a differentiated query, attr_kind "both"),
# "walk_camera" / "walk_camera_dma" their camera-mode forms, "walk_gstream"
# the streamed-groups walk (K3), "walk_wq" the work-queue walk (K4) and
# "rest_merge" the rest set's merge into a query's results (rest.cu).
# The forms off the main paths count under the same names with a suffix
# (`_count_key`): "_mt" / "_woop" for those intersector families,
# "_capped" for a launch under a two-phase query's cap, "_lc" with the
# lane-cull pre-test, "_rt256" (and so on) for a launch tile other than
# RAY_TILE: a query's tile outside RAY_TILES counts under the tile its
# launches ran at (`_split_tile`). The dict is the launch family of
# `utils.profiling.COUNTERS`.
LAUNCHES = COUNTERS.launches
LAUNCHES.update({"extents": 0, "lists": 0, "lists_ext": 0,
                 "lists_camera": 0, "lists_camera_pooled": 0,
                 "lists_camera_members": 0, "refine": 0, "refine_extents": 0,
                 "refine_lists": 0, "walk": 0, "walk_dma": 0, "walk_both": 0,
                 "walk_dma_both": 0, "walk_camera": 0, "walk_camera_dma": 0,
                 "walk_gstream": 0, "walk_wq": 0, "rest_merge": 0})


def _count_key(entry: str, family: int = PMT, capped: bool = False,
               lane_cull: bool = False, ray_tile: int = RAY_TILE) -> str:
    """The LAUNCHES name of a launch: `entry`, suffixed by its family
    ("_mt", "_woop"; pmt and pmto count as the entry itself), "_capped",
    "_lc" and its tile where that is not RAY_TILE ("_rt256")."""
    return (entry + {MT: "_mt", WOOP: "_woop"}.get(int(family), "")
            + ("_capped" if capped else "") + ("_lc" if lane_cull else "")
            + ("" if ray_tile == RAY_TILE else f"_rt{ray_tile}"))


def check_ray_tile(ray_tile: Optional[int]) -> int:
    """A kernel launch's culling tile: `ray_tile`, or RAY_TILE for None;
    raises ValueError unless it is one of RAY_TILES."""
    if ray_tile is None:
        return RAY_TILE
    if isinstance(ray_tile, bool) or ray_tile not in RAY_TILES:
        raise ValueError(f"ray_tile {ray_tile!r}: the kernels take tiles of "
                         f"{', '.join(map(str, RAY_TILES))} rays")
    return int(ray_tile)


def check_query_tile(ray_tile: Optional[int]) -> int:
    """A query's culling tile: `ray_tile`, or RAY_TILE for None; raises
    ValueError unless it is a positive multiple of RAY_ROW (128)."""
    if ray_tile is None:
        return RAY_TILE
    if (isinstance(ray_tile, bool)
            or not isinstance(ray_tile, numbers.Integral)
            or ray_tile <= 0 or ray_tile % RAY_ROW):
        raise ValueError(f"ray_tile {ray_tile!r}: a query's culling tile is "
                         f"a positive multiple of {RAY_ROW} rays (the "
                         f"kernels, like the TPU's, lay rays out in "
                         f"{RAY_ROW}-lane rows)")
    return int(ray_tile)


def _split_tile(ray_tile: Optional[int]) -> Tuple[int, int]:
    """(s, k) of a query's tile T (`check_query_tile`): s the largest of
    RAY_TILES that divides T, k = T / s. A tile's results are exact at
    any tile, so a wrapper launches at s with every list repeated for the
    k launch tiles of its tile, and folds what is per tile: extents by
    min / max (a dead launch tile's +/-3e38 drop out), entered bits by
    any."""
    t = check_query_tile(ray_tile)
    s = max(r for r in RAY_TILES if t % r == 0)
    return s, t // s


def _per_subtile(x: Optional[torch.Tensor], k: int, dim: int = 0):
    """x's per-tile entries along `dim` repeated for the k launch tiles of
    each tile (None stays None)."""
    return None if x is None else x.repeat_interleave(k, dim=dim).contiguous()


def _fold_extents(lo, hi, k: int):
    """(lo, hi) [nt * k, 8] of launch tiles -> [nt, 8] of their tiles."""
    return (lo.reshape(-1, k, 8).amin(dim=1),
            hi.reshape(-1, k, 8).amax(dim=1))


def _fold_any(bits, k: int):
    """[nt * k, W] bool of launch tiles -> [nt, W]: set in some of them."""
    return bits.reshape(-1, k, bits.shape[-1]).any(dim=1)


def _count(key: str) -> None:
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1


class Hit(NamedTuple):
    """t [N] (+inf on miss), tri [N] (packed slot id, 0 on miss), hit [N]."""

    t: torch.Tensor
    tri: torch.Tensor
    hit: torch.Tensor


def reset_launches() -> None:
    """Zero LAUNCHES."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _count_rays(kind: str, n: int, alive=None) -> None:
    """A query entry's lanes (`rays.<kind>`, "nearest" or "shadow") and,
    under counting, its alive lanes (`alive.<kind>`)."""
    COUNTERS.add("rays." + kind, n)
    if COUNTERS.counting:
        COUNTERS.add_device("alive." + kind,
                            n if alive is None else alive.sum())


def _count_walk(visits, cnt, width: int, lanes: int, passes: int = 1) -> None:
    """Under counting, a walk launch's `walk.listed` (its lists' counts up
    to their width, x `passes` where a tile is walked in several),
    `walk.visits` (the kernel's per-tile counts, or None: every listed
    one) and `walk.lane_tests` (visits x `lanes`, its tile's rays x the
    cluster size)."""
    listed = torch.clamp(cnt, 0, width).sum(dtype=torch.int64) * passes
    v = listed if visits is None else visits.sum(dtype=torch.int64)
    COUNTERS.add_device("walk.listed", listed)
    COUNTERS.add_device("walk.visits", v)
    COUNTERS.add_device("walk.lane_tests", v * lanes)


def _ee_batch_for(cs: int) -> int:
    return max(1, min(EARLY_EXIT_BATCH, 128 // cs))


def _dma_ee_batch(cs: int) -> int:
    """The TPU `_dma_walk_kernel` votes every max(1, batch // 2) visit
    PAIRS."""
    return 2 * max(1, _ee_batch_for(cs) // 2)


def _walk_segment(cs: int, triangles: Optional[int] = None) -> int:
    """List positions one block of a split walk takes: whole stages of
    `_STAGE_TRIANGLES // cs` clusters, `triangles` (default
    `_SEGMENT_TRIANGLES`) or one stage if that is more — 16 visits at CS
    16, 2 at CS 128. A multiple of every vote batch (`_ee_batch_for`,
    `_dma_ee_batch`)."""
    triangles = _SEGMENT_TRIANGLES if triangles is None else triangles
    stage = max(1, _STAGE_TRIANGLES // cs)
    return stage * max(1, triangles // (stage * cs))


def _walk_grid(who: str, nt: int, width: int, per_block: int,
               most: Optional[int] = None) -> int:
    """Blocks per tile of a walk whose grid holds ceil(width / per_block)
    of them, at most `most`, for each of nt tiles; raises above what one
    launch takes."""
    tile_blocks = -(-width // per_block)
    if most is not None:
        tile_blocks = min(tile_blocks, most)
    if nt * tile_blocks >= 2 ** 31:
        raise ValueError(f"{who}: {nt} tiles of {width} listed visits, "
                         f"{per_block} to a block, make {nt * tile_blocks} "
                         f"blocks; one launch takes fewer than 2**31")
    return tile_blocks


def _split_segment(cs: int, tiles: int) -> int:
    """Segment of the camera walk and K3 for a launch of `tiles` tiles (or
    camera passes): `_SHORT_SEGMENT_TRIANGLES` below `_MANY_TILES`, where
    the tiles' lists must be cut fine to fill the card (a frame's chunk of
    64 tiles), `_LONG_SEGMENT_TRIANGLES` above, where the tiles fill it and
    shorter segments only add blocks that find nothing (a whole frame of
    2,500: NVIDIA H100 80GB HBM3, 700 W, tools/kernel_ab.py --sweep, 128 /
    256 / 512 triangles: camera chunk 0.091-0.093 / 0.118-0.124 /
    0.121 ms, K3 chunk 0.38-0.40 / 0.45 / 0.44-0.49; camera at 1.6M 3.16 /
    2.95-2.96 / 2.77, K3 at 1.6M 3.96-3.98 / 3.47 / 3.23-3.24)."""
    return _walk_segment(cs, _SHORT_SEGMENT_TRIANGLES if tiles < _MANY_TILES
                         else _LONG_SEGMENT_TRIANGLES)


def _camera_grid(n_tiles: int, ray_tile: int, width: int, cs: int):
    """(segment, blocks per pass, passes) of a camera walk launch: a tile
    is walked in passes of up to `RAY_TILE` rays, each pass's list split
    as `walk` splits one (`_split_segment`)."""
    passes = -(-ray_tile // RAY_TILE)
    seg = _split_segment(cs, n_tiles * passes)
    return seg, _walk_grid("walk_camera", n_tiles * passes, width, seg,
                           _MAX_TILE_BLOCKS), passes


def _gstream_grid(nt: int, ng: int, width: int, cs: int):
    """(segment, blocks per list) of a K3 launch (`_split_segment`): a
    tile's lists in all its ng groups share one cap of `_MAX_TILE_BLOCKS`
    blocks, so a table of many groups does not fill the grid with blocks
    that find nothing."""
    seg = _split_segment(cs, nt)
    return seg, _walk_grid("walk_gstream", nt * ng, width, seg,
                           max(1, _MAX_TILE_BLOCKS // ng))


def _refine_grid(nt: int, width: int):
    """(run, blocks per tile) of a gathered refinement launch: a tile's
    list in runs of `_REFINE_RUN` positions, dealt to at most
    `_MAX_REFINE_BLOCKS` blocks."""
    return _REFINE_RUN, _walk_grid("refine_lists", nt, width, _REFINE_RUN,
                                   _MAX_REFINE_BLOCKS)


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _stream(t: Optional[torch.Tensor] = None):
    """The current stream of t's device (of the current card without t).
    A wrapper launches under `torch.cuda.device(t.device)` on this stream,
    so tensors on one card launch there whichever card is current."""
    return ctypes.c_void_p(torch.cuda.current_stream(
        None if t is None else t.device).cuda_stream)


def _on_cpu(*tensors) -> bool:
    """True for CPU tensors (plain version); False for CUDA tensors (the
    kernel); anything else raises."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        cards = {t.device for t in tensors if t is not None}
        if len(cards) > 1:
            raise ValueError(f"tensors on {sorted(map(str, cards))}: one "
                             "launch takes the tensors of one card")
        return False
    raise ValueError(f"tensors on {sorted(devs)}: the traversal runs on "
                     "CPU tensors (plain PyTorch) or CUDA tensors (kernels)")


def _check_pack(rays8: torch.Tensor, ray_tile: int = RAY_TILE) -> int:
    """The pack's tile count; raises unless the tile is a query's
    (`check_query_tile`) and the pack a contiguous f32 [8, N] with N a
    multiple of it."""
    ray_tile = check_query_tile(ray_tile)
    if (rays8.dtype != torch.float32 or rays8.dim() != 2
            or rays8.shape[0] != 8 or not rays8.is_contiguous()
            or rays8.shape[1] % ray_tile):
        raise ValueError(f"kernels take a contiguous f32 [8, N] ray pack with "
                         f"N a multiple of {ray_tile}; got "
                         f"{tuple(rays8.shape)} {rays8.dtype}")
    return rays8.shape[1] // ray_tile


def _plain_tiles(rays8: torch.Tensor, ray_tile: int) -> int:
    """The tile count of a plain version's pack; raises as `_check_pack`
    does on the tile and N (the plain versions take any dtype and
    layout)."""
    ray_tile = check_query_tile(ray_tile)
    if rays8.shape[1] % ray_tile:
        raise ValueError(f"a pack of {rays8.shape[1]} rays is not whole "
                         f"tiles of {ray_tile}")
    return rays8.shape[1] // ray_tile


# ---------------------------------------------------------------------------
# K6: per-tile extents
# ---------------------------------------------------------------------------


def tile_extents_plain(rays8: torch.Tensor, ray_tile: int = RAY_TILE):
    """Plain version of K6: (lo, hi) [N / ray_tile, 8], the masked min/max
    of the 8 rows per tile over alive lanes (dead lanes count as
    +/-3e38)."""
    nt = _plain_tiles(rays8, ray_tile)
    r = rays8.reshape(8, nt, ray_tile)
    alive = (r[7] != 0.0)[None]
    lo = torch.where(alive, r, _BIG).amin(dim=2).T.contiguous()
    hi = torch.where(alive, r, -_BIG).amax(dim=2).T.contiguous()
    return lo, hi


def _aligned16(rays8: torch.Tensor) -> torch.Tensor:
    """The pack, copied if its data does not start on 16 bytes (K6's
    reduction reads a row 16 bytes at a time)."""
    return rays8 if rays8.data_ptr() % 16 == 0 else rays8.clone()


@spanned("rt.lists")
def tile_extents(rays8: torch.Tensor, ray_tile: int = RAY_TILE):
    """K6 (csrc/extents.cu): plain version on CPU, kernel on CUDA; tiles
    of ray_tile rays (any multiple of 128: `_split_tile`)."""
    if _on_cpu(rays8):
        return tile_extents_plain(rays8, ray_tile)
    nt = _check_pack(rays8, ray_tile)
    s, k = _split_tile(ray_tile)
    if k > 1:
        return _fold_extents(*tile_extents(rays8, s), k)
    rays8 = _aligned16(rays8)
    lo = torch.empty((nt, 8), dtype=torch.float32, device=rays8.device)
    hi = torch.empty_like(lo)
    lib = cuda.library()
    with torch.cuda.device(rays8.device):
        cuda.check(lib.rt_tile_extents(_ptr(rays8), rays8.shape[1], ray_tile,
                                       _ptr(lo), _ptr(hi), _stream(rays8)),
                   "extents")
    _count(_count_key("extents", ray_tile=ray_tile))
    return lo, hi


# ---------------------------------------------------------------------------
# K5: dense entered-refinement
# ---------------------------------------------------------------------------


def _slab_enter(r, box_lo, box_hi, t_cap=None):
    """traverse.py:526-546: r [8, g, 1, RT] ray rows (RT the tile) against boxes given
    per axis by box_lo(k) / box_hi(k), each broadcastable to [g, c, 1].
    Returns [g, c, RT] bool: the alive lanes that enter each box
    (reciprocal first, degenerate axes unbounded, bounds inflated by
    2e-6*|t| + 1e-7; with t_cap, tf clipped to it after the inflation)."""
    tn = tf = None
    for k in range(3):
        dk = r[4 + k]
        deg = torch.abs(dk) < _TINY
        inv = 1.0 / torch.where(deg, _TINY, dk)
        t1 = (box_lo(k) - r[k]) * inv
        t2 = (box_hi(k) - r[k]) * inv
        lo_ = torch.where(deg, -INF, torch.minimum(t1, t2))
        hi_ = torch.where(deg, INF, torch.maximum(t1, t2))
        tn = lo_ if k == 0 else torch.maximum(tn, lo_)
        tf = hi_ if k == 0 else torch.minimum(tf, hi_)
    tf = tf + (torch.abs(tf) * 2e-6 + 1e-7)
    tn = tn - (torch.abs(tn) * 2e-6 + 1e-7)
    if t_cap is not None:
        tf = torch.clamp_max(tf, float(t_cap))
    return (tn <= tf) & (tf >= 0.0) & (r[7] != 0.0)


def _plain_groups(nt: int, width: int, ray_tile: int = RAY_TILE):
    """Tile ranges for the plain versions: at most `_PLAIN_TILE_GROUP`
    tiles and `_PLAIN_TEMP_ELEMS` elements per [g, width, ray_tile]
    temporary."""
    g = max(1, min(_PLAIN_TILE_GROUP,
                   _PLAIN_TEMP_ELEMS // max(1, width * ray_tile)))
    return [(g0, min(nt, g0 + g)) for g0 in range(0, nt, g)]


def refine_dense_plain(rays8, cluster_min, cluster_max, tile_alive,
                       t_cap=None, ray_tile: int = RAY_TILE):
    """Plain version of K5: [nt, C] bool over tiles of ray_tile rays, True
    iff the tile is alive and some alive lane of it enters the cluster's
    AABB (`_slab_enter`, before t_cap where one is given)."""
    nt = _plain_tiles(rays8, ray_tile)
    c = cluster_min.shape[0]
    out = torch.zeros((nt, c), dtype=torch.bool, device=rays8.device)
    for g0, g1 in _plain_groups(nt, c, ray_tile):
        r = rays8[:, g0 * ray_tile:g1 * ray_tile].reshape(8, g1 - g0, 1,
                                                          ray_tile)
        enter = _slab_enter(r, lambda k: cluster_min[:, k].reshape(1, c, 1),
                            lambda k: cluster_max[:, k].reshape(1, c, 1),
                            t_cap)
        out[g0:g1] = enter.any(dim=2)
    return out & tile_alive[:, None]


def _cap_arg(t_cap) -> float:
    """A kernel's cap argument: +inf for none."""
    return INF if t_cap is None else float(t_cap)


def _check_boxes(who, rays8, cluster_min, cluster_max, most=None,
                 ray_tile: int = RAY_TILE):
    """The pack's tile count (`_check_pack`); raises unless the AABB tables
    are contiguous f32 [C, 3] (C at most `most`)."""
    nt = _check_pack(rays8, ray_tile)
    _check_tables(who, cluster_min, cluster_max, most)
    return nt


def _check_tables(who, cluster_min, cluster_max, most=None):
    """Raise unless the AABB tables are contiguous f32 [C, 3] (C at most
    `most`)."""
    c = cluster_min.shape[0]
    if (cluster_min.shape != (c, 3) or cluster_max.shape != (c, 3)
            or cluster_min.dtype != torch.float32
            or cluster_max.dtype != torch.float32
            or not cluster_min.is_contiguous()
            or not cluster_max.is_contiguous()
            or (most is not None and not 0 < c <= most)):
        raise ValueError(f"{who}: the AABB tables must be contiguous f32 "
                         f"[C, 3]"
                         + ("" if most is None else f", C at most {most}"))


def refine_dense(rays8, cluster_min, cluster_max, tile_alive, t_cap=None,
                 ray_tile: int = RAY_TILE):
    """K5 (csrc/refine.cu): plain version on CPU, kernel on CUDA; tiles of
    ray_tile rays."""
    if _on_cpu(rays8, cluster_min, cluster_max, tile_alive):
        return refine_dense_plain(rays8, cluster_min, cluster_max, tile_alive,
                                  t_cap, ray_tile)
    nt = _check_boxes("refine_dense", rays8, cluster_min, cluster_max,
                      _REFINE_DENSE_MAX_C, ray_tile)
    if tile_alive.shape != (nt,):
        raise ValueError("refine_dense: one alive flag per tile")
    s, k = _split_tile(ray_tile)
    if k > 1:  # a dead launch tile of an alive tile enters nothing
        return _fold_any(refine_dense(rays8, cluster_min, cluster_max,
                                      _per_subtile(tile_alive, k), t_cap, s),
                         k)
    c = cluster_min.shape[0]
    alive = tile_alive.to(torch.int32).contiguous()
    out = torch.empty((nt, c), dtype=torch.int32, device=rays8.device)
    lib = cuda.library()
    with torch.cuda.device(rays8.device):
        cuda.check(lib.rt_refine_dense(
            _ptr(rays8), rays8.shape[1], ray_tile, _ptr(cluster_min),
            _ptr(cluster_max), c, _cap_arg(t_cap), _ptr(alive), _ptr(out),
            _stream(rays8)), "refine")
    _count(_count_key("refine", capped=t_cap is not None, ray_tile=ray_tile))
    return out != 0


def refine_dense_extents_plain(rays8, cluster_min, cluster_max, t_cap=None,
                               ray_tile: int = RAY_TILE):
    """Plain version of the dense refined-list query: (lo, hi, entered),
    K6's extents (`tile_extents_plain`) and K5's bits with the tile-alive
    flags hi[:, 7] > 0 (`refine_dense_plain`), over tiles of ray_tile."""
    lo, hi = tile_extents_plain(rays8, ray_tile)
    return lo, hi, refine_dense_plain(rays8, cluster_min, cluster_max,
                                      hi[:, 7] > 0.0, t_cap, ray_tile)


def refine_dense_extents(rays8, cluster_min, cluster_max, t_cap=None,
                         ray_tile: int = RAY_TILE):
    """The dense refined-list query, K6 folded into K5 (csrc/refine.cu):
    plain version on CPU, one kernel launch on CUDA, tiles of ray_tile
    rays. t_cap: a two-phase query's cap (a box entered only beyond it is
    not entered)."""
    if _on_cpu(rays8, cluster_min, cluster_max):
        return refine_dense_extents_plain(rays8, cluster_min, cluster_max,
                                          t_cap, ray_tile)
    nt = _check_boxes("refine_dense_extents", rays8, cluster_min,
                      cluster_max, _REFINE_DENSE_MAX_C, ray_tile)
    s, k = _split_tile(ray_tile)
    if k > 1:
        lo, hi, entered = refine_dense_extents(rays8, cluster_min,
                                               cluster_max, t_cap, s)
        return _fold_extents(lo, hi, k) + (_fold_any(entered, k),)
    c = cluster_min.shape[0]
    lo = torch.empty((nt, 8), dtype=torch.float32, device=rays8.device)
    hi = torch.empty_like(lo)
    out = torch.empty((nt, c), dtype=torch.int32, device=rays8.device)
    lib = cuda.library()
    with torch.cuda.device(rays8.device):
        cuda.check(lib.rt_refine_dense_extents(
            _ptr(rays8), rays8.shape[1], ray_tile, _ptr(cluster_min),
            _ptr(cluster_max), c, _cap_arg(t_cap), _ptr(lo), _ptr(hi),
            _ptr(out), _stream(rays8)), "refine_extents")
    _count(_count_key("refine_extents", capped=t_cap is not None,
                      ray_tile=ray_tile))
    return lo, hi, out != 0


def refine_lists_plain(rays8, ids, cnt, cluster_min, cluster_max,
                       t_cap=None, ray_tile: int = RAY_TILE):
    """Plain version of K5's gathered form: [nt, W] bool over tiles of
    ray_tile rays, True at list position j < min(cnt, W) iff some alive
    lane of the tile enters cluster ids[tile, j]'s AABB (`_slab_enter`,
    before t_cap where one is given)."""
    nt, w = ids.shape
    if nt != _plain_tiles(rays8, ray_tile):
        raise ValueError(f"refine_lists: {nt} lists for "
                         f"{rays8.shape[1] // ray_tile} tiles of {ray_tile}")
    out = torch.zeros((nt, w), dtype=torch.bool, device=rays8.device)
    for g0, g1 in _plain_groups(nt, w, ray_tile):
        r = rays8[:, g0 * ray_tile:g1 * ray_tile].reshape(8, g1 - g0, 1,
                                                          ray_tile)
        idg = ids[g0:g1].long()
        bmin, bmax = cluster_min[idg], cluster_max[idg]  # [g, W, 3]
        enter = _slab_enter(r, lambda k: bmin[:, :, k, None],
                            lambda k: bmax[:, :, k, None], t_cap)
        out[g0:g1] = enter.any(dim=2)
    pos = torch.arange(w, device=rays8.device)[None]
    return out & (pos < cnt[:, None])


def refine_lists(rays8, ids, cnt, cluster_min, cluster_max, t_cap=None,
                 ray_tile: int = RAY_TILE):
    """K5, gathered form (csrc/refine.cu): plain version on CPU, kernel on
    CUDA, tiles of ray_tile rays. The kernel reads each candidate's box
    through `ids`, and deals a tile's list to blocks in runs
    (`_refine_grid`)."""
    if _on_cpu(rays8, ids, cnt, cluster_min, cluster_max):
        return refine_lists_plain(rays8, ids, cnt, cluster_min, cluster_max,
                                  t_cap, ray_tile)
    nt = _check_boxes("refine_lists", rays8, cluster_min, cluster_max,
                      ray_tile=ray_tile)
    if (ids.dim() != 2 or ids.shape[0] != nt or cnt.shape != (nt,)
            or ids.dtype != torch.int32 or not ids.is_contiguous()):
        raise ValueError("refine_lists: ids must be contiguous i32 [nt, W] "
                         "with cnt [nt]")
    s, k = _split_tile(ray_tile)
    if k > 1:  # each launch tile re-tests its tile's whole list
        return _fold_any(refine_lists(rays8, _per_subtile(ids, k),
                                      _per_subtile(cnt, k), cluster_min,
                                      cluster_max, t_cap, s), k)
    run, tile_blocks = _refine_grid(nt, ids.shape[1])
    cnt32 = cnt.to(torch.int32).contiguous()
    out = torch.empty(ids.shape, dtype=torch.int32, device=rays8.device)
    lib = cuda.library()
    with torch.cuda.device(rays8.device):
        cuda.check(lib.rt_refine_lists(
            _ptr(rays8), rays8.shape[1], ray_tile, _ptr(ids), _ptr(cnt32),
            ids.shape[1], run, tile_blocks, _ptr(cluster_min),
            _ptr(cluster_max), _cap_arg(t_cap), _ptr(out), _stream(rays8)),
            "refine_lists")
    _count(_count_key("refine_lists", capped=t_cap is not None,
                      ray_tile=ray_tile))
    return out != 0


# ---------------------------------------------------------------------------
# Phase 2: front-to-back visit lists
# ---------------------------------------------------------------------------


def _frustum_slabs(o_lo, o_hi, d_lo, d_hi, box_lo, box_hi, t_cap=None):
    """Interval slab test of frustums against AABBs
    (traverse.py:_visit_lists_single): the extents are [..., 3] and
    box_lo(k) / box_hi(k) give axis k of the boxes, broadcastable against
    extents[..., k, None]. An axis whose direction interval spans 0 is
    unbounded. With t_cap (a capped query) the exit bound is clipped to it
    (traverse.py:351-356): no hit beyond the cap is accepted. Returns
    (flags, t_near): which boxes each frustum may enter, and a lower bound
    of the entry t."""
    t_near = t_far = None
    for k in range(3):
        spans0 = (d_lo[..., k] <= 0.0) & (d_hi[..., k] >= 0.0)
        dl = torch.where(torch.abs(d_lo[..., k]) < _TINY, _TINY, d_lo[..., k])
        dh = torch.where(torch.abs(d_hi[..., k]) < _TINY, _TINY, d_hi[..., k])
        i_lo = (1.0 / dh)[..., None]
        i_hi = (1.0 / dl)[..., None]
        e_lo = box_lo(k) - o_hi[..., k, None]
        e_hi = box_hi(k) - o_lo[..., k, None]
        p1, p2 = e_lo * i_lo, e_lo * i_hi
        p3, p4 = e_hi * i_lo, e_hi * i_hi
        t_min_ax = torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4))
        t_max_ax = torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4))
        unb = spans0[..., None]
        t_min_ax = torch.where(unb, -INF, t_min_ax)
        t_max_ax = torch.where(unb, INF, t_max_ax)
        t_near = t_min_ax if k == 0 else torch.maximum(t_near, t_min_ax)
        t_far = t_max_ax if k == 0 else torch.minimum(t_far, t_max_ax)
    if t_cap is not None:
        t_far = torch.clamp_max(t_far, float(t_cap))
    return (t_near <= t_far) & (t_far >= 0.0), t_near


def _compact_lists(flags, t_near, ids=None):
    """Flagged entries first, sorted by entry-t lower bound (stable):
    (ids [.., W] i32, tnear [.., W], cnt [..] i32); positions past cnt hold
    the unflagged entries with tnear = +inf. `ids` names the entries
    (default: their positions)."""
    keys = torch.where(flags, t_near, INF)
    tnear, perm = torch.sort(keys, dim=-1, stable=True)
    out = perm if ids is None else torch.gather(ids.expand_as(perm).long(),
                                                -1, perm)
    return out.to(torch.int32), tnear, flags.sum(dim=-1, dtype=torch.int32)


def _narrow_lists(ids, tnear, cnt):
    """Cut the lists to the longest one (at least one column): nothing
    listed is lost. Costs one host sync."""
    with host_sync("narrow_lists"):
        w = max(1, int(cnt.max())) if cnt.numel() else 1
    return ids[..., :w].contiguous(), tnear[..., :w].contiguous(), cnt


def lists_from_extents_plain(o_lo, o_hi, d_lo, d_hi, cluster_min,
                             cluster_max, t_cap=None, mask=None, groups=None,
                             alive=None):
    """Plain version of the list build from extents: each tile's frustum
    (o_lo, o_hi, d_lo, d_hi [nt, 3]) against every AABB (`_frustum_slabs`,
    clipped at t_cap if given), the flags ANDed with `mask`, compacted
    front to back (`_compact_lists`). With `groups` G the tables [G * W,
    3] are G runs of W boxes and ids are local to the run: ids, tnear [G,
    nt, W] and cnt [G, nt]; without, ids, tnear [nt, C] and cnt [nt]. mask:
    bool [nt, G * W], or [G * W] for every tile. alive: [nt]; a tile whose
    value is not above 0 lists nothing (cnt 0). Positions past cnt hold the
    unflagged boxes with tnear = +inf."""
    g = 1 if groups is None else int(groups)
    w = cluster_min.shape[0] // g
    bmin = cluster_min.reshape(g, 1, w, 3)
    bmax = cluster_max.reshape(g, 1, w, 3)
    flags, t_near = _frustum_slabs(
        o_lo[None], o_hi[None], d_lo[None], d_hi[None],
        lambda k: bmin[..., k], lambda k: bmax[..., k], t_cap)
    if mask is not None:
        flags = flags & mask.reshape(-1, g, w).transpose(0, 1)
    ids, tnear, cnt = _compact_lists(flags, t_near)
    if alive is not None:
        cnt = torch.where(alive > 0.0, cnt, 0)
    if groups is None:
        return ids[0], tnear[0], cnt[0]
    return ids, tnear, cnt


def _lists_scratch(rows: int, width: int, device):
    """(scratch, inf bits) of a list build whose rows are wider than
    `_LISTS_SORT_CAP` (None, None below): csrc/lists.cu merges their sorted
    chunks through device memory."""
    if width <= _LISTS_SORT_CAP:
        return None, None
    return (torch.empty((rows, 2, width), dtype=torch.int64, device=device),
            torch.empty((rows, -(-width // 32)), dtype=torch.int32,
                        device=device))


def _list_outputs(shape, device):
    """(ids i32, tnear f32) of `shape` and cnt i32 of shape[:-1] for a
    launch to fill; a build with nothing to launch (no tile or no box)
    lists nothing."""
    empty = torch.empty if all(shape) else torch.zeros
    return (empty(shape, dtype=torch.int32, device=device),
            empty(shape, dtype=torch.float32, device=device),
            empty(shape[:-1], dtype=torch.int32, device=device))


@spanned("rt.lists")
def lists_from_extents(o_lo, o_hi, d_lo, d_hi, cluster_min, cluster_max,
                       t_cap=None, mask=None, groups=None, alive=None):
    """The list build from extents (csrc/lists.cu `rt_lists_from_extents`):
    plain version on CPU, one kernel launch on CUDA, the results of
    `lists_from_extents_plain` bit for bit. The extents may be views at a
    row stride (K6's lo[:, 0:3]); alive a strided view (hi[:, 7])."""
    if _on_cpu(o_lo, o_hi, d_lo, d_hi, cluster_min, cluster_max, mask,
               alive):
        return lists_from_extents_plain(o_lo, o_hi, d_lo, d_hi, cluster_min,
                                        cluster_max, t_cap, mask, groups,
                                        alive)
    _check_tables("lists_from_extents", cluster_min, cluster_max)
    g = 1 if groups is None else int(groups)
    c, nt = cluster_min.shape[0], o_lo.shape[0]
    ext = (o_lo, o_hi, d_lo, d_hi)
    if g <= 0 or c % g or any(e.shape != (nt, 3) or e.dtype != torch.float32
                              for e in ext):
        raise ValueError(f"lists_from_extents: extents f32 [nt, 3] and "
                         f"{c} boxes in {g} runs of equal width")
    if len({e.stride(0) for e in ext}) > 1 or any(e.stride(1) != 1
                                                  for e in ext):
        ext = tuple(e.contiguous() for e in ext)
    w = c // g
    if mask is not None:
        if mask.dtype != torch.bool or mask.shape not in ((nt, c), (c,)):
            raise ValueError(f"lists_from_extents: a bool mask [{nt}, {c}] "
                             f"or [{c}]")
        mask = mask.contiguous()
    if alive is not None and (alive.shape != (nt,)
                              or alive.dtype != torch.float32):
        raise ValueError("lists_from_extents: alive f32 [nt]")
    ids, tnear, cnt = _list_outputs((g, nt, w), cluster_min.device)
    if g * nt and w:
        scratch, bits = _lists_scratch(g * nt, w, cluster_min.device)
        lib = cuda.library()
        with torch.cuda.device(cluster_min.device):
            cuda.check(lib.rt_lists_from_extents(
                _ptr(ext[0]), _ptr(ext[1]), _ptr(ext[2]), _ptr(ext[3]),
                ext[0].stride(0), _ptr(alive),
                0 if alive is None else alive.stride(0), nt,
                _ptr(cluster_min), _ptr(cluster_max), g, w, _cap_arg(t_cap),
                _ptr(mask), c if mask is not None and mask.dim() == 2 else 0,
                _ptr(ids), _ptr(tnear), _ptr(cnt), _ptr(scratch), _ptr(bits),
                _stream(cluster_min)), "lists_ext")
        _count(_count_key("lists_ext", capped=t_cap is not None))
    if groups is None:
        return ids[0], tnear[0], cnt[0]
    return ids, tnear, cnt


def tile_lists_plain(rays8, cluster_min, cluster_max, t_cap=None,
                     ray_tile: int = RAY_TILE):
    """Plain version of the list build from a ray pack: K6's extents
    (`tile_extents_plain`), the tiles' lists (`lists_from_extents_plain`,
    clipped at t_cap if given), and a dead tile (hi[:, 7] <= 0) listing
    nothing. Returns (lo, hi [nt, 8], ids [nt, C] i32, tnear [nt, C],
    cnt [nt] i32)."""
    lo, hi = tile_extents_plain(rays8, ray_tile)
    return (lo, hi) + lists_from_extents_plain(
        lo[:, 0:3], hi[:, 0:3], lo[:, 4:7], hi[:, 4:7], cluster_min,
        cluster_max, t_cap, alive=hi[:, 7])


@spanned("rt.lists")
def tile_lists(rays8, cluster_min, cluster_max, t_cap=None,
               ray_tile: int = RAY_TILE):
    """The list build from a ray pack (csrc/lists.cu `rt_tile_lists`: K6's
    extents and the lists in one launch): plain version on CPU, kernel on
    CUDA. A tile outside RAY_TILES (`_split_tile`) takes K6 at the launch
    tile, folded, and `lists_from_extents` at the tile."""
    if _on_cpu(rays8, cluster_min, cluster_max):
        return tile_lists_plain(rays8, cluster_min, cluster_max, t_cap,
                                ray_tile)
    nt = _check_boxes("tile_lists", rays8, cluster_min, cluster_max,
                      ray_tile=ray_tile)
    s, k = _split_tile(ray_tile)
    c = cluster_min.shape[0]
    if k > 1 or not c:
        lo, hi = tile_extents(rays8, ray_tile)
        return (lo, hi) + lists_from_extents(
            lo[:, 0:3], hi[:, 0:3], lo[:, 4:7], hi[:, 4:7], cluster_min,
            cluster_max, t_cap, alive=hi[:, 7])
    rays8 = _aligned16(rays8)
    dev = rays8.device
    lo = torch.empty((nt, 8), dtype=torch.float32, device=dev)
    hi = torch.empty_like(lo)
    ids, tnear, cnt = _list_outputs((nt, c), dev)
    scratch, bits = _lists_scratch(nt, c, dev)
    lib = cuda.library()
    with torch.cuda.device(rays8.device):
        cuda.check(lib.rt_tile_lists(
            _ptr(rays8), rays8.shape[1], ray_tile, _ptr(cluster_min),
            _ptr(cluster_max), c, _cap_arg(t_cap), _ptr(lo), _ptr(hi),
            _ptr(ids), _ptr(tnear), _ptr(cnt), _ptr(scratch), _ptr(bits),
            _stream(rays8)), "lists")
    _count(_count_key("lists", capped=t_cap is not None, ray_tile=ray_tile))
    return lo, hi, ids, tnear, cnt


def _tile_visit_lists_soa(rays8, cluster_min, cluster_max, t_cap=None,
                          ray_tile: int = RAY_TILE):
    """Frustum lists (ids, tnear, cnt) of the pack's tiles of ray_tile
    rays (`tile_lists`); a dead tile lists nothing."""
    return tile_lists(rays8, cluster_min, cluster_max, t_cap, ray_tile)[2:]


# ---------------------------------------------------------------------------
# K1/K2: the walk
# ---------------------------------------------------------------------------


@spanned("rt.tables")
def _fold_origin(pmt_blocks, o):
    """[C, 12, CS] Baldwin–Weber blocks -> origin-folded blocks for the
    "pmto" intersector: d0' = d0 - n·o, u0' = u0 + U·o, v0' = v0c + V·o,
    o a [3] tensor (traverse.py:_fold_origin)."""
    o = o.to(pmt_blocks.dtype)

    def dot_o(rows):
        return (rows[:, 0:1] * o[0] + rows[:, 1:2] * o[1]) + rows[:, 2:3] * o[2]

    n, d0 = pmt_blocks[:, 0:3], pmt_blocks[:, 3:4]
    u_, u0 = pmt_blocks[:, 4:7], pmt_blocks[:, 7:8]
    v_, v0 = pmt_blocks[:, 8:11], pmt_blocks[:, 11:12]
    return torch.cat([n, d0 - dot_o(n), u_, u0 + dot_o(u_), v_,
                      v0 + dot_o(v_)], dim=1)


def _winner_attrs(attr, s_out, n_attrs: int, cs: int):
    """The winners' attribute rows [A, N] from slots s_out [1, N]; 0 on
    miss lanes (slot 2^30). None without attributes."""
    if not n_attrs:
        return None
    hit = s_out[0] != _BIG_ID
    s = torch.where(hit, s_out[0], 0).long()
    attrs = attr[s // cs, :n_attrs, s % cs].T  # [A, N]
    return torch.where(hit[None], attrs, 0.0)


def _merge_nearest(best_t, best_s, t, s):
    """Fold (t, s) into (best_t, best_s) by min t, then min slot; an
    infinite t never ties. The order of the folds does not matter."""
    upd = (t < best_t) | ((t == best_t) & (t < INF) & (s < best_s))
    return torch.minimum(best_t, t), torch.where(upd, s, best_s)


def _woop_table(woop_blocks) -> torch.Tensor:
    """The [C, 12, CS] table the woop walk stages, from the TPU's
    [C, 8, 6 CS] matmul blocks by copies alone: rows 3 q + k = M[q][k]
    (the coefficient of axis k in oL's and dL's component q, block row k,
    column q), rows 9 + q = const[q] (block row 3, column q). Block rows
    4-6 repeat M for the direction and row 7 (the alive flag) meets
    zeros: neither is staged. Built once per table (`_WOOP_TABLES`)."""
    key = id(woop_blocks)
    held = _WOOP_TABLES.get(key)
    if held is not None and held[0]() is woop_blocks:
        return held[1]
    c, _, cs6 = woop_blocks.shape
    w = woop_blocks.reshape(c, 8, 6, cs6 // 6)
    m = w[:, 0:3, 0:3].transpose(1, 2).reshape(c, 9, cs6 // 6)
    tab = torch.cat([m, w[:, 3, 0:3]], dim=1).contiguous()
    _WOOP_TABLES[key] = (weakref.ref(woop_blocks), tab)
    weakref.finalize(woop_blocks, _WOOP_TABLES.pop, key, None)
    return tab


# id(woop_blocks) -> (a weak reference to it, its `_woop_table`); an entry
# goes with its table.
_WOOP_TABLES: dict = {}


def _lane_cull_keep(pack, act, cl, lane_bounds):
    """The visits of the lane-cull pre-test (traverse.py:lane_cull_cond):
    [na] bool, True where some alive ray of tile act[i] enters cluster
    cl[i]'s box (`_lane_enters`)."""
    return _lane_enters(pack, act, cl, lane_bounds).any(dim=1)


def _lane_enters(pack, act, cl, lane_bounds):
    """[na, RT] bool: lane k of tile act[i] (pack [8, nt, 1, RT]) is alive
    and enters cluster cl[i]'s box (lane_bounds [C, 6], min | max) by the
    TPU's slab test — IEEE division, a degenerate axis unbounded, the
    interval inflated by 2e-6 |t| + 1e-7."""
    box = lane_bounds[cl.long()][:, :, None]  # [na, 6, 1]
    tn = tf = None
    for k in range(3):
        dk = pack[4 + k, act, 0]  # [na, RT]
        ok = pack[k, act, 0]
        deg = torch.abs(dk) < _TINY
        dsafe = torch.where(deg, _TINY, dk)
        t1 = (box[:, k] - ok) / dsafe
        t2 = (box[:, 3 + k] - ok) / dsafe
        lo_ = torch.where(deg, -INF, torch.minimum(t1, t2))
        hi_ = torch.where(deg, INF, torch.maximum(t1, t2))
        tn = lo_ if k == 0 else torch.maximum(tn, lo_)
        tf = hi_ if k == 0 else torch.minimum(tf, hi_)
    tf = tf + (torch.abs(tf) * 2e-6 + 1e-7)
    tn = tn - (torch.abs(tn) * 2e-6 + 1e-7)
    return (tn <= tf) & (tf >= 0.0) & (pack[7, act, 0] != 0.0)


def _intersect_plain(family: int, col, o, d, eps):
    """One visit's tests in family `family` (csrc/walk_core.cuh's
    `intersect`, op for op): col(q) [na, cs, 1] is row q of the visited
    blocks, o and d the rays' rows [na, 1, RT]. Returns (t, valid)
    [na, cs, RT]."""
    ox, oy, oz = o
    dx, dy, dz = d
    if family == MT:
        v0x, v0y, v0z = col(0), col(1), col(2)
        e1x, e1y, e1z = col(3), col(4), col(5)
        e2x, e2y, e2z = col(6), col(7), col(8)
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv = 1.0 / det
        sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
        u = (sx * px + sy * py + sz * pz) * inv
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv
        t = (e2x * qx + e2y * qy + e2z * qz) * inv
        ok = torch.abs(det) >= eps
    elif family == WOOP:
        olx = ((col(0) * ox + col(1) * oy) + col(2) * oz) + col(9)
        oly = ((col(3) * ox + col(4) * oy) + col(5) * oz) + col(10)
        olz = ((col(6) * ox + col(7) * oy) + col(8) * oz) + col(11)
        dlx = (col(0) * dx + col(1) * dy) + col(2) * dz
        dly = (col(3) * dx + col(4) * dy) + col(5) * dz
        dlz = (col(6) * dx + col(7) * dy) + col(8) * dz
        flat = torch.abs(dlz) < _TINY
        rcp = 1.0 / torch.where(flat, _TINY, dlz)
        t = -olz * rcp
        u = olx + t * dlx
        v = oly + t * dly
        ok = ~flat
    else:
        nx, ny, nz, d0 = col(0), col(1), col(2), col(3)
        den = nx * dx + ny * dy + nz * dz
        if family == PMTO:
            t = d0 / den
            u = col(7) + t * (col(4) * dx + col(5) * dy + col(6) * dz)
            v = col(11) + t * (col(8) * dx + col(9) * dy + col(10) * dz)
        else:
            t = (d0 - (nx * ox + ny * oy + nz * oz)) / den
            px = ox + t * dx
            py = oy + t * dy
            pz = oz + t * dz
            u = col(4) * px + col(5) * py + col(6) * pz + col(7)
            v = col(8) * px + col(9) * py + col(10) * pz + col(11)
        ok = torch.abs(den) >= eps
    valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps)
    return t, valid


def walk_plain(rays8, ids, cnt, geo, attr, n_attrs: int, cs: int,
               eps: float, nearest: bool, t_max: float = INF,
               family: int = PMT, tmax_row=None, ray_tile: int = RAY_TILE,
               lane_bounds=None):
    """Plain version of the walk: for each list position j, gather every
    still-walking tile's j-th cluster block and intersect in `family`
    (PMT, PMTO, MT or WOOP: the TPU's `_pmt_tile`, `_pmt_o_tile`,
    `_mt_tile` or `_woop_tile_t`, op for op; a bool is PMTO or PMT).
    Nearest keeps min t, then min slot, with no tie at +inf, over t <
    t_max; occlusion keeps min t with t < t_max, or t < tmax_row [1, N]
    per ray where that is given. With lane_bounds [C, 6] a visit that no
    alive ray of the tile enters is skipped (the lane-cull pre-test).
    The tiles hold ray_tile rays (a multiple of 128; the lists one row
    per tile). Returns (t [1, N], slot or hit flag [1, N] i32, attrs
    [A, N] | None); missing lanes get t = +inf, slot 2^30, attrs 0. No
    early exit (it is exact)."""
    dev = rays8.device
    n = rays8.shape[1]
    nt = n // ray_tile
    if cnt.shape[0] != nt or ids.shape[0] != nt:
        raise ValueError(f"walk: lists for {ids.shape[0]} tiles, the pack "
                         f"holds {nt} tiles of {ray_tile}")
    family = int(family)
    rows = _FAMILY_ROWS[family]
    trips = cnt.to(torch.int64)
    best_t = torch.full((nt, ray_tile), INF, dtype=torch.float32, device=dev)
    best_s = torch.full((nt, ray_tile), _BIG_ID, dtype=torch.int32,
                        device=dev)
    sub = torch.arange(cs, dtype=torch.int32, device=dev).reshape(1, cs, 1)
    pack = rays8.reshape(8, nt, 1, ray_tile)
    limit = (None if tmax_row is None
             else tmax_row.reshape(nt, 1, ray_tile))
    trips_host = trips.tolist()
    for g0, g1 in _plain_groups(nt, cs, ray_tile):
        for j in range(max(trips_host[g0:g1], default=0)):
            act = torch.nonzero(trips[g0:g1] > j).squeeze(1) + g0
            cl = ids[act, j]
            if lane_bounds is not None:
                keep = _lane_cull_keep(pack, act, cl, lane_bounds)
                act, cl = act[keep], cl[keep]
            blk = geo[cl.long(), :rows]  # [na, rows, cs]

            def col(q):
                return blk[:, q, :, None]  # [na, cs, 1]

            t, valid = _intersect_plain(
                family, col, (pack[0, act], pack[1, act], pack[2, act]),
                (pack[4, act], pack[5, act], pack[6, act]), eps)
            valid = valid & (t < (t_max if limit is None or nearest
                                  else limit[act]))
            t = torch.where(valid, t, INF)
            tmin_v = t.amin(dim=1)  # [na, ray_tile]
            acc_t = best_t[act]
            if nearest:
                slot = cl[:, None, None] * cs + sub
                slot_v = torch.where(t == tmin_v[:, None], slot,
                                     _BIG_ID).amin(dim=1)
                acc_s = best_s[act]
                upd = (tmin_v < acc_t) | ((tmin_v == acc_t) & (tmin_v < INF)
                                          & (slot_v < acc_s))
                best_s[act] = torch.where(upd, slot_v, acc_s)
            best_t[act] = torch.minimum(acc_t, tmin_v)
    t_out = best_t.reshape(1, n)
    if not nearest:
        return t_out, (t_out < INF).to(torch.int32), None
    s_out = best_s.reshape(1, n)
    return t_out, s_out, _winner_attrs(attr, s_out, n_attrs, cs)


def _check_tmax_row(who, n, tmax_row):
    """A per-ray limit goes to a kernel as a contiguous f32 [1, N] row."""
    if tmax_row is not None and (
            tmax_row.dtype != torch.float32 or not tmax_row.is_contiguous()
            or tmax_row.shape != (1, n)):
        raise ValueError(f"{who}: tmax_row must be a contiguous f32 "
                         f"[1, {n}] row")


def _check_walk_tables(who, nt, ids, cnt, geo, attr, cs, tnear, bbox,
                       family=PMT, lane_bounds=None):
    """What the walk kernels take: f32 [C, rows, CS] tables with contiguous
    rows, at least the family's rows of geometry, the geometry table's
    blocks 16-byte aligned (the kernels stage them with 16-byte copies: CS
    a multiple of 4 up to 128), contiguous i32 ids [nt, W] with cnt [nt],
    for the early exit a contiguous tnear [nt, W] and a bbox [6], and for
    the lane cull contiguous f32 boxes [C, 6]."""
    if int(family) not in _FAMILY_ROWS or geo.shape[1] < _FAMILY_ROWS[
            int(family)]:
        raise ValueError(f"{who}: family {family} needs "
                         f"{_FAMILY_ROWS.get(int(family))} geometry rows; "
                         f"the table has {geo.shape[1]}")
    if lane_bounds is not None and (
            lane_bounds.dtype != torch.float32
            or lane_bounds.shape != (geo.shape[0], 6)
            or not lane_bounds.is_contiguous()):
        raise ValueError(f"{who}: lane_bounds must be contiguous f32 "
                         f"[{geo.shape[0]}, 6]")
    for name, tab in (("geo", geo), ("attr", attr)):
        if tab is not None and (tab.dtype != torch.float32
                                or tab.stride(2) != 1 or tab.stride(1) != cs
                                or tab.shape[2] != cs):
            raise ValueError(f"{who}: {name} table must be f32 [C, rows, CS] "
                             "with contiguous rows")
    if (cs % 4 or not 0 < cs <= _STAGE_TRIANGLES or geo.stride(0) % 4
            or geo.data_ptr() % 16):
        raise ValueError(f"{who}: the geo table's blocks must be 16-byte "
                         f"aligned, CS a multiple of 4 up to "
                         f"{_STAGE_TRIANGLES}; got CS {cs}, a block stride of "
                         f"{geo.stride(0)} floats, the table at byte "
                         f"{geo.data_ptr() % 16} of 16")
    if (ids.dim() != 2 or ids.shape[0] != nt or cnt.shape != (nt,)
            or ids.dtype != torch.int32 or not ids.is_contiguous()):
        raise ValueError(f"{who}: ids [nt, W] i32 / cnt [nt] do not match "
                         f"the {nt} tiles")
    if tnear is not None and (bbox is None or tnear.shape != ids.shape
                              or not tnear.is_contiguous()
                              or not bbox.is_contiguous()):
        raise ValueError(f"{who}: early exit needs tnear [nt, W] and "
                         "bbox [6]")


def _walk_outputs(rays8, attr, n_attrs: int, nearest: bool):
    """What a pack walk kernel writes, and the attribute table it reads:
    (t [1, N], slot or hit flag [1, N] i32, attrs [A, N] | None, table |
    None); an occlusion walk reads no attributes."""
    n, dev = rays8.shape[1], rays8.device
    attr_t = attr if nearest and n_attrs else None
    return (torch.empty((1, n), dtype=torch.float32, device=dev),
            torch.empty((1, n), dtype=torch.int32, device=dev),
            None if attr_t is None else torch.empty(
                (n_attrs, n), dtype=torch.float32, device=dev),
            attr_t)


def _merge_keys(rays8, nearest: bool):
    """Scratch for the order-free merge of a nearest walk split over blocks
    (K1/K2 and K3 segments, K4 work items): one (t, slot) key of 8 bytes
    per ray, 8-byte aligned; occlusion merges in its t output and needs
    none."""
    if not nearest:
        return None
    return torch.empty(rays8.shape[1], dtype=torch.int64, device=rays8.device)


def _no_hit(rays8):
    """(t, slot) [1, N] of rays that have hit nothing yet."""
    n, dev = rays8.shape[1], rays8.device
    return (torch.full((1, n), INF, dtype=torch.float32, device=dev),
            torch.full((1, n), _BIG_ID, dtype=torch.int32, device=dev))


@spanned("rt.walk", key="entry")
def walk(rays8, ids, cnt, geo, attr, n_attrs: int, cs: int, eps: float,
         nearest: bool, t_max: float = INF, family: int = PMT,
         tmax_row=None, tnear=None, bbox=None, ee_batch: int = 1,
         entry: str = "walk", visits=None, lane_bounds=None,
         ray_tile: int = RAY_TILE):
    """K1/K2 (csrc/walk.cu): plain version on CPU, kernel on CUDA, over
    tiles of ray_tile rays (a block of s / 4 threads walks a launch tile
    of s rays, `_split_tile`, each its tile's whole list). The
    kernel splits each tile's list into segments of `_walk_segment(cs)`
    visits, dealt to up to `_MAX_TILE_BLOCKS` blocks and merged per ray in
    any order; the result does not depend on the split, nor on the early
    exit.

    geo [C, >=rows, CS] holds each cluster's rows of the intersector
    family first (PMT: the 12 Baldwin–Weber rows; PMTO: the same
    origin-folded by `_fold_origin`, the pack's origin rows then unread;
    MT: the 9 rows v0 | e1 | e2; WOOP: `_woop_table`'s 12); attr
    [C, >=A, CS] its attribute rows (a view into a combined table is fine).
    A nearest walk accepts only t < t_max (a two-phase query's cap; +inf
    by default). tmax_row [1, N]: each ray's own occlusion limit in place
    of t_max. With tnear [nt, W] and bbox [6] (union-box min | max) a
    nearest walk votes on the front-to-back early exit at least every
    ee_batch visits, on its own hits and on those the tile's other
    segments have published. With lane_bounds [C, 6] (each cluster's box,
    min | max) a warp skips a visit none of its alive rays enters (the
    lane-cull pre-test; the plain version votes per tile). `entry` names
    the launch count ("walk", "walk_dma" or their "_both" forms; suffixed
    by `_count_key`). `visits`, an i32 [nt] CUDA tensor, receives the
    clusters each tile visited (for measuring: under the early exit they
    differ from run to run; the plain version has no early exit and
    ignores it)."""
    if _on_cpu(rays8, ids, cnt, geo, attr, tmax_row, lane_bounds):
        if COUNTERS.counting:
            _count_walk(None, cnt, ids.shape[1], ray_tile * cs)
        return walk_plain(rays8, ids, cnt, geo, attr, n_attrs, cs, eps,
                          nearest, t_max, family, tmax_row, ray_tile,
                          lane_bounds=lane_bounds)
    nt = _check_pack(rays8, ray_tile)
    early = tnear is not None and nearest
    _check_walk_tables("walk", nt, ids, cnt, geo, attr, cs,
                       tnear if early else None, bbox, family, lane_bounds)
    n = rays8.shape[1]
    _check_tmax_row("walk", n, tmax_row)
    s, k = _split_tile(ray_tile)
    if k > 1:
        sub = None if visits is None else torch.empty(
            nt * k, dtype=torch.int32, device=rays8.device)
        out = walk(rays8, _per_subtile(ids, k), _per_subtile(cnt, k), geo,
                   attr, n_attrs, cs, eps, nearest, t_max, family, tmax_row,
                   _per_subtile(tnear, k) if early else None, bbox, ee_batch,
                   entry, sub, lane_bounds, s)
        if visits is not None:
            visits.copy_(sub.reshape(nt, k).sum(dim=1))
        return out
    seg = _walk_segment(cs)
    tile_blocks = _walk_grid("walk", nt, ids.shape[1], seg, _MAX_TILE_BLOCKS)
    out_t, out_s, out_a, attr_t = _walk_outputs(rays8, attr, n_attrs, nearest)
    # Scratch of the segments' merge; the launch fills both.
    keys = _merge_keys(rays8, nearest)
    finished = torch.empty(nt, dtype=torch.int32, device=rays8.device)
    cnt32 = cnt.to(torch.int32).contiguous()
    if visits is None and COUNTERS.counting:
        visits = torch.empty(nt, dtype=torch.int32, device=rays8.device)
    lib = cuda.library()
    with torch.cuda.device(rays8.device):
        cuda.check(lib.rt_walk(
            _ptr(rays8), n, ray_tile, _ptr(tmax_row), _ptr(ids), _ptr(cnt32),
            _ptr(tnear if early else None), ids.shape[1], seg, tile_blocks,
            _ptr(bbox if early else None), _ptr(geo), geo.stride(0),
            _ptr(attr_t), attr_t.stride(0) if attr_t is not None else 0,
            n_attrs if attr_t is not None else 0, cs, float(eps), float(t_max),
            int(nearest), int(early), int(ee_batch), int(family),
            _ptr(lane_bounds), _ptr(keys), _ptr(finished), _ptr(out_t),
            _ptr(out_s), _ptr(out_a), _ptr(visits), _stream(rays8)), entry)
    _count(_count_key(entry, family, nearest and t_max < INF,
                      lane_bounds is not None, ray_tile))
    if COUNTERS.counting:
        _count_walk(visits, cnt, ids.shape[1], ray_tile * cs)
    return out_t, out_s, out_a


def walk_gstream_plain(rays8, ids, cnt, geo, attr, n_attrs: int, cs: int,
                        gsz: int, eps: float, nearest: bool,
                        t_max: float = INF, family: int = PMT,
                        tmax_row=None, ray_tile: int = RAY_TILE):
    """Plain version of K3: `walk_plain` over each group's lists and its
    slice of the table, the groups folded by (min t, then min slot) with
    slot = (g * gsz + id) * cs + lane; attributes from the final winner."""
    best_t, best_s = _no_hit(rays8)
    for g in range(ids.shape[0]):
        t_g, s_g, _ = walk_plain(rays8, ids[g], cnt[g],
                                 geo[g * gsz:(g + 1) * gsz], None, 0, cs,
                                 eps, nearest, t_max, family, tmax_row,
                                 ray_tile)
        if nearest:
            s_g = torch.where(s_g != _BIG_ID, s_g + g * gsz * cs, _BIG_ID)
            best_t, best_s = _merge_nearest(best_t, best_s, t_g, s_g)
        else:
            best_t = torch.minimum(best_t, t_g)
    if not nearest:
        return best_t, (best_t < INF).to(torch.int32), None
    return best_t, best_s, _winner_attrs(attr, best_s, n_attrs, cs)


@spanned("rt.walk", key="entry")
def walk_gstream(rays8, ids, cnt, geo, attr, n_attrs: int, cs: int, gsz: int,
                 eps: float, nearest: bool, t_max: float = INF,
                 family: int = PMT, tmax_row=None, tnear=None, bbox=None,
                 ee_batch: int = 1, visits=None, ray_tile: int = RAY_TILE):
    """K3 (csrc/gstream.cu): plain version on CPU, kernel on CUDA, over
    tiles of ray_tile rays (launched as `walk` launches them). The
    walk over a table of G groups of gsz clusters in one launch. The
    kernel splits each (group, tile) list into segments dealt to blocks
    (`_gstream_grid`); a tile's blocks over every group merge per ray in
    any order.

    ids [G, nt, W] i32 hold group-local cluster ids with cnt [G, nt] listed
    per (group, tile) — 0 on a dead tile; geo [G * gsz, >=12, CS] and attr
    [G * gsz, >=A, CS] are the whole tables, the last group padded with
    zero blocks. With tnear [G, nt, W] and bbox [G, 6] (each group's union
    box, min | max) a nearest walk votes on the early exit with each
    group's bounds, on its own hits and on those the tile's other blocks
    have published. family and t_max as `walk` takes them. Returns what
    `walk` returns, the slots global.
    `visits`, an i32 [G, nt] CUDA tensor, receives the clusters each
    (group, tile) visited."""
    if _on_cpu(rays8, ids, cnt, geo, attr, tmax_row):
        if COUNTERS.counting:
            _count_walk(None, cnt, ids.shape[-1], ray_tile * cs)
        return walk_gstream_plain(rays8, ids, cnt, geo, attr, n_attrs, cs,
                                  gsz, eps, nearest, t_max, family, tmax_row,
                                  ray_tile)
    nt = _check_pack(rays8, ray_tile)
    early = tnear is not None and nearest
    if ids.dim() != 3 or cnt.shape != ids.shape[:2]:
        raise ValueError("walk_gstream: ids [G, nt, W] / cnt [G, nt]")
    ng, _, w = ids.shape
    _check_walk_tables("walk_gstream", nt * ng, ids.reshape(ng * nt, w),
                       cnt.reshape(-1), geo, attr, cs,
                       tnear.reshape(ng * nt, w) if early else None, bbox,
                       family)
    n = rays8.shape[1]
    _check_tmax_row("walk_gstream", n, tmax_row)
    if geo.shape[0] != ng * gsz or ng * gsz * cs >= _BIG_ID or (
            early and bbox.shape != (ng, 6)):
        raise ValueError(f"walk_gstream: the table must hold {ng} groups of "
                         f"{gsz} clusters (fewer than 2^30 slots), bbox "
                         f"[{ng}, 6]")
    s, k = _split_tile(ray_tile)
    if k > 1:  # the lists repeat along the tile axis, not the group axis
        sub = None if visits is None else torch.empty(
            (ng, nt * k), dtype=torch.int32, device=rays8.device)
        out = walk_gstream(
            rays8, _per_subtile(ids, k, 1), _per_subtile(cnt, k, 1), geo,
            attr, n_attrs, cs, gsz, eps, nearest, t_max, family, tmax_row,
            _per_subtile(tnear, k, 1) if early else None, bbox, ee_batch,
            sub, s)
        if visits is not None:
            visits.copy_(sub.reshape(ng, nt, k).sum(dim=2))
        return out
    seg, tile_blocks = _gstream_grid(nt, ng, w, cs)
    out_t, out_s, out_a, attr_t = _walk_outputs(rays8, attr, n_attrs, nearest)
    # Scratch of the blocks' merge; the launch fills both.
    keys = _merge_keys(rays8, nearest)
    finished = torch.empty(nt, dtype=torch.int32, device=rays8.device)
    cnt32 = cnt.to(torch.int32).contiguous()
    if visits is None and COUNTERS.counting:
        visits = torch.empty((ng, nt), dtype=torch.int32, device=rays8.device)
    lib = cuda.library()
    with torch.cuda.device(rays8.device):
        cuda.check(lib.rt_walk_gstream(
            _ptr(rays8), n, ray_tile, _ptr(tmax_row), _ptr(ids), _ptr(cnt32),
            _ptr(tnear if early else None), w, seg, tile_blocks, ng, int(gsz),
            _ptr(bbox if early else None), _ptr(geo), geo.stride(0),
            _ptr(attr_t), attr_t.stride(0) if attr_t is not None else 0,
            n_attrs if attr_t is not None else 0, cs, float(eps), float(t_max),
            int(nearest), int(early), int(ee_batch), int(family), _ptr(keys),
            _ptr(finished), _ptr(out_t), _ptr(out_s), _ptr(out_a),
            _ptr(visits), _stream(rays8)), "walk_gstream")
    _count(_count_key("walk_gstream", family, nearest and t_max < INF,
                      ray_tile=ray_tile))
    if COUNTERS.counting:
        _count_walk(visits, cnt, w, ray_tile * cs)
    return out_t, out_s, out_a


def wq_queue_plain(cnt, width: int, u: int = WQ_U):
    """K4's work queue (csrc/wq.cu's plan launch): first [nt + 1] i32,
    first[t] the work items of the tiles before t, first[nt] all of them;
    tile t holds ceil(min(cnt[t], width) / u) items of u visits."""
    items = (torch.clamp(cnt.to(torch.int64), 0, width) + u - 1) // u
    return torch.cat([items.new_zeros(1), torch.cumsum(items, 0)]).to(
        torch.int32)


def walk_wq_plain(rays8, ids, cnt, geo, attr, n_attrs: int, cs: int,
                  eps: float, nearest: bool, t_max: float = INF,
                  family: int = PMT, tmax_row=None, u: int = WQ_U,
                  ray_tile: int = RAY_TILE, lane_bounds=None):
    """Plain version of K4: the lists cut into work items of `u` visits,
    each item walked on its own (`walk_plain`) and the items of a tile
    folded by (min t, then min slot) — in any order the same. A tile with
    no visits reads miss / not occluded. lane_bounds is ignored: the
    kernel's cull skips only clusters no alive ray of a warp enters, which
    changes no alive lane's result."""
    listed = torch.clamp_max(cnt.to(torch.int64), ids.shape[1])
    best_t, best_s = _no_hit(rays8)
    for j0 in range(0, int(listed.max()) if listed.numel() else 0, u):
        t_k, s_k, _ = walk_plain(rays8, ids[:, j0:j0 + u],
                                 torch.clamp(listed - j0, 0, u), geo, None, 0,
                                 cs, eps, nearest, t_max, family, tmax_row,
                                 ray_tile)
        if nearest:
            best_t, best_s = _merge_nearest(best_t, best_s, t_k, s_k)
        else:
            best_t = torch.minimum(best_t, t_k)
    if not nearest:
        return best_t, (best_t < INF).to(torch.int32), None
    return best_t, best_s, _winner_attrs(attr, best_s, n_attrs, cs)


@spanned("rt.walk", key="entry")
def walk_wq(rays8, ids, cnt, geo, attr, n_attrs: int, cs: int, eps: float,
            nearest: bool, t_max: float = INF, family: int = PMT,
            tmax_row=None, u: int = WQ_U, ray_tile: int = RAY_TILE,
            lane_bounds=None, queue=None):
    """K4 (csrc/wq.cu): plain version on CPU, kernel on CUDA, over tiles of
    ray_tile rays. The walk with `u` visits of one tile as the unit of
    work: a persistent grid's warps take the real items
    (`wq_queue_plain`) for one 128-lane warp of a tile at a time,
    `WQ_RUN` consecutive ones per take, and merge once per take through
    one atomic minimum of (t, slot). A warp skips a cluster none of its
    alive rays enters by the boxes lane_bounds [C, 6] (min | max), which
    the kernel needs and the plain version ignores. Tables, lists and
    results as `walk` (defined on alive lanes); there is no early exit.
    The families are the TPU K4's: PMT, PMTO and MT. `queue`, an i32
    [nt + 2] CUDA tensor, receives the work queue and the count of units
    taken (for measuring): at a tile of k launch tiles (`_split_tile`) the
    launch's, i32 [nt * k + 2], each launch tile's items counted apart."""
    if int(family) == WOOP:
        raise ValueError("walk_wq: the work-queue walk takes the pmt, pmto "
                         "and mt families")
    if _on_cpu(rays8, ids, cnt, geo, attr, tmax_row, lane_bounds):
        if COUNTERS.counting:
            _count_walk(None, cnt, ids.shape[1], ray_tile * cs)
        return walk_wq_plain(rays8, ids, cnt, geo, attr, n_attrs, cs, eps,
                             nearest, t_max, family, tmax_row, u, ray_tile)
    nt = _check_pack(rays8, ray_tile)
    _check_walk_tables("walk_wq", nt, ids, cnt, geo, attr, cs, None, None,
                       family, lane_bounds)
    if lane_bounds is None:
        raise ValueError("walk_wq: the kernel culls by the clusters' boxes: "
                         "give lane_bounds [C, 6]")
    n = rays8.shape[1]
    _check_tmax_row("walk_wq", n, tmax_row)
    s, k = _split_tile(ray_tile)
    if k > 1:
        return walk_wq(rays8, _per_subtile(ids, k), _per_subtile(cnt, k),
                       geo, attr, n_attrs, cs, eps, nearest, t_max, family,
                       tmax_row, u, s, lane_bounds, queue)
    units = nt * ray_tile // 128 * -(-ids.shape[1] // int(u))
    if units > 2 ** 30:
        raise ValueError(f"walk_wq: {units} work units of 128 lanes; the "
                         f"queue takes at most 2**30")
    if queue is None:
        queue = torch.empty(nt + 2, dtype=torch.int32, device=rays8.device)
    elif (queue.dtype != torch.int32 or queue.shape != (nt + 2,)
          or not queue.is_contiguous()):
        raise ValueError(f"walk_wq: queue must be a contiguous i32 "
                         f"[{nt + 2}]")
    out_t, out_s, out_a, attr_t = _walk_outputs(rays8, attr, n_attrs, nearest)
    keys = _merge_keys(rays8, nearest)  # the launch fills them
    cnt32 = cnt.to(torch.int32).contiguous()
    lib = cuda.library()
    with torch.cuda.device(rays8.device):
        cuda.check(lib.rt_walk_wq(
            _ptr(rays8), n, ray_tile, _ptr(tmax_row), _ptr(ids), _ptr(cnt32),
            ids.shape[1], int(u), _ptr(geo), geo.stride(0), _ptr(attr_t),
            attr_t.stride(0) if attr_t is not None else 0,
            n_attrs if attr_t is not None else 0, cs, float(eps), float(t_max),
            int(nearest), int(family), _ptr(lane_bounds), _ptr(queue),
            _ptr(keys), _ptr(out_t), _ptr(out_s), _ptr(out_a),
            _stream(rays8)), "walk_wq")
    _count(_count_key("walk_wq", family, nearest and t_max < INF,
                      ray_tile=ray_tile))
    if COUNTERS.counting:
        _count_walk(None, cnt, ids.shape[1], ray_tile * cs)
    return out_t, out_s, out_a


@spanned("rt.tables")
def _union_box(cluster_min, cluster_max) -> torch.Tensor:
    return torch.cat([cluster_min.amin(dim=0), cluster_max.amax(dim=0)])


def _early(nearest: bool, n_clusters: int, early_exit, tmax_row=None) -> bool:
    """Early exit for nearest queries: forced by the caller, else above
    `_EARLY_EXIT_MIN_CLUSTERS` walked clusters (the TPU package's rule).
    Occlusion and per-ray-limit queries never exit early."""
    return nearest and tmax_row is None and (
        n_clusters > _EARLY_EXIT_MIN_CLUSTERS if early_exit is None
        else bool(early_exit))


def _group_clusters(accel: ClusterAccel, n_attrs: int) -> int:
    """Most clusters one walk launch takes as a whole: as many as put
    their 12 geometry and n_attrs attribute rows of cluster_size floats
    inside the group budget (`accel.packets._GROUP_BLOCK_BUDGET_BYTES`), and
    at least 256. A bigger table is walked in groups of this size (for
    every family: mt's 9 rows leave a group a little under budget)."""
    per_cluster = 4 * (12 + n_attrs) * accel.cluster_size
    return max(256, packets._GROUP_BLOCK_BUDGET_BYTES // per_cluster)


ATTR_KINDS = ("shade", "grad", "both")


def _attr_planes(accel: ClusterAccel, attr_kind: str):
    """The attribute tables [C, ., CS] a nearest walk carries, in order:
    the shading planes ("shade"), the backward's planes `grad_blocks`
    ("grad"), or both, the shading planes first ("both": what a
    differentiated query walks, so that its backward needs no second
    walk)."""
    if attr_kind == "shade":
        return [accel.attr_blocks]
    if accel.grad_blocks is None:
        raise ValueError("this accel has no grad_blocks: build it with "
                         "build_cluster_accel, or hand accel_from_numpy "
                         "the JAX package's grad_blocks and rest_grad")
    if attr_kind == "grad":
        return [accel.grad_blocks]
    if attr_kind == "both":
        return [accel.attr_blocks, accel.grad_blocks]
    raise ValueError(f"attr_kind {attr_kind!r}: one of {ATTR_KINDS}")


def _attr_table(accel: ClusterAccel, attr_kind: str) -> torch.Tensor:
    """`_attr_planes` as one [C, A, CS] table."""
    planes = _attr_planes(accel, attr_kind)
    return planes[0] if len(planes) == 1 else torch.cat(planes, dim=1)


def _n_attrs(accel: ClusterAccel, attr_kind: str) -> int:
    """A = 9 (4 in objid mode) shading planes, 11 backward planes, or both
    (20, or 15)."""
    return sum(t.shape[1] for t in _attr_planes(accel, attr_kind))


def _entry(name: str, attr_kind: str) -> str:
    """The launch count of a pack walk: "<name>_both" when it carries the
    backward's planes beside the shading planes."""
    return name + "_both" if attr_kind == "both" else name


def _check_variant(accel: ClusterAccel, variant: str) -> None:
    """Raise ValueError unless `variant` is one of VARIANTS and its table
    was built (traverse.py:2836-2838)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    table = {"pmt": accel.pmt_blocks, "mt": accel.tri_blocks,
             "pmtt": accel.pmt_t_blocks, "woop": accel.woop_blocks}[variant]
    if table is None:
        raise ValueError(
            f"variant {variant!r} blocks were not built for this accel "
            "(build_cluster_accel(..., variants=...))")


def _family_of(variant: str, shared_origin) -> int:
    """The kernels' family for a query's variant: "pmt" with a shared
    origin is PMTO, as in the JAX package; "pmtt" is PMT (the same
    arithmetic, the card's layout)."""
    if variant in ("pmt", "pmtt"):
        return PMTO if variant == "pmt" and shared_origin is not None else PMT
    return MT if variant == "mt" else WOOP


def _geo_table(accel: ClusterAccel, shared_origin, clusters=slice(None),
               variant: str = "pmt"):
    """(geometry table, family) of a run of clusters (default: all) for a
    query's variant (`_family_of`): the Baldwin–Weber blocks,
    origin-folded for PMTO when every ray leaves `shared_origin` [3]; the
    v0 | e1 | e2 rows for MT; `_woop_table` for WOOP."""
    family = _family_of(variant, shared_origin)
    if family == MT:
        return accel.tri_blocks[clusters], family
    if family == WOOP:
        return _woop_table(accel.woop_blocks)[clusters], family
    blocks = accel.pmt_blocks[clusters]
    if family == PMTO:
        return _fold_origin(blocks, shared_origin), family
    return blocks, family


@spanned("rt.tables")
def _lane_bounds(cluster_min, cluster_max) -> torch.Tensor:
    """The lane-cull pre-test's boxes [C, 6]: min | max."""
    return torch.cat([cluster_min, cluster_max], dim=1).contiguous()


def _cap_of(nearest: bool, t_max) -> Optional[float]:
    """A nearest query's cap (traverse.py:2649): its t_max when finite."""
    return float(t_max) if nearest and t_max < INF else None


def _groups_walk_args(accel: ClusterAccel, rp, eps, nearest, t_max,
                      n_attrs, early_exit=None, shared_origin=None,
                      tmax_row=None, clusters=None, attr_kind="shade",
                      variant="pmt", lane_cull=False,
                      ray_tile: int = RAY_TILE):
    """The `_walk_groups` launch (K1): frustum lists over the separate
    geometry table of the variant (`_geo_table`; with `shared_origin` [3]
    and "pmt", the origin-folded table and the pmto intersector) and
    attribute table (`_attr_table(accel, attr_kind)`). A nearest query
    with a finite t_max is capped there: the lists are clipped to it.
    `clusters` = (lo, hi) walks only that run of the table (a group loop),
    with cluster ids local to it. With `lane_cull` the launch takes the
    run's boxes for the lane-cull pre-test. The tiles hold ray_tile rays.
    Returns (args, kw): `walk(*args, **kw)` is the launch and
    `walk_plain(*args, **kw')` its plain version (kw' = kw's ray_tile and
    lane_bounds, if any)."""
    cs = accel.cluster_size
    lo, hi = clusters or (0, accel.num_clusters)
    cmin, cmax = accel.cluster_min[lo:hi], accel.cluster_max[lo:hi]
    early = _early(nearest, hi - lo, early_exit, tmax_row)
    ids, tnear, cnt = _tile_visit_lists_soa(rp, cmin, cmax,
                                            _cap_of(nearest, t_max), ray_tile)
    geo, family = _geo_table(accel, shared_origin, slice(lo, hi), variant)
    args = (rp, ids, cnt, geo,
            _attr_table(accel, attr_kind)[lo:hi] if n_attrs else None,
            n_attrs, cs, eps, nearest, t_max, family, tmax_row)
    kw = dict(tnear=tnear if early else None,
              bbox=_union_box(cmin, cmax) if early else None,
              ee_batch=_ee_batch_for(cs), entry=_entry("walk", attr_kind),
              ray_tile=ray_tile)
    if lane_cull:
        kw["lane_bounds"] = _lane_bounds(cmin, cmax)
    return args, kw


def _gstream_walk_args(accel: ClusterAccel, rp, eps, nearest, t_max,
                       n_attrs, early_exit=None, shared_origin=None,
                       tmax_row=None, attr_kind="shade", variant="pmt",
                       ray_tile: int = RAY_TILE):
    """The streamed-groups launch (K3): one extents pass (K6), then every
    group's frustum lists from it in one launch (`lists_from_extents`:
    the interval test against each group's run of boxes, ids local to the
    group, sorted within the (group, tile) row, no entry on a dead tile),
    and the groups' union boxes for the early exit. The last group is padded with
    inverted boxes and zero blocks (never accepted); the interval test
    would take an inverted box for one that covers everything, so the
    padded clusters are struck from the lists by their index. The
    variant's table, cap and tile as in `_groups_walk_args`.
    Returns (args, kw): `walk_gstream(*args, **kw)` is the launch and
    `walk_gstream_plain(*args, ray_tile=kw["ray_tile"])` its plain
    version."""
    cs = accel.cluster_size
    geo, family = _geo_table(accel, shared_origin, variant=variant)
    gsz = _group_clusters(accel, n_attrs)
    ng = -(-accel.num_clusters // gsz)
    pad_c = ng * gsz - accel.num_clusters
    cmin, cmax = accel.cluster_min, accel.cluster_max
    attr = _attr_table(accel, attr_kind) if n_attrs else None

    def padded(tab, fill):
        if tab is None or not pad_c:
            return tab
        return torch.cat([tab, tab.new_full((pad_c,) + tab.shape[1:], fill)])

    cmin, cmax = padded(cmin, _BIG), padded(cmax, -_BIG)
    geo, attr = padded(geo, 0.0), padded(attr, 0.0)
    lo, hi = tile_extents(rp, ray_tile)
    early = _early(nearest, gsz, early_exit, tmax_row)
    # Every group's lists in one launch: each (group, tile) row sorted on
    # its own, the padded clusters struck by the mask.
    real = (torch.arange(ng * gsz, device=rp.device) < accel.num_clusters
            if pad_c else None)
    ids, tnear, cnt = lists_from_extents(
        lo[:, 0:3], hi[:, 0:3], lo[:, 4:7], hi[:, 4:7], cmin, cmax,
        _cap_of(nearest, t_max), mask=real, groups=ng, alive=hi[:, 7])
    bbox = (torch.cat([cmin.reshape(ng, gsz, 3).amin(dim=1),
                       cmax.reshape(ng, gsz, 3).amax(dim=1)], dim=1)
            if early else None)
    args = (rp, ids, cnt, geo, attr, n_attrs, cs, gsz, eps, nearest, t_max,
            family, tmax_row)
    kw = dict(tnear=tnear if early else None, bbox=bbox,
              ee_batch=_ee_batch_for(cs), ray_tile=ray_tile)
    return args, kw


@spanned("rt.lists")
def _refined_lists(accel: ClusterAccel, rp, t_cap=None,
                   ray_tile: int = RAY_TILE):
    """Frustum lists of the tiles of ray_tile rays cut down to the clusters
    some alive ray of the tile enters (K5), still front to back: the dense
    form (one launch with the extents, `refine_dense_extents`) ANDs the
    entered bits into the interval test's flags, the gathered form (more
    than `_REFINE_DENSE_MAX_C` clusters) re-tests the listed candidates and
    compacts again. With t_cap, the frustum test and K5 clip at it."""
    cmin, cmax = accel.cluster_min, accel.cluster_max
    if accel.num_clusters <= _REFINE_DENSE_MAX_C:
        lo, hi, entered = refine_dense_extents(rp, cmin, cmax, t_cap,
                                               ray_tile)
        return lists_from_extents(lo[:, 0:3], hi[:, 0:3], lo[:, 4:7],
                                  hi[:, 4:7], cmin, cmax, t_cap,
                                  mask=entered)
    ids, tnear, cnt = _narrow_lists(*_tile_visit_lists_soa(
        rp, cmin, cmax, t_cap, ray_tile))
    keep = refine_lists(rp, ids, cnt, cmin, cmax, t_cap, ray_tile)
    return _compact_lists(keep, tnear, ids)


@spanned("rt.tables")
def _combined_table(geo, accel: ClusterAccel, n_attrs, attr_kind="shade"):
    """(table, attribute view): the [C, rows + A, CS] table whose attribute
    rows (`_attr_table`) follow the geometry rows (12, mt's 9), as the
    `_walk_dma` entries take it."""
    if not n_attrs:
        return geo, None
    blocks = torch.cat([geo] + _attr_planes(accel, attr_kind), dim=1)
    return blocks, blocks[:, geo.shape[1]:]


def _dma_walk_args(accel: ClusterAccel, rp, eps, nearest, t_max, n_attrs,
                   early_exit=None, shared_origin=None, tmax_row=None,
                   attr_kind="shade", variant="pmt",
                   ray_tile: int = RAY_TILE):
    """The `_walk_dma` launch (K2): refined lists (K5) over the combined
    [C, rows + A, CS] table of the variant ("pmt" or "mt"). Returns
    (args, kw) as `_groups_walk_args` does."""
    cs = accel.cluster_size
    geo, family = _geo_table(accel, shared_origin, variant=variant)
    blocks, attr = _combined_table(geo, accel, n_attrs, attr_kind)
    ids, tnear, cnt = _refined_lists(accel, rp, _cap_of(nearest, t_max),
                                     ray_tile)
    early = _early(nearest, accel.num_clusters, early_exit, tmax_row)
    args = (rp, ids, cnt, blocks, attr, n_attrs, cs, eps, nearest, t_max,
            family, tmax_row)
    kw = dict(tnear=tnear if early else None,
              bbox=(_union_box(accel.cluster_min, accel.cluster_max)
                    if early else None),
              ee_batch=_dma_ee_batch(cs),
              entry=_entry("walk_dma", attr_kind), ray_tile=ray_tile)
    return args, kw


def _wq_walk_args(accel: ClusterAccel, rp, eps, nearest, t_max, n_attrs,
                  shared_origin=None, tmax_row=None, attr_kind="shade",
                  variant="pmt", ray_tile: int = RAY_TILE):
    """The work-queue launch (K4): refined lists (K5, either form: both
    give the same walk) over the combined [C, rows + A, CS] table of the
    variant ("pmt" or "mt"), tiles of ray_tile rays, with the clusters'
    boxes for the per-warp cull (as `_groups_walk_args` passes them to the
    lane cull). Returns (args, kw): `walk_wq(*args, **kw)` is the launch
    and `walk_wq_plain(*args, **kw)` its plain version.

    The TPU package cuts its lists to a fixed width and covers the tiles
    that overflow it with a second, ordinary launch; the lists here are
    never cut, so K4 walks every listed visit and that residual launch has
    no counterpart."""
    geo, family = _geo_table(accel, shared_origin, variant=variant)
    blocks, attr = _combined_table(geo, accel, n_attrs, attr_kind)
    ids, _, cnt = _refined_lists(accel, rp, _cap_of(nearest, t_max),
                                 ray_tile)
    args = (rp, ids, cnt, blocks, attr, n_attrs, accel.cluster_size, eps,
            nearest, t_max, family, tmax_row)
    return args, dict(u=WQ_U, ray_tile=ray_tile,
                      lane_bounds=_lane_bounds(accel.cluster_min,
                                               accel.cluster_max))


def _walk_groups(accel: ClusterAccel, rp, eps, nearest, t_max, n_attrs,
                 early_exit=None, wq=False, shared_origin=None,
                 tmax_row=None, attr_kind="shade", variant="pmt",
                 lane_cull=False, ray_tile: int = RAY_TILE):
    """One walk over the cluster set: (t [1, rp], slot or hit flag [1, rp],
    attrs | None). tmax_row: an optional [1, rp] per-ray limit of an
    occlusion query. attr_kind: which attribute planes a nearest walk
    carries (`_attr_table`), n_attrs of them. variant: the intersector
    family's name (VARIANTS; its table must have been built). A nearest
    query with a finite t_max accepts only hits before it, its lists
    clipped there (the first phase of a capped query).

    `wq` with variant "pmt" or "mt" takes the `_walk_dma` entry (K2) for
    a 128-multiple cluster size (`_WQ_IMPL == "dma"`), or the work-queue
    walk (K4) for a table inside the group budget (`_WQ_IMPL == "grid"`);
    whatever they do not take falls through, as in the JAX package. A
    table inside the group budget is one K1 launch, with the lane-cull
    pre-test where `lane_cull`; a bigger one is walked in groups by K3
    (no lane cull, as the TPU's streamed walk). Every launch culls in
    tiles of ray_tile rays."""
    _check_variant(accel, variant)
    query = dict(shared_origin=shared_origin, tmax_row=tmax_row,
                 attr_kind=attr_kind, variant=variant,
                 ray_tile=check_query_tile(ray_tile))
    gsz = _group_clusters(accel, n_attrs)
    if wq and variant in ("pmt", "mt"):
        if _WQ_IMPL == "dma" and accel.cluster_size % 128 == 0:
            args, kw = _dma_walk_args(accel, rp, eps, nearest, t_max,
                                      n_attrs, early_exit=early_exit,
                                      **query)
            return walk(*args, **kw)
        if _WQ_IMPL == "grid" and accel.num_clusters <= gsz:
            args, kw = _wq_walk_args(accel, rp, eps, nearest, t_max,
                                     n_attrs, **query)
            return walk_wq(*args, **kw)
    query["early_exit"] = early_exit
    if accel.num_clusters <= gsz:
        args, kw = _groups_walk_args(accel, rp, eps, nearest, t_max, n_attrs,
                                     lane_cull=lane_cull, **query)
        return walk(*args, **kw)
    return _walk_over_budget(accel, rp, eps, nearest, t_max, n_attrs,
                             **query)


def _walk_over_budget(accel: ClusterAccel, rp, eps, nearest, t_max, n_attrs,
                      early_exit=None, shared_origin=None, tmax_row=None,
                      attr_kind="shade", variant="pmt",
                      ray_tile: int = RAY_TILE):
    """`_walk_groups` for a table above the group budget: the
    streamed-groups walk (K3)."""
    args, kw = _gstream_walk_args(accel, rp, eps, nearest, t_max, n_attrs,
                                  early_exit=early_exit,
                                  shared_origin=shared_origin,
                                  tmax_row=tmax_row, attr_kind=attr_kind,
                                  variant=variant, ray_tile=ray_tile)
    return walk_gstream(*args, **kw)


# ---------------------------------------------------------------------------
# Rest set: the triangles of objects too small to fill a cluster (the ground
# plane's two in the default scene), tested against every ray of a query and
# folded into the walk's results. On CUDA tensors one launch of csrc/rest.cu
# (`_rest_launch`) does the merge in place; the plain versions below are the
# CPU path and the kernel's yardstick.
# ---------------------------------------------------------------------------


def _rest_t_rows(o, d, rb, eps, t_limit=None):
    """Möller–Trumbore of every ray against the rest set: o/d tuples of
    [1, N] rows, rb [Rr, 9] (v0 | e1 | e2). Returns t [Rr, N]."""
    ox, oy, oz = o
    dx, dy, dz = d

    def col(k):
        return rb[:, k:k + 1]

    v0x, v0y, v0z = col(0), col(1), col(2)
    e1x, e1y, e1z = col(3), col(4), col(5)
    e2x, e2y, e2z = col(6), col(7), col(8)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok_det = torch.abs(det) >= eps
    inv = 1.0 / torch.where(ok_det, det, 1.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = (sx * px + sy * py + sz * pz) * inv
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    valid = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps)
    if t_limit is not None:
        valid = valid & (t < t_limit)
    return torch.where(valid, t, INF)


def _rows(rays8):
    return (tuple(rays8[k:k + 1] for k in (0, 1, 2)),
            tuple(rays8[k:k + 1] for k in (4, 5, 6)))


def _rest_tables(accel: ClusterAccel, attr_kind: str) -> list:
    """The rest set's rows [Rr, .] of `_attr_planes`' tables, in order."""
    if attr_kind == "shade":
        return [accel.rest_attrs]
    if attr_kind == "grad":
        return [accel.rest_grad]
    return [accel.rest_attrs, accel.rest_grad]


def _rest_table(accel: ClusterAccel, attr_kind: str) -> torch.Tensor:
    """`_rest_tables` as one [Rr, A] table."""
    tables = _rest_tables(accel, attr_kind)
    return tables[0] if len(tables) == 1 else torch.cat(tables, dim=1)


def _merge_rest_nearest_rows(accel, o, d, t, slot, attrs, eps, n_attrs,
                             attr_kind="shade"):
    """Plain version of the nearest merge, on tuples of [1, N] rows (camera
    mode's directions are derived, never packed): ties keep the walk's
    hit, and the lowest rest index wins among the rest. A winning rest
    triangle brings its rows of the attr_kind tables (`rest_attrs`,
    `rest_grad` or both). Returns new (t, slot, attrs)."""
    rb = accel.rest_blocks
    rr = rb.shape[0]
    t_r = _rest_t_rows(o, d, rb, eps)
    tmin = t_r.amin(dim=0, keepdim=True)
    iota = torch.arange(rr, dtype=torch.int32, device=t.device)[:, None]
    jarg = torch.where(t_r == tmin, iota, rr).amin(dim=0, keepdim=True)
    better = tmin < t
    t = torch.minimum(t, tmin)
    slot = torch.where(better, accel.order.shape[0] + jarg, slot)
    if n_attrs:
        tbl = _rest_table(accel, attr_kind)
        row = torch.zeros((n_attrs, t.shape[1]), dtype=t.dtype,
                          device=t.device)
        for j in range(rr):
            row = torch.where(jarg == j, tbl[j][:, None], row)
        attrs = torch.where(better, row, attrs)
    return t, slot, attrs


def _merge_rest_occlusion(accel, rays8, occ, eps, t_max, tmax_row=None):
    """Plain version of the occlusion merge: occ [N] bool OR a rest hit
    under the scalar t_max or the per-ray limits tmax_row [1, N]. Returns
    a new occ."""
    if accel.rest_blocks is None:
        return occ
    o, d = _rows(rays8)
    if tmax_row is not None:
        t_lim = tmax_row
    else:
        t_lim = t_max if t_max != INF else None
    t_r = _rest_t_rows(o, d, accel.rest_blocks, eps, t_limit=t_lim)
    return occ | torch.isfinite(t_r).any(dim=0)


def _rest_check(who: str, x: Optional[torch.Tensor], dtype, shape) -> None:
    if x is not None and (x.dtype != dtype or tuple(x.shape) != shape
                          or not x.is_contiguous()):
        raise ValueError(f"rest_merge: {who} must be contiguous {dtype} "
                         f"{list(shape)}, not {x.dtype} {list(x.shape)}"
                         f"{'' if x.is_contiguous() else ' (strided)'}")


def _rest_launch(accel: ClusterAccel, eps: float, n: int, *, rays8=None,
                 cam: Optional[Camera] = None, offs=None, tile_base: int = 0,
                 t=None, slot=None, attrs=None, attr_kind: str = "shade",
                 occ=None, t_max: float = INF, tmax_row=None) -> None:
    """One launch of csrc/rest.cu over n rays, updating the walk's fresh
    outputs in place: the nearest merge into t, slot [1, n] (and attrs
    [A, n] from the attr_kind tables), or the occlusion merge into occ
    [n] bool under t_max or tmax_row [1, n]. Rays: the pack rays8 [8, n],
    or camera mode's (offs, cam, tile_base). Raises ValueError on a
    tensor of another dtype, shape or layout."""
    rb = accel.rest_blocks
    tables = _rest_tables(accel, attr_kind) if attrs is not None else []
    _rest_check("rest_blocks", rb, torch.float32, (rb.shape[0], 9))
    _rest_check("rays8", rays8, torch.float32, (8, n))
    _rest_check("offs", offs, torch.float32,
                None if cam is None else (cam.spp, 2))
    _rest_check("t", t, torch.float32, (1, n))
    _rest_check("slot", slot, torch.int32, (1, n))
    _rest_check("attrs", attrs, torch.float32,
                (sum(tb.shape[1] for tb in tables), n))
    for tb in tables:
        _rest_check("a rest attribute table", tb, torch.float32,
                    (rb.shape[0], tb.shape[1]))
    _rest_check("occ", occ, torch.bool, (n,))
    _rest_check("tmax_row", tmax_row, torch.float32, (1, n))
    tbl0, tbl1 = (tables + [None, None])[:2]
    w, h, spp, bh, bw, aspect, scale = (
        (0, 0, 0, 0, 0, 0.0, 0.0) if cam is None else
        (cam.width, cam.height, cam.spp, cam.bh, cam.bw, cam.aspect,
         cam.scale))
    lib = cuda.library()
    with torch.cuda.device(rb.device):
        cuda.check(lib.rt_rest_merge(
            _ptr(rays8), n, _ptr(offs), int(tile_base), w, h, spp, bh, bw,
            float(aspect), float(scale), _ptr(rb), rb.shape[0], _ptr(tbl0),
            0 if tbl0 is None else tbl0.shape[1], _ptr(tbl1),
            0 if tbl1 is None else tbl1.shape[1], accel.order.shape[0],
            float(eps), int(occ is not None), float(t_max), _ptr(tmax_row),
            _ptr(t), _ptr(slot), _ptr(attrs), _ptr(occ), _stream(rb)),
            "rest_merge")
    _count("rest_merge")


@spanned("rt.merge")
def _merge_rest_nearest(accel, rays8, t, slot, attrs, eps, n_attrs,
                        attr_kind="shade"):
    """Fold the rest set into a pack walk's nearest results (t, slot [1, N],
    attrs [A, N] | None): plain version on CPU (returns new tensors),
    kernel on CUDA (updates the walk's outputs in place and returns
    them)."""
    if accel.rest_blocks is None:
        return t, slot, attrs
    if _on_cpu(rays8, t, accel.rest_blocks):
        o, d = _rows(rays8)
        return _merge_rest_nearest_rows(accel, o, d, t, slot, attrs, eps,
                                        n_attrs, attr_kind)
    _rest_launch(accel, eps, t.shape[1], rays8=rays8, t=t, slot=slot,
                 attrs=attrs if n_attrs else None, attr_kind=attr_kind)
    return t, slot, attrs


@spanned("rt.merge")
def _merge_rest_camera(accel, offs, cam: Camera, tile_base: int, t, slot,
                       attrs, eps, n_attrs):
    """`_merge_rest_nearest` for camera mode's rays (origin 0, directions
    of frame blocks from tile_base on, `_camera_dir_rows`), shading
    planes."""
    if accel.rest_blocks is None:
        return t, slot, attrs
    n = t.shape[1]
    if _on_cpu(offs, t, accel.rest_blocks):
        d_rows = _camera_dir_rows(n, offs, cam, tile_base * cam.ray_tile)
        zero = torch.zeros_like(d_rows[0])
        return _merge_rest_nearest_rows(accel, (zero, zero, zero), d_rows, t,
                                        slot, attrs, eps, n_attrs)
    _rest_launch(accel, eps, n, cam=cam, offs=offs, tile_base=tile_base,
                 t=t, slot=slot, attrs=attrs if n_attrs else None)
    return t, slot, attrs


@spanned("rt.merge")
def _merge_rest_any_hit(accel, rays8, occ, eps, t_max, tmax_row=None):
    """Fold the rest set into an occlusion result occ [N] bool, under the
    scalar t_max or the per-ray limits tmax_row [1, N]: plain version on
    CPU (`_merge_rest_occlusion`, a new tensor), kernel on CUDA (occ
    updated in place and returned)."""
    if accel.rest_blocks is None:
        return occ
    if _on_cpu(rays8, occ, accel.rest_blocks):
        return _merge_rest_occlusion(accel, rays8, occ, eps, t_max, tmax_row)
    _rest_launch(accel, eps, occ.shape[0], rays8=rays8, occ=occ,
                 t_max=t_max, tmax_row=tmax_row)
    return occ


# ---------------------------------------------------------------------------
# Public queries
# ---------------------------------------------------------------------------


@spanned("rt.pack")
def rays_to_soa(o: torch.Tensor, d: torch.Tensor, alive=None) -> torch.Tensor:
    """[N, 3] origins/directions -> the SoA pack [8, N]
    (rows ox oy oz 1 dx dy dz ALIVE)."""
    n = o.shape[0]
    one = torch.ones((1, n), dtype=o.dtype, device=o.device)
    row7 = one if alive is None else alive.to(o.dtype)[None]
    return torch.cat([o.T, one, d.T, row7], dim=0)


@spanned("rt.pack")
def _pad_rays_soa(rays8, ray_tile: Optional[int] = RAY_TILE):
    """Pad to whole tiles of `ray_tile` (`check_query_tile`) and of
    RAY_TILE with finite, dead lanes: (pack, rays given)."""
    n = rays8.shape[1]
    pad = (-n) % math.lcm(check_query_tile(ray_tile), RAY_TILE)
    if pad:
        col = torch.tensor([0, 0, 0, 1, 0, 0, 1, 0], dtype=rays8.dtype,
                           device=rays8.device)[:, None]
        rays8 = torch.cat([rays8, col.expand(8, pad)], dim=1)
    return rays8.contiguous(), n


def nearest_hit_soa(accel: ClusterAccel, rays8: torch.Tensor,
                    eps: float = 1e-8, shared_origin=None,
                    variant: str = "pmt", ray_tile: int = RAY_TILE
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest hit over the pack without attributes: (t [N], tri [N]
    original triangle ids, 0 on miss). shared_origin: a [3] origin that
    EVERY ray of the pack leaves (the caller asserts it); with "pmt" it
    selects the origin-folded intersector, whose results can differ from
    the default one's only at acceptance boundaries, within one f32
    rounding. variant: the intersector family (VARIANTS), whose table must
    have been built. ray_tile: the culling tile (any positive multiple of
    128, `check_query_tile`; no result depends on it)."""
    rp, r = _pad_rays_soa(rays8, ray_tile)
    t, s, _ = _walk_groups(accel, rp, eps, True, INF, 0,
                           shared_origin=shared_origin, variant=variant,
                           ray_tile=ray_tile)
    t, s, _ = _merge_rest_nearest(accel, rp, t, s, None, eps, 0)
    t, s = t[0, :r], s[0, :r]
    hit = torch.isfinite(t)
    tri = accel.order_ext[torch.where(hit, s, 0).long()]
    return t, torch.where(hit, tri, 0)


def nearest_hit_attrs_soa(accel: ClusterAccel, rays8: torch.Tensor,
                          eps: float = 1e-8, early_exit: Optional[bool] = None,
                          wq: bool = False, shared_origin=None,
                          attr_kind: str = "shade", variant: str = "pmt",
                          t_cap: Optional[float] = None,
                          lane_cull: bool = False, ray_tile: int = RAY_TILE
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest hit over the pack, with the winner's attribute planes.
    Returns (t [N], slot [N] packed slot ids, attrs [A, N]); attrs are 0 on
    miss lanes. shared_origin and variant as in `nearest_hit_soa`.
    attr_kind: the shading planes (A = 9, or 4 in objid mode), the
    backward's 11 planes ("grad") or both, the shading planes first (A =
    20, or 15); t and the slots do not depend on it. lane_cull: the K1
    walk's lane-cull pre-test, ray_tile: the culling tile of the query
    (`check_query_tile`); no result depends on either.

    t_cap: the two-phase query (traverse.py:3184-3238). Phase 1 walks with
    every frustum, refinement and intersection cut at t_cap, and merges the
    rest set over the full range; a ray whose nearest hit lies before the
    cap is done. Phase 2 walks the others uncapped (the done rays dead),
    and the two merge elementwise. The result is the uncapped query's."""
    rp, r = _pad_rays_soa(rays8, ray_tile)
    n_attrs = _n_attrs(accel, attr_kind)
    walk_kw = dict(early_exit=early_exit, wq=wq, shared_origin=shared_origin,
                   attr_kind=attr_kind, variant=variant, lane_cull=lane_cull,
                   ray_tile=ray_tile)
    t1, s1, a1 = _walk_groups(accel, rp, eps, True,
                              INF if t_cap is None else float(t_cap),
                              n_attrs, **walk_kw)
    t1, s1, a1 = _merge_rest_nearest(accel, rp, t1, s1, a1, eps, n_attrs,
                                     attr_kind)
    if t_cap is None:
        return t1[0, :r], s1[0, :r], a1[:, :r]
    done = t1 < float(t_cap)  # a rest hit beyond the cap settles nothing
    alive2 = (rp[7:8] != 0.0) & ~done
    rp2 = torch.cat([rp[:7], alive2.to(rp.dtype)], dim=0)
    t2, s2, a2 = _walk_groups(accel, rp2, eps, True, INF, n_attrs, **walk_kw)
    # A survivor's rest candidate, merged in phase 1, may still win.
    keep1 = done | ~(t2 < t1)
    t = torch.where(done, t1, torch.minimum(t1, t2))
    s = torch.where(keep1, s1, s2)
    a = torch.where(keep1, a1, a2)
    return t[0, :r], s[0, :r], a[:, :r]


def grad_planes_soa(accel: ClusterAccel, rays8: torch.Tensor,
                    eps: float = 1e-8, ray_tile: int = RAY_TILE
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The nearest walk with the backward's planes only: (t [N], planes
    [11, N] = the winner's v0 | e1 | e2 | tri_id | obj_id, 0 on a miss).
    The winner is the shading walk's (same lists, same tie rule)."""
    t, _, planes = nearest_hit_attrs_soa(accel, rays8, eps,
                                         attr_kind="grad", ray_tile=ray_tile)
    return t, planes


def any_hit_soa(accel: ClusterAccel, rays8: torch.Tensor, eps: float = 1e-8,
                t_max=INF, wq: bool = False, variant: str = "pmt",
                lane_cull: bool = False, ray_tile: int = RAY_TILE
                ) -> torch.Tensor:
    """Occlusion over the pack -> [N] bool. t_max: a number (one bound for
    every ray) or an [N] tensor (each ray's own bound — an area light's
    shadow sample stops at its light's surface). An infinite entry of the
    tensor becomes 3e38; the lanes that pad the pack get 0. variant,
    lane_cull and ray_tile as in `nearest_hit_attrs_soa`."""
    rp, r = _pad_rays_soa(rays8, ray_tile)
    tmax_row = None
    if isinstance(t_max, torch.Tensor) and t_max.dim():
        t_max = t_max.detach()  # a traversal decision: never differentiated
        row = torch.where(torch.isfinite(t_max), t_max, _BIG)
        tmax_row = torch.nn.functional.pad(
            row.to(rays8.dtype)[None], (0, rp.shape[1] - r)).contiguous()
        t_max = INF
    t_max = float(t_max)
    _, occ, _ = _walk_groups(accel, rp, eps, False, t_max, 0, wq=wq,
                             tmax_row=tmax_row, variant=variant,
                             lane_cull=lane_cull, ray_tile=ray_tile)
    occ = _merge_rest_any_hit(accel, rp, occ[0] != 0, eps, t_max, tmax_row)
    return occ[:r]


def _objid_expand(accel: ClusterAccel, attrs_k, hit):
    """objid planes (normal(3) | obj_id) -> the 9 shading rows
    normal | color | albedo/pi, reflectivity, roughness through the object
    table; miss lanes 0."""
    if accel.attr_tables is None:
        return attrs_k
    obj = attrs_k[3].to(torch.int32)
    tbl = accel.attr_tables
    rest = torch.zeros((6, obj.shape[0]), dtype=attrs_k.dtype,
                       device=attrs_k.device)
    for k in range(tbl.shape[0]):
        rest = torch.where(obj[None] == k, tbl[k][:, None], rest)
    rest = torch.where(hit[None], rest, 0.0)
    return torch.cat([attrs_k[:3], rest], dim=0)


@spanned("rt.attrs")
def _shaded(accel: ClusterAccel, t, slot, attrs_k) -> Tuple[Hit, torch.Tensor]:
    hit = torch.isfinite(t)
    attrs = _objid_expand(accel, attrs_k, hit).T
    return Hit(t=t, tri=torch.where(hit, slot, 0), hit=hit), attrs


def any_hit(accel: ClusterAccel, o, d, eps: float = 1e-8, t_max=INF,
            alive=None, wq: bool = False, variant: str = "pmt",
            lane_cull: bool = False, ray_tile: int = RAY_TILE
            ) -> torch.Tensor:
    """Occlusion of rays o, d [N, 3] -> [N] bool (a traversal decision:
    nothing of it is differentiated), culled in tiles of ray_tile rays."""
    _count_rays("shadow", o.shape[0], alive)
    return any_hit_soa(accel, rays_to_soa(o.detach(), d.detach(),
                                          alive=alive), eps, t_max, wq=wq,
                       variant=variant, lane_cull=lane_cull,
                       ray_tile=ray_tile)


# ---------------------------------------------------------------------------
# Gradients: the walk's decisions stay detached; t and the attributes are
# re-derived from the live tables in the backward
# ---------------------------------------------------------------------------


def _count_grad_hits(hit) -> None:
    """Under counting, the lanes a backward scatters a gradient from
    (`grad.hit`)."""
    if COUNTERS.counting:
        COUNTERS.add_device("grad.hit", hit.sum())


def _t_math(va, vb, vc, o, d, hit):
    """Möller–Trumbore t of rays o, d [N, 3] against triangles given by
    their corners, 0 where the ray missed (so no NaN reaches a cotangent).
    The edges are taken as vb - va and vc - va, as the JAX package's
    backward takes them."""
    t_d, _ = moller_trumbore(o, d, TriangleSoA(va, vb - va, vc - va), INF,
                             1e-8)
    return torch.where(hit & torch.isfinite(t_d), t_d, 0.0)


def _t_vjp(va, vb, vc, o, d, hit, g_t):
    """Cotangents of `_t_math` for (va, vb, vc, o, d) under g_t [N], masked
    by hit."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in (va, vb, vc, o, d)]
        t = _t_math(*xs, hit)
        return torch.autograd.grad(t, xs, torch.where(hit, g_t, 0.0))


class _LazyT(torch.autograd.Function):
    """t of a nearest walk (twin of the JAX package's `_lazy_t`): forward
    the kernel's value; backward re-derives it from the live vertices of
    each ray's triangle (original ids `tri`, corners `tri_v`) and adds the
    per-corner gradients into the vertex pool; the rays get theirs. The
    backward runs in the span `rt.grad` (kind "lazy_t")."""

    @staticmethod
    def forward(ctx, verts, o, d, tri_v, tri, hit, t_k):
        ctx.save_for_backward(verts, o, d, tri_v, tri, hit)
        return t_k.clone()

    @staticmethod
    def backward(ctx, g):
        with span("rt.grad", kind="lazy_t"):
            return _LazyT._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        verts, o, d, tri_v, tri, hit = ctx.saved_tensors
        need = ctx.needs_input_grad
        _count_grad_hits(hit)
        tvs = tri_v[torch.where(hit, tri, 0).long()].long()
        corners = [verts[tvs[:, k]] for k in range(3)]
        dva, dvb, dvc, do, dd = _t_vjp(*corners, o, d, hit, g)
        dverts = None
        if need[0]:
            n_v = verts.shape[0]
            idx = torch.cat([torch.where(hit, tvs[:, k], n_v)
                             for k in range(3)])
            dverts = segment_scatter_add(n_v, idx,
                                         torch.cat([dva, dvb, dvc]))
        return (dverts, do if need[1] else None, dd if need[2] else None,
                None, None, None, None)


class _ShadedWalk(torch.autograd.Function):
    """Differentiable (t, slot, attrs [N, 9]) of the nearest walk (twin of
    the JAX package's `_shaded_walk`). The forward walks with the shading
    and the backward's planes together (`attr_kind="both"`, in the
    query's culling tile), so the backward needs no second walk: t is re-derived from the winner's
    v0 | e1 | e2 planes (corners v0, v0 + e1, v0 + e2), its per-corner
    gradients summed per triangle id and then into the vertex pool; the
    normal and color cotangents go to the triangle, the material ones to
    the object. Gradients reach verts, normals, colors, materials and the
    rays o, d; which triangle a ray hits stays detached. The planes are
    the accel's: for t to follow moved vertices they must be refit
    (`accel.packets.refit_geometry`). The backward runs in the span
    `rt.grad` (kind "shaded_walk") and, under counting, adds its hit
    lanes to `grad.hit`; the forward's lanes count in `grad.rays`."""

    @staticmethod
    def forward(ctx, verts, normals, colors, materials, o, d, tri_v, query):
        accel, rays8, eps, walk_kw = query
        t, slot, both = nearest_hit_attrs_soa(accel, rays8, eps,
                                              attr_kind="both", **walk_kw)
        a_rows = accel.attr_blocks.shape[1]
        hit = torch.isfinite(t)
        attrs = _objid_expand(accel, both[:a_rows], hit).T
        ctx.save_for_backward(o, d, hit, both[a_rows:], tri_v)
        ctx.rows = (verts.shape[0], normals.shape[0], materials.shape[0])
        ctx.mark_non_differentiable(slot)
        return t, slot, attrs

    @staticmethod
    def backward(ctx, g_t, _g_slot, g_a):
        with span("rt.grad", kind="shaded_walk"):
            return _ShadedWalk._backward(ctx, g_t, g_a)

    @staticmethod
    def _backward(ctx, g_t, g_a):
        o, d, hit, planes, tri_v = ctx.saved_tensors
        n_v, t_rows, n_obj = ctx.rows
        need = ctx.needs_input_grad
        _count_grad_hits(hit)
        triid = planes[9].long()
        dverts = dn = dc = dm = do = dd = None
        if need[0] or need[4] or need[5]:
            v0 = planes[0:3].T
            dva, dvb, dvc, do, dd = _t_vjp(v0, v0 + planes[3:6].T,
                                           v0 + planes[6:9].T, o, d, hit,
                                           g_t)
        if need[0]:
            # rays -> (corner, triangle) -> vertex pool; dead and missing
            # lanes go to the drop buckets.
            t3 = 3 * t_rows
            idx3 = torch.cat([torch.where(hit, triid + k * t_rows, t3)
                              for k in range(3)])
            dtri = segment_scatter_add(t3, idx3, torch.cat([dva, dvb, dvc]))
            dverts = segment_scatter_add(n_v, tri_v.T.reshape(-1), dtri)
        gm = torch.where(hit[:, None], g_a, 0.0)
        if need[1] or need[2]:
            dnc = segment_scatter_add(
                t_rows, torch.where(hit, triid, t_rows), gm[:, 0:6])
            dn, dc = dnc[:, 0:3], dnc[:, 3:6]
        if need[3]:
            dm = segment_scatter_add(
                n_obj, torch.where(hit, planes[10].long(), n_obj), gm[:, 6:9])
        return (dverts, dn, dc, dm, do if need[4] else None,
                dd if need[5] else None, None, None)


# Triangle and object ids ride the backward's planes as f32, exact below
# this many triangles.
_MAX_GRAD_TRIANGLES = 1 << 24


def _differentiated(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def nearest_hit(mesh, accel: ClusterAccel, o, d, eps: float = 1e-8,
                alive=None, variant: str = "pmt",
                ray_tile: int = RAY_TILE) -> Hit:
    """Nearest hit with ORIGINAL triangle ids (0 on a miss) and a t that is
    the kernel's forward and differentiates through the live vertices
    (`_LazyT`; twin of the JAX package's `nearest_hit_pallas`). variant:
    the intersector family (VARIANTS); ray_tile: the culling tile."""
    _count_rays("nearest", o.shape[0], alive)
    rays8 = rays_to_soa(o.detach(), d.detach(), alive=alive)
    t_k, tri = nearest_hit_soa(accel, rays8, eps, variant=variant,
                               ray_tile=ray_tile)
    hit = torch.isfinite(t_k)
    if _differentiated(mesh.verts, o, d):
        t_k = _LazyT.apply(mesh.verts, o, d, mesh.tri_v, tri, hit, t_k)
    return Hit(t=t_k, tri=tri, hit=hit)


def nearest_hit_shaded(mesh, accel: ClusterAccel, o, d, eps: float = 1e-8,
                       alive=None, early_exit=None, wq: bool = False,
                       shared_origin=None, variant: str = "pmt",
                       t_cap: Optional[float] = None,
                       lane_cull: bool = False, ray_tile: int = RAY_TILE
                       ) -> Tuple[Hit, torch.Tensor]:
    """The renderer's nearest query: (Hit with packed slot ids, attrs
    [N, 9] = normal | color | albedo/pi, reflectivity, roughness).
    variant, t_cap (the two-phase query), lane_cull and ray_tile as in
    `nearest_hit_attrs_soa`.

    Under autograd, when one of the mesh's verts, normals, colors or
    materials or the rays o, d requires grad, the query is `_ShadedWalk`:
    t and attrs differentiate into them. Otherwise it walks the shading
    planes alone, so a frame nobody differentiates carries no extra
    plane."""
    _count_rays("nearest", o.shape[0], alive)
    rays8 = rays_to_soa(o.detach(), d.detach(), alive=alive)
    if shared_origin is not None:
        shared_origin = shared_origin.detach()
    walk_kw = dict(early_exit=early_exit, wq=wq, shared_origin=shared_origin,
                   variant=variant, t_cap=t_cap, lane_cull=lane_cull,
                   ray_tile=ray_tile)
    if not _differentiated(mesh.verts, mesh.normals, mesh.colors,
                           mesh.materials, o, d):
        t, slot, attrs_k = nearest_hit_attrs_soa(accel, rays8, eps,
                                                 **walk_kw)
        return _shaded(accel, t, slot, attrs_k)
    COUNTERS.add("grad.rays", o.shape[0])
    if mesh.num_triangles > _MAX_GRAD_TRIANGLES:
        raise ValueError(
            f"a differentiated query on {mesh.num_triangles} triangles: "
            f"the backward carries triangle ids as f32, exact only up to "
            f"{_MAX_GRAD_TRIANGLES} triangles")
    t, slot, attrs = _ShadedWalk.apply(
        mesh.verts, mesh.normals, mesh.colors, mesh.materials, o, d,
        mesh.tri_v, (accel, rays8, eps, walk_kw))
    hit = torch.isfinite(t.detach())
    return Hit(t=t, tri=torch.where(hit, slot, 0), hit=hit), attrs


# ---------------------------------------------------------------------------
# Camera mode: primary nearest hit with the rays derived in the kernel
# ---------------------------------------------------------------------------


class Camera(NamedTuple):
    """The pinhole frame as camera mode sees it: width x height pixels in
    bh x bw blocks, spp samples each. A tile is one block's spp * bh * bw
    rays: lane l is sample l // (bh*bw) of pixel divmod(l % (bh*bw), bw)
    of block divmod(tile, width // bw) — `models.camera.block_ray_ids`'
    order."""

    width: int
    height: int
    spp: int
    scale: float
    bh: int
    bw: int

    @property
    def aspect(self) -> float:
        return float(self.width) / float(self.height)

    @property
    def ray_tile(self) -> int:
        return self.spp * self.bh * self.bw

    @property
    def grid(self) -> Tuple[int, int]:
        """(block rows, block columns) of the frame."""
        return self.height // self.bh, self.width // self.bw


@spanned("rt.lists")
def _camera_tile_extents(n_tiles: int, offs, cam: Camera, tile0: int = 0):
    """Closed-form per-tile frustum extents (traverse.py:
    _camera_tile_extents): the direction formula is monotone in (pixel +
    offset) per axis and so is every f32 op in it, so its values at the
    extreme (pixel + offset) are exactly the min/max that `tile_extents`
    finds over the materialised pack. Tiles past the frame's last block
    repeat it. Returns (o_lo, o_hi, d_lo, d_hi) [n_tiles, 3]; the origin is
    the pinhole at 0."""
    w, h = cam.width, cam.height
    nby, nbx = cam.grid
    tt = torch.clamp_max(
        tile0 + torch.arange(n_tiles, dtype=torch.int32, device=offs.device),
        nbx * nby - 1)
    br = tt // nbx
    bc = tt % nbx
    x_lo = (bc * cam.bw).to(torch.float32) + offs[:, 0].min()
    x_hi = (bc * cam.bw + (cam.bw - 1)).to(torch.float32) + offs[:, 0].max()
    y_lo = (br * cam.bh).to(torch.float32) + offs[:, 1].min()
    y_hi = (br * cam.bh + (cam.bh - 1)).to(torch.float32) + offs[:, 1].max()
    w, h = device_scalar(w, offs), device_scalar(h, offs)  # IEEE division
    xx_lo = (2.0 * x_lo / w - 1.0) * cam.aspect * cam.scale
    xx_hi = (2.0 * x_hi / w - 1.0) * cam.aspect * cam.scale
    yy_lo = (1.0 - 2.0 * y_hi / h) * cam.scale  # yy decreases in y
    yy_hi = (1.0 - 2.0 * y_lo / h) * cam.scale
    one = torch.ones_like(xx_lo)
    z = torch.zeros((n_tiles, 3), dtype=torch.float32, device=offs.device)
    return (z, z, torch.stack([xx_lo, yy_lo, one], dim=1),
            torch.stack([xx_hi, yy_hi, one], dim=1))


def _camera_dir_rows(n: int, offs, cam: Camera, ray_base: int = 0):
    """The directions camera mode's kernel derives, as (dx, dy, dz) [1, n]
    rows over block-order ray ids from `ray_base` (traverse.py:
    _camera_dir_rows_xla): bit-equal to the block-permuted
    `camera_rays_for_ids`. A BLOCK index past the frame clamps to the last
    block with the lane kept, as the kernel clamps."""
    nby, nbx = cam.grid
    p2 = cam.bh * cam.bw
    l = ray_base + torch.arange(n, dtype=torch.int64, device=offs.device)[None]
    b = torch.clamp_max(l // cam.ray_tile, nbx * nby - 1)
    r = l % cam.ray_tile
    s_idx = r // p2
    p = r % p2
    xi = ((b % nbx) * cam.bw + p % cam.bw).to(torch.float32)
    yi = ((b // nbx) * cam.bh + p // cam.bw).to(torch.float32)
    ox, oy = offs[s_idx, 0], offs[s_idx, 1]
    w, h = device_scalar(cam.width, offs), device_scalar(cam.height, offs)
    xx = (2.0 * (xi + ox) / w - 1.0) * cam.aspect * cam.scale
    yy = (1.0 - 2.0 * (yi + oy) / h) * cam.scale
    return xx, yy, torch.ones_like(xx)


def walk_camera_plain(offs, cam: Camera, tile_base: int, n_tiles: int, ids,
                      cnt, geo, attr, n_attrs: int, cs: int, eps: float,
                      lane_bounds=None):
    """Plain version of the camera walk: materialise the directions
    (`_camera_dir_rows`) and run `walk_plain` with the origin-folded
    intersector over tiles of cam.ray_tile rays (with the lane-cull
    pre-test on lane_bounds, if given)."""
    n = n_tiles * cam.ray_tile
    dx, dy, dz = _camera_dir_rows(n, offs, cam, tile_base * cam.ray_tile)
    zero, one = torch.zeros_like(dx), torch.ones_like(dx)
    rays8 = torch.cat([zero, zero, zero, one, dx, dy, dz, one], dim=0)
    return walk_plain(rays8, ids, cnt, geo, attr, n_attrs, cs, eps, True,
                      INF, PMTO, ray_tile=cam.ray_tile,
                      lane_bounds=lane_bounds)


@spanned("rt.walk", key="entry")
def walk_camera(offs, cam: Camera, tile_base: int, n_tiles: int, ids, cnt,
                geo, attr, n_attrs: int, cs: int, eps: float, tnear=None,
                bbox=None, ee_batch: int = 1, entry: str = "walk_camera",
                visits=None, lane_bounds=None):
    """K1 camera / K2 camera (csrc/camera.cu): plain version on CPU, kernel
    on CUDA. Nearest hit of frame blocks [tile_base, tile_base + n_tiles)
    over their lists, in block ray order: (t [1, N], slot [1, N] i32,
    attrs [A, N] | None). geo is the origin-folded table; offs [spp, 2] is
    read on the device at every launch. The kernel walks a tile in passes
    of 1,024 rays and splits each pass's walk of the tile's list as `walk`
    splits a list (`_camera_grid`), merged per ray in any order. `entry`
    names the launch count ("walk_camera" or "walk_camera_dma"); `visits`
    and lane_bounds (the unfolded boxes: the origin is 0) as in `walk`."""
    if _on_cpu(offs, ids, cnt, geo, attr, lane_bounds):
        if COUNTERS.counting:
            _count_walk(None, cnt, ids.shape[1], cam.ray_tile * cs)
        return walk_camera_plain(offs, cam, tile_base, n_tiles, ids, cnt,
                                 geo, attr, n_attrs, cs, eps, lane_bounds)
    if (offs.dtype != torch.float32 or offs.shape != (cam.spp, 2)
            or not offs.is_contiguous()):
        raise ValueError("walk_camera: offs must be contiguous f32 [spp, 2]")
    if cam.width % cam.bw or cam.height % cam.bh:
        raise ValueError("walk_camera: bw | width and bh | height")
    _check_walk_tables("walk_camera", n_tiles, ids, cnt, geo, attr, cs, tnear,
                       bbox, PMTO, lane_bounds)
    dev = ids.device
    n = n_tiles * cam.ray_tile
    out_t = torch.empty((1, n), dtype=torch.float32, device=dev)
    out_s = torch.empty((1, n), dtype=torch.int32, device=dev)
    attr_t = attr if n_attrs else None
    out_a = (torch.empty((n_attrs, n), dtype=torch.float32, device=dev)
             if attr_t is not None else None)
    seg, tile_blocks, passes = _camera_grid(n_tiles, cam.ray_tile,
                                            ids.shape[1], cs)
    # Scratch of the blocks' merge; the launch fills both.
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    finished = torch.empty(n_tiles * passes, dtype=torch.int32, device=dev)
    cnt32 = cnt.to(torch.int32).contiguous()
    early = tnear is not None
    if visits is None and COUNTERS.counting:
        visits = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    lib = cuda.library()
    with torch.cuda.device(ids.device):
        cuda.check(lib.rt_walk_camera(
            _ptr(offs), int(tile_base), n_tiles, cam.width, cam.height,
            cam.spp, cam.bh, cam.bw, float(cam.aspect), float(cam.scale), _ptr(ids),
            _ptr(cnt32), _ptr(tnear), ids.shape[1], seg, tile_blocks,
            _ptr(bbox if early else None), _ptr(geo), geo.stride(0),
            _ptr(attr_t), attr_t.stride(0) if attr_t is not None else 0,
            n_attrs if attr_t is not None else 0, cs, float(eps), int(early),
            int(ee_batch), _ptr(lane_bounds), _ptr(keys), _ptr(finished),
            _ptr(out_t), _ptr(out_s), _ptr(out_a), _ptr(visits),
            _stream(ids)), entry)
    _count(_count_key(entry, lane_cull=lane_bounds is not None))
    if COUNTERS.counting:  # a pass walks up to RAY_TILE of a tile's rays
        _count_walk(visits, cnt, ids.shape[1],
                    min(cam.ray_tile, RAY_TILE) * cs, passes)
    return out_t, out_s, out_a


def _supertiles(cam: Camera):
    """(gy, gx, py, px, nby2, nbx2): the pooled lists' supertiles of gy x
    gx blocks (~32x32 pixels) on the block grid shifted by (py, px), so
    that the screen centre falls on a supertile boundary, nby2 x nbx2 of
    them."""
    nby, nbx = cam.grid
    gy, gx = max(1, 32 // cam.bh), max(1, 32 // cam.bw)
    py = (-(cam.height // 2 // cam.bh)) % gy
    px = (-(cam.width // 2 // cam.bw)) % gx
    return (gy, gx, py, px, (py + nby + gy - 1) // gy,
            (px + nbx + gx - 1) // gx)


def _supertile_grid(a, cam: Camera, fill: float):
    """Per-block rows [nt, 3] on the supertile grid (`_supertiles`):
    [nby2, gy, nbx2, gx, 3], the shift and the ragged edge padded with
    `fill`."""
    nby, nbx = cam.grid
    gy, gx, py, px, nby2, nbx2 = _supertiles(cam)
    a = torch.nn.functional.pad(
        a.reshape(nby, nbx, 3),
        (0, 0, px, gx * nbx2 - nbx - px, py, gy * nby2 - nby - py),
        value=fill)
    return a.reshape(nby2, gy, nbx2, gx, 3)


@spanned("rt.lists")
def _supertile_lists(accel: ClusterAccel, ext, cam: Camera):
    """The pooled lists' first stage: each supertile's lists on the
    min/max of its blocks' frustums (padding is an inverted box: it never
    widens one), cut to the longest (`_narrow_lists`). Returns (ids [nst,
    w] i32, cnt [nst] i32)."""
    def pool(a, upper):
        g = _supertile_grid(a, cam, -_BIG if upper else _BIG)
        return (g.amax(dim=(1, 3)) if upper else g.amin(dim=(1, 3))
                ).reshape(-1, 3)

    o_lo, o_hi, d_lo, d_hi = ext
    return _narrow_lists(*lists_from_extents(
        pool(o_lo, False), pool(o_hi, True), pool(d_lo, False),
        pool(d_hi, True), accel.cluster_min, accel.cluster_max))[::2]


@spanned("rt.lists")
def _pooled_camera_lists(accel: ClusterAccel, ext, cam: Camera,
                         first=None):
    """Per-tile lists of the whole frame through supertiles
    (traverse.py:3505-3644): the interval test and its sort run once per
    gy x gx block neighbourhood (~32x32 pixels) on the pooled frustum
    (`_supertile_lists`), then each member tile re-tests only the
    supertile's candidates with its own frustum — the same lists as the
    direct test gives, as sets, at a fraction of the [tiles, C] work. The
    supertile grid is phase-shifted so the screen centre (where a
    direction component changes sign, which makes a pooled axis
    unbounded) falls on a group boundary. The candidate width is the
    longest pooled list: nothing is cut short. `first`: the first stage's
    result if built already; the second stage alone then runs
    (`rt_camera_member_lists`' plain version)."""
    nby, nbx = cam.grid
    gy, gx, py, px, nby2, nbx2 = _supertiles(cam)
    nst = nby2 * nbx2

    def members(a):  # padded members are cut away by `ungroup`
        return _supertile_grid(a, cam, 0.0).permute(0, 2, 1, 3, 4).reshape(
            nst, gy * gx, 3)

    def ungroup(a):  # [nst, m, w] -> [nt, w]
        w_ = a.shape[-1]
        a = a.reshape(nby2, nbx2, gy, gx, w_).permute(0, 2, 1, 3, 4)
        a = a.reshape(gy * nby2, gx * nbx2, w_)
        return a[py:py + nby, px:px + nbx].reshape(nby * nbx, w_)

    o_lo, o_hi, d_lo, d_hi = ext
    ids_p, cnt_p = first or _supertile_lists(accel, ext, cam)
    # Each member's re-test of its supertile's candidates (boxes gathered
    # per supertile).
    idl = ids_p.long()
    cm, cx = accel.cluster_min[idl], accel.cluster_max[idl]  # [nst, wp, 3]
    flags, t_near = _frustum_slabs(
        members(o_lo), members(o_hi), members(d_lo), members(d_hi),
        lambda k: cm[:, None, :, k], lambda k: cx[:, None, :, k])
    listed = torch.arange(ids_p.shape[1], device=ids_p.device)[None] \
        < cnt_p[:, None]
    ids, tnear, cnt = _compact_lists(flags & listed[:, None], t_near,
                                     ids_p[:, None])
    return (ungroup(ids).contiguous(), ungroup(tnear).contiguous(),
            ungroup(cnt[..., None])[:, 0])


def _pooled(accel: ClusterAccel, cam: Camera, tile0: int,
            n_tiles: int) -> bool:
    """Whether a camera query's lists go through supertiles: the whole
    frame over more than `_SUPERTILE_MIN_C` clusters, in blocks small
    enough to pool (a chunk's run of blocks wraps screen rows)."""
    gy, gx = _supertiles(cam)[:2]
    return (tile0 == 0 and n_tiles == cam.grid[0] * cam.grid[1]
            and accel.num_clusters > _SUPERTILE_MIN_C and gy * gx > 1)


@spanned("rt.lists")
def camera_lists(accel: ClusterAccel, offs, cam: Camera, tile0: int,
                 n_tiles: int):
    """Camera mode's visit lists of frame blocks [tile0, tile0 + n_tiles)
    (blocks past the frame repeat the last one): each block's frustum in
    closed form against every cluster box, through supertiles where
    `_pooled` says so. Plain composition on CPU (`_camera_tile_extents`,
    then `lists_from_extents` or `_pooled_camera_lists`); on CUDA the
    frustums never leave the kernel (csrc/lists.cu): one launch of
    `rt_camera_lists`, or for the pooled lists that entry over the
    supertiles, `_narrow_lists`' one host sync for the candidate width,
    and one launch of `rt_camera_member_lists` (each block's re-test of its
    supertile's candidates); the plain results bit for bit. Returns (ids
    [n_tiles, W] i32, tnear [n_tiles, W], cnt [n_tiles] i32); counts the
    blocks it lists on the card in `lists.camera`."""
    cmin, cmax = accel.cluster_min, accel.cluster_max
    pooled = _pooled(accel, cam, tile0, n_tiles)
    if _on_cpu(offs, cmin, cmax):
        ext = _camera_tile_extents(n_tiles, offs, cam, tile0)
        if pooled:
            return _pooled_camera_lists(accel, ext, cam)
        return lists_from_extents(*ext, cmin, cmax)
    _check_tables("camera_lists", cmin, cmax)
    if (offs.dtype != torch.float32 or offs.shape != (cam.spp, 2)
            or not offs.is_contiguous()):
        raise ValueError("camera_lists: offs must be contiguous f32 [spp, 2]")
    dev, c = cmin.device, cmin.shape[0]
    gy, gx, py, px, nby2, nbx2 = _supertiles(cam) if pooled else (
        1, 1, 0, 0, 0, 0)
    frame = (_ptr(offs), cam.spp, cam.width, cam.height, cam.bh, cam.bw,
             float(cam.aspect), float(cam.scale))
    rows = nby2 * nbx2 if pooled else n_tiles
    ids, tnear, cnt = _list_outputs((rows, c), dev)
    lib = cuda.library()
    if rows and c:
        scratch, bits = _lists_scratch(rows, c, dev)
        with torch.cuda.device(cmin.device):
            cuda.check(lib.rt_camera_lists(
                *frame, int(tile0), rows, gy, gx, py, px, _ptr(cmin),
                _ptr(cmax), c, _ptr(ids), _ptr(tnear), _ptr(cnt),
                _ptr(scratch), _ptr(bits), _stream(cmin)), "lists_camera")
        _count("lists_camera_pooled" if pooled else "lists_camera")
    if pooled:
        # The supertiles' lists stay [nst, C]: the second stage reads
        # their first w columns at a row stride of C.
        with host_sync("narrow_lists"):
            w = max(1, int(cnt.max()))
        cand, cand_cnt = ids, cnt
        ids, tnear, cnt = _list_outputs((n_tiles, w), dev)
        scratch, bits = _lists_scratch(n_tiles, w, dev)
        with torch.cuda.device(cmin.device):
            cuda.check(lib.rt_camera_member_lists(
                *frame, gy, gx, py, px, _ptr(cand), c, _ptr(cand_cnt), w,
                _ptr(cmin), _ptr(cmax), _ptr(ids), _ptr(tnear), _ptr(cnt),
                _ptr(scratch), _ptr(bits), _stream(cmin)),
                "lists_camera_members")
        _count("lists_camera_members")
    COUNTERS.add("lists.camera", n_tiles)
    return ids, tnear, cnt


def _camera_walk_args(accel: ClusterAccel, offs, cam: Camera, tile0: int,
                      n_tiles: int, n_attrs: int, eps: float,
                      early_exit=None, lane_cull=False):
    """The camera-mode launch: closed-form frustum lists (`camera_lists`:
    through supertiles for the whole frame over more than
    `_SUPERTILE_MIN_C` clusters) over the origin-folded table — separate
    tables (K1 camera) or, for a cluster size that is a multiple of 128,
    the combined one (K2 camera). `lane_cull` gives K1 camera the boxes of
    the lane-cull pre-test (the TPU's K2 camera has none). Returns
    (args, kw):
    `walk_camera(*args, **kw)` is the launch and `walk_camera_plain(*args)`
    its plain version."""
    cs = accel.cluster_size
    ids, tnear, cnt = camera_lists(accel, offs, cam, tile0, n_tiles)
    early = _early(True, accel.num_clusters, early_exit)
    zero3 = torch.zeros(3, dtype=torch.float32, device=offs.device)
    folded = _fold_origin(accel.pmt_blocks, zero3)
    dma = cs % 128 == 0
    if dma:
        geo, attr = _combined_table(folded, accel, n_attrs)
    else:
        geo, attr = folded, accel.attr_blocks if n_attrs else None
    args = (offs, cam, tile0, n_tiles, ids, cnt, geo, attr, n_attrs, cs, eps)
    kw = dict(tnear=tnear if early else None,
              bbox=(_union_box(accel.cluster_min, accel.cluster_max)
                    if early else None),
              ee_batch=_dma_ee_batch(cs) if dma else _ee_batch_for(cs),
              entry="walk_camera_dma" if dma else "walk_camera")
    if lane_cull and not dma:
        kw["lane_bounds"] = _lane_bounds(accel.cluster_min,
                                         accel.cluster_max)
    return args, kw


def camera_mode_supported(accel: Optional[ClusterAccel]) -> bool:
    """Whether `nearest_hit_camera_soa` can run for this accel: it needs
    the Baldwin–Weber blocks. (The TPU package also asks whether the table
    fits its VMEM budget; the card reads it from device memory at any
    size.)"""
    return accel is not None and accel.pmt_blocks is not None


def nearest_hit_camera_soa(accel: ClusterAccel, offs, *, width: int,
                           height: int, spp: int, scale: float = 1.0,
                           eps: float = 1e-8, bh: int = 16, bw: int = 16,
                           with_attrs: bool = False,
                           early_exit: Optional[bool] = None,
                           tile_base: Optional[int] = None,
                           tiles: Optional[int] = None,
                           lane_cull: bool = False):
    """Primary nearest hit with the rays derived in the kernel from the
    pinhole formula (camera mode): no ray pack exists anywhere. Tile
    frustums come from the closed form, the walk derives each direction
    from its tile index, and the rest set's merge derives them again
    (`_merge_rest_camera`: in its kernel on the card).

    offs: [spp, 2] sub-pixel offsets, a tensor; it is moved to the accel's
    device if it lies elsewhere (`stratified_offsets(spp)` is a CPU table).
    Returns (t [N], slot [N]) — or (t, slot, attrs [A, N]) with
    `with_attrs` — in `block_ray_ids` order, bit-equal to the pack path
    under `shared_origin=0` on the block-permuted `camera_rays_for_ids`.
    Needs bw | width and bh | height.

    tile_base / tiles: cover only frame blocks [tile_base, tile_base +
    tiles) (the renderer's per-chunk primary level); blocks past the frame
    repeat the last one. Supertile pooling serves whole-frame calls over
    more than `_SUPERTILE_MIN_C` clusters (a chunk's run of blocks wraps
    screen rows). A cluster size that is a multiple of 128 takes the
    combined-table entry (K2 camera), as `_walk_groups(wq=True)` does.
    lane_cull: K1 camera's lane-cull pre-test (no result changes)."""
    if width % bw or height % bh:
        raise ValueError("camera mode needs bw | width and bh | height")
    if (tile_base is None) != (tiles is None):
        raise ValueError("tile_base and tiles must be given together")
    if not camera_mode_supported(accel):
        raise ValueError("camera mode needs pmt blocks")
    cam = Camera(width, height, spp, scale, bh, bw)
    chunked = tile_base is not None
    nby, nbx = cam.grid
    n_tiles = tiles if chunked else nby * nbx
    tile0 = int(tile_base) if chunked else 0
    n_attrs = accel.attr_blocks.shape[1] if with_attrs else 0
    n = n_tiles * cam.ray_tile
    _count_rays("nearest", n)
    with span("rt.query", kind="camera", rays=n):
        offs = offs.to(device=accel.pmt_blocks.device,
                       dtype=torch.float32).contiguous()
        args, kw = _camera_walk_args(accel, offs, cam, tile0, n_tiles,
                                     n_attrs, eps, early_exit=early_exit,
                                     lane_cull=lane_cull)
        t, slot, attrs = walk_camera(*args, **kw)
        t, slot, attrs = _merge_rest_camera(accel, offs, cam, tile0, t,
                                            slot, attrs, eps, n_attrs)
    if n_attrs:
        return t[0], slot[0], attrs
    return t[0], slot[0]


def nearest_hit_shaded_camera(accel: ClusterAccel, offs, *, width: int,
                              height: int, spp: int, scale: float = 1.0,
                              eps: float = 1e-8,
                              tile_base: Optional[int] = None,
                              tiles: Optional[int] = None, bh: int = 16,
                              bw: int = 16, early_exit: Optional[bool] = None
                              ) -> Tuple[Hit, torch.Tensor]:
    """`nearest_hit_shaded` for the renderer's primary level in camera
    mode: (Hit with packed slot ids, attrs [N, 9]) in block ray order."""
    t, slot, attrs_k = nearest_hit_camera_soa(
        accel, offs, width=width, height=height, spp=spp, scale=scale,
        eps=eps, bh=bh, bw=bw, with_attrs=True, early_exit=early_exit,
        tile_base=tile_base, tiles=tiles)
    return _shaded(accel, t, slot, attrs_k)
