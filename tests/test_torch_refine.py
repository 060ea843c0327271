"""The work division of the entered-refinement kernels (csrc/refine.cu),
made executable on the CPU.

Both forms of K5 keep a tile's rays in registers, 4 lanes a thread (ray
128 w + 32 r + l of the tile in lane l of warp w), a degenerate axis as a NaN
reciprocal that the slab folds drop; every warp tests every candidate of
its block against its 128 lanes, from its own offset on, and skips a
candidate another warp has marked entered. The gathered form
(`refine_lists`) deals each tile's list in runs of `run` positions to up
to `tile_blocks` blocks on a segment-major grid, every position written by
exactly one block; the dense form (`refine_dense`, and the fused query
`refine_dense_extents`) takes the whole table in one block a tile and
reduces the tile's extents (K6) from the rays it reads. The model below is
that design in plain PyTorch, block by block, its warps as coroutines
under a seeded scheduler (the order in which warps mark and skip differs
from run to run on the card), with the kernels' op order.

Bars: bits and extents `torch.equal` to `refine_lists_plain`,
`refine_dense_plain` and `tile_extents_plain` — no tolerance: an OR over
the alive lanes does not depend on which warp finds a witness. Plus the
work the design promises: a long list spread over blocks, a candidate no
lane enters tested by every warp that holds an alive lane, a warp with no
alive lane testing nothing, marked candidates skipped. The plain versions
themselves are held against JAX in tests/test_torch_traverse.py and
tests/test_torch_large.py; here the fused query's plain version is too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracing_tpu.accel.packets import build_cluster_accel as jax_build
from raytracing_tpu.geometry.scene import build_default_scene as jax_scene
from raytracing_tpu.kernels import traverse as JT

import raytracing_tpu_torch.kernels.traverse as T
from raytracing_tpu_torch import build_cluster_accel, build_default_scene

torch.set_num_threads(2)

INF = float("inf")
TILE = T.RAY_TILE
WARPS, PER_THREAD = 8, 4
TINY = torch.tensor(1e-20, dtype=torch.float32)
BIG = 3e38


@pytest.fixture(scope="module")
def accel():
    """The default scene at CS 16: 790 clusters, more than the dense form
    takes, so the gathered form has lists to deal."""
    return build_cluster_accel(build_default_scene(device="cpu").mesh,
                               cluster_size=16)


def _rays(rng, n, alive_frac=0.9):
    """n rays among the teapots (origins around (1, -1.2, 7.5), random
    directions), one lane in ten dead."""
    o = np.array([1.0, -1.2, 7.5]) + rng.normal(scale=[2.0, 0.6, 1.5],
                                                size=(n, 3))
    d = rng.normal(size=(n, 3))
    alive = (rng.uniform(size=n) < alive_frac).astype(np.float64)
    return np.concatenate([o.T, np.ones((1, n)), d.T, alive[None]])


def _pack(seed=3):
    """Five tiles: incoherent rays, a tile with 5 alive lanes, a dead tile,
    a tile with 31 alive lanes, and incoherent rays again. In tiles 0 and
    4 some directions have degenerate axes (|d| < 1e-20): one, two or all
    three."""
    rng = np.random.default_rng(seed)
    p = _rays(rng, 5 * TILE)
    for tile, n_alive in ((1, 5), (2, 0), (3, 31)):
        lanes = np.arange(tile * TILE, (tile + 1) * TILE)
        p[7, lanes] = 0.0
        p[7, rng.choice(lanes, n_alive, replace=False)] = 1.0
    for lane, axes in ((5, [4]), (9, [5, 6]), (17, [4, 5, 6]), (40, [6])):
        for tile in (0, 4):
            p[axes, tile * TILE + lane] = 1e-21 if lane == 40 else 0.0
            p[7, tile * TILE + lane] = 1.0
    return torch.from_numpy(np.ascontiguousarray(p, dtype=np.float32))


def _lists(rays8, accel):
    """The gathered form's input as `_refined_lists` makes it: narrowed
    frustum lists."""
    ids, _, cnt = T._narrow_lists(*T._tile_visit_lists_soa(
        rays8, accel.cluster_min, accel.cluster_max))
    return ids, cnt


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def _lanes(tile_rays):
    """The kernel's registers, per warp: the 128 lanes 128 w + 32 r + l
    of its threads (origin, reciprocal direction with NaN on a degenerate
    axis, alive flag; csrc/common.cuh's ray_index); a tile of T rays has
    T / 128 warps, 8 at the default tile."""
    d = tile_rays[4:7]
    inv = torch.where(d.abs() < TINY, float("nan"), 1.0 / d)
    alive = tile_rays[7] != 0.0
    threads = tile_rays.shape[1] // PER_THREAD
    warps = []
    for w in range(threads // 32):
        lanes = torch.tensor([w * 128 + r * 32 + lane
                              for r in range(PER_THREAD)
                              for lane in range(32)])
        warps.append((tile_rays[0:3, lanes], inv[:, lanes], alive[lanes]))
    return warps


def _slab(o, inv, lo, hi):
    """slab_enters for rays [3, L] and one box (lo, hi): each axis's
    bounds folded from -inf / +inf by fmax / fmin, which drop the NaN
    bounds of a degenerate axis."""
    tn = torch.full(o.shape[1:], -INF)
    tf = torch.full(o.shape[1:], INF)
    for k in range(3):
        t1 = (lo[k] - o[k]) * inv[k]
        t2 = (hi[k] - o[k]) * inv[k]
        tn = torch.fmax(tn, torch.fmin(t1, t2))
        tf = torch.fmin(tf, torch.fmax(t1, t2))
    tf = tf + (torch.abs(tf) * 2e-6 + 1e-7)
    tn = tn - (torch.abs(tn) * 2e-6 + 1e-7)
    return (tn <= tf) & (tf >= 0.0)


def _warp(lanes, w, boxes, mark, work, n_warps=WARPS):
    """test_candidates for warp w of n_warps as a coroutine: every
    candidate from w * m / n_warps on, a marked one skipped; yields after
    each candidate."""
    o, inv, alive = lanes
    m = boxes.shape[0]
    if not bool(alive.any()):
        return
    j = w * m // n_warps
    for _ in range(m):
        if mark[j]:
            work.append((w, j, "skip"))
        else:
            hit = bool((_slab(o, inv, boxes[j, :3], boxes[j, 3:])
                        & alive).any())
            work.append((w, j, "entered" if hit else "rejected"))
            if hit:
                mark[j] = 1
        yield
        j = 0 if j + 1 == m else j + 1


def _test_candidates(warps, boxes, rng, work):
    """One block's warps over `boxes` [m, 6], interleaved by `rng`:
    the marks [m]."""
    mark = torch.zeros(boxes.shape[0], dtype=torch.int32)
    running = [_warp(lanes, w, boxes, mark, work, len(warps))
               for w, lanes in enumerate(warps)]
    while running:
        k = int(rng.integers(len(running)))
        try:
            next(running[k])
        except StopIteration:
            running.pop(k)
    return mark


def refine_lists_model(rays8, ids, cnt, cmin, cmax, run, tile_blocks,
                       order_seed=0, ray_tile=TILE):
    """refine_lists_kernel, block by block on its segment-major grid, over
    tiles of `ray_tile` rays. Returns (bits [nt, W] bool, per block: (tile,
    listed positions tested, records (warp, list position, outcome)))."""
    rng = np.random.default_rng(order_seed)
    nt, width = ids.shape
    out = torch.full((nt, width), -1, dtype=torch.int32)
    blocks = []
    stride = tile_blocks * run
    for blk in range(nt * tile_blocks):
        tile, b = blk % nt, blk // nt
        n = max(0, min(int(cnt[tile]), width))
        warps = (None if b * run >= n else
                 _lanes(rays8[:, tile * ray_tile:(tile + 1) * ray_tile]))
        work, swept = [], 0
        for p0 in range(b * run, width, stride):
            owned = min(run, width - p0)
            listed = 0 if warps is None else max(0, min(run, n - p0))
            c = ids[tile, p0:p0 + listed].long()
            run_work = []
            bits = (_test_candidates(warps, torch.cat([cmin[c], cmax[c]],
                                                      dim=1), rng, run_work)
                    if listed else torch.zeros(0, dtype=torch.int32))
            work += [(w, p0 + j, outcome) for w, j, outcome in run_work]
            assert bool((out[tile, p0:p0 + owned] == -1).all())  # one owner
            out[tile, p0:p0 + owned] = 0
            out[tile, p0:p0 + listed] = bits
            swept += listed
        blocks.append((tile, swept, work))
    assert bool((out >= 0).all())  # every position written
    return out != 0, blocks


def _block_extents(tile_rays):
    """The fused launch's reduction: per row, each thread over its 4 rays,
    the warp's 32 threads, then the block's warps in order (dead lanes
    out)."""
    alive = tile_rays[7] != 0.0
    warps = tile_rays.shape[1] // (PER_THREAD * 32)
    v = tile_rays.reshape(8, warps, PER_THREAD, 32)
    a = alive.reshape(warps, PER_THREAD, 32)
    lo = torch.where(a, v, BIG).amin(dim=2).amin(dim=2)  # [8, warps]
    hi = torch.where(a, v, -BIG).amax(dim=2).amax(dim=2)
    return lo.amin(dim=1), hi.amax(dim=1)


def refine_dense_model(rays8, cmin, cmax, tile_alive=None, order_seed=0,
                       ray_tile=TILE):
    """refine_kernel, block by block over tiles of `ray_tile` rays: ((lo,
    hi) [nt, 8], bits [nt, C], per block: records)."""
    rng = np.random.default_rng(order_seed)
    nt = rays8.shape[1] // ray_tile
    lo = torch.empty((nt, 8))
    hi = torch.empty((nt, 8))
    out = torch.zeros((nt, cmin.shape[0]), dtype=torch.int32)
    blocks = []
    for tile in range(nt):
        tile_rays = rays8[:, tile * ray_tile:(tile + 1) * ray_tile]
        lo[tile], hi[tile] = _block_extents(tile_rays)
        live = (bool(tile_alive[tile]) if tile_alive is not None
                else bool(hi[tile, 7] > 0.0))
        work = []
        if live:
            out[tile] = _test_candidates(_lanes(tile_rays),
                                         torch.cat([cmin, cmax], dim=1), rng,
                                         work)
        blocks.append(work)
    return (lo, hi), out != 0, blocks


# ---------------------------------------------------------------------------
# The model against the plain versions
# ---------------------------------------------------------------------------


def _imbalance(accel, width_cut=None):
    """Tiles of `_pack()` with their frustum lists, then the imbalance
    shape: tile 0 lists every cluster, tile 2 (dead) one, tile 4 none; and
    with `width_cut` a tile whose count exceeds the width."""
    rays8 = _pack()
    ids, cnt = _lists(rays8, accel)
    c = accel.num_clusters
    full = torch.arange(c, dtype=torch.int32)
    ids = torch.cat([ids, ids.new_zeros((ids.shape[0],
                                         c - ids.shape[1]))], dim=1)
    ids[0] = full
    cnt = cnt.clone()
    cnt[0], cnt[2], cnt[4] = c, 1, 0
    ids[2, 0] = int(ids[1, 0])
    if width_cut is not None:
        ids, cnt[3] = ids[:, :width_cut].contiguous(), width_cut + 7
    return rays8, ids.contiguous(), cnt


GRIDS = [(None, 0), ((16, 3), 1), ((64, 64), 2), ((100, 1), 3)]


@pytest.mark.parametrize("grid,order_seed", GRIDS,
                         ids=["default", "run16-cap3", "run64-cap64",
                              "run100-cap1"])
def test_gathered_model_equals_plain(accel, grid, order_seed):
    """The imbalance shape (one tile listing all 790 clusters beside tiles
    that list one or none), tiles with 5 and 31 alive lanes and a dead
    tile, at the production grid and at others, the warps interleaved in
    another order each."""
    rays8, ids, cnt = _imbalance(accel)
    nt, width = ids.shape
    run, tile_blocks = grid or T._refine_grid(nt, width)
    args = (rays8, ids, cnt, accel.cluster_min, accel.cluster_max)
    got, blocks = refine_lists_model(*args, run, tile_blocks, order_seed)
    want = T.refine_lists_plain(*args)
    assert torch.equal(got, want)
    assert want[0].any() and not want[2].any() and not want[4].any()
    assert 0 < int(want[1].sum()) < int(cnt[1])
    # The long list is spread over the tile's blocks, as evenly as runs
    # allow; each block tests at most its share.
    per_block = [swept for tile, swept, _ in blocks if tile == 0]
    share = -(-width // (run * tile_blocks)) * run
    assert len(per_block) == tile_blocks and sum(per_block) == width
    assert max(per_block) <= share
    # A tile with no listed position reads no ray (its blocks test none);
    # a dead tile's warps test nothing.
    assert all(swept == 0 for tile, swept, _ in blocks if tile == 4)
    assert not any(work for tile, _, work in blocks if tile == 2)


def test_gathered_count_above_width(accel):
    """cnt > W: every position is listed, none past the width is touched."""
    rays8, ids, cnt = _imbalance(accel, width_cut=40)
    assert int(cnt[3]) > ids.shape[1] and int(cnt[0]) > ids.shape[1]
    args = (rays8, ids, cnt, accel.cluster_min, accel.cluster_max)
    for run, tile_blocks in ((16, 2), (64, 1)):
        got, _ = refine_lists_model(*args, run, tile_blocks)
        assert torch.equal(got, T.refine_lists_plain(*args))


def test_gathered_zero_counts_write_zeros(accel):
    """cnt 0 everywhere: every bit is written 0 and no block reads rays; a
    negative count reads as 0."""
    rays8 = _pack()
    ids, cnt = _lists(rays8, accel)
    cnt = torch.zeros_like(cnt)
    cnt[1] = -3
    args = (rays8, ids, cnt, accel.cluster_min, accel.cluster_max)
    got, blocks = refine_lists_model(*args, 16, 3)
    assert not got.any() and torch.equal(got, T.refine_lists_plain(*args))
    assert all(swept == 0 and not work for _, swept, work in blocks)


def test_warps_test_only_what_they_must(accel):
    """Every warp that holds an alive lane tests a candidate no lane
    enters; a warp without one tests nothing (5 alive lanes: at most 5
    warps work); a warp that comes to a candidate another has marked
    skips it."""
    rays8, ids, cnt = _imbalance(accel)
    args = (rays8, ids, cnt, accel.cluster_min, accel.cluster_max)
    _, blocks = refine_lists_model(*args, 64, 4, order_seed=7)
    alive = (rays8[7] != 0).reshape(-1, WARPS, PER_THREAD, 32)
    holders = alive.any(dim=3).any(dim=2).sum(dim=1)  # warps with a lane
    skipped = 0
    for tile, _, work in blocks:
        tested = {}
        for w, j, outcome in work:
            tested.setdefault(j, []).append(outcome)
        for outcomes in tested.values():
            if "entered" not in outcomes:
                assert outcomes == ["rejected"] * int(holders[tile])
            skipped += outcomes.count("skip")
        warps = {w for w, _, _ in work}
        assert len(warps) <= int(holders[tile])
    assert int(holders[1]) <= 5 and skipped > 0


@pytest.mark.parametrize("order_seed", [0, 1])
@pytest.mark.parametrize("flags", [False, True], ids=["own-extents",
                                                      "flags-given"])
def test_dense_model_equals_plain(accel, order_seed, flags):
    """The dense form over a table of 100 clusters (CS 128) on the same
    tiles: extents equal to `tile_extents_plain`, bits to
    `refine_dense_plain` with the tile-alive flags from those extents or
    given (tile 4 flagged dead though it has alive lanes)."""
    acc = build_cluster_accel(build_default_scene(device="cpu").mesh,
                              cluster_size=128)
    rays8 = _pack()
    given = torch.tensor([True, True, False, True, False]) if flags else None
    (lo, hi), got, blocks = refine_dense_model(
        rays8, acc.cluster_min, acc.cluster_max, given, order_seed)
    plo, phi = T.tile_extents_plain(rays8)
    assert torch.equal(lo, plo) and torch.equal(hi, phi)
    alive = given if flags else phi[:, 7] > 0.0
    want = T.refine_dense_plain(rays8, acc.cluster_min, acc.cluster_max,
                                alive)
    assert torch.equal(got, want)
    assert want[0].any() and want[3].any() and not want[2].any()
    assert bool(want[4].any()) != flags
    assert not blocks[2]  # a dead tile tests nothing
    if not flags:  # the fused query's plain version is this composition
        flo, fhi, fent = T.refine_dense_extents(rays8, acc.cluster_min,
                                                acc.cluster_max)
        assert torch.equal(flo, plo) and torch.equal(fhi, phi)
        assert torch.equal(fent, want)


@pytest.mark.parametrize("ray_tile,order_seed", [(256, 0), (256, 1),
                                                  (128, 2)])
def test_models_at_a_smaller_tile_equal_plain(accel, ray_tile, order_seed):
    """Both forms at a tile of 256 or 128 rays (a block of 64 or 32
    threads: 2 warps or 1, each still 128 lanes): the gathered form over
    the tiles' own narrowed frustum lists at the production grid, the
    dense form over the CS 128 table (its extents reduced over the
    block's warps, its tile-alive flag from them); bits and extents
    `torch.equal` to the plain versions at that tile. The pack's 5 tiles
    of 1,024 become 20 (or 40): the tile of 5 alive lanes spreads them
    over up to 4 tiles, the dead tile stays dead."""
    rays8 = _pack()
    cmin, cmax = accel.cluster_min, accel.cluster_max
    ids, _, cnt = T._narrow_lists(*T._tile_visit_lists_soa(
        rays8, cmin, cmax, ray_tile=ray_tile))
    nt, width = ids.shape
    assert nt == rays8.shape[1] // ray_tile
    run, tile_blocks = T._refine_grid(nt, width)
    got, blocks = refine_lists_model(rays8, ids, cnt, cmin, cmax, run,
                                     tile_blocks, order_seed, ray_tile)
    want = T.refine_lists_plain(rays8, ids, cnt, cmin, cmax,
                                ray_tile=ray_tile)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < int(cnt.sum())
    dead = slice(2 * TILE // ray_tile, 3 * TILE // ray_tile)
    assert not want[dead].any() and not any(
        work for tile, _, work in blocks if dead.start <= tile < dead.stop)
    acc = build_cluster_accel(build_default_scene(device="cpu").mesh,
                              cluster_size=128)
    (lo, hi), dense, _ = refine_dense_model(
        rays8, acc.cluster_min, acc.cluster_max, None, order_seed, ray_tile)
    plo, phi = T.tile_extents_plain(rays8, ray_tile)
    assert torch.equal(lo, plo) and torch.equal(hi, phi)
    assert torch.equal(dense, T.refine_dense_plain(
        rays8, acc.cluster_min, acc.cluster_max, phi[:, 7] > 0.0,
        ray_tile=ray_tile))
    flo, fhi, fent = T.refine_dense_extents(rays8, acc.cluster_min,
                                            acc.cluster_max,
                                            ray_tile=ray_tile)
    assert torch.equal(flo, plo) and torch.equal(fhi, phi)
    assert torch.equal(fent, dense) and not dense[dead].any()


def test_grazing_ray_enters_through_the_inflation():
    """A ray that misses a box by less than the inflation 2e-6*|t| + 1e-7
    enters it, in the model and the plain versions, and only through the
    inflation: without it the interval is empty."""
    box_min = torch.tensor([[0.0, 0.0, 0.0], [5.0, 0.0, 0.0]])
    box_max = torch.tensor([[1.0, 1.0, 1.0], [6.0, 1.0, 1.0]])
    p = torch.zeros((8, TILE))
    p[3] = 1.0
    # Lane 100 alive: x enters at t = 1 + 3e-6, y leaves at t = 1.
    p[0:3, 100] = torch.tensor([-1.0 - 3e-6, 0.0, 0.5])
    p[4:7, 100] = torch.tensor([1.0, 1.0, 0.0])
    p[7, 100] = 1.0
    o, d = p[0:3, 100], p[4:7, 100]
    t1, t2 = (box_min[0] - o) / d, (box_max[0] - o) / d
    tn = torch.minimum(t1, t2)[:2].max()
    tf = torch.maximum(t1, t2)[:2].min()
    assert float(tn) > float(tf)  # empty without the inflation
    ids = torch.tensor([[0, 1]], dtype=torch.int32)
    cnt = torch.tensor([2])
    args = (p, ids, cnt, box_min, box_max)
    want = T.refine_lists_plain(*args)
    assert want.tolist() == [[True, False]]
    got, _ = refine_lists_model(*args, 1, 2)
    assert torch.equal(got, want)
    _, dense, _ = refine_dense_model(p, box_min, box_max)
    assert dense.tolist() == [[True, False]]
    assert torch.equal(dense, T.refine_dense_plain(p, box_min, box_max,
                                                   torch.tensor([True])))


def test_refine_grid():
    """Runs of `_REFINE_RUN` positions, at most `_MAX_REFINE_BLOCKS` blocks
    a tile, fewer for narrow lists; the grid limit is refused."""
    run, cap = T._REFINE_RUN, T._MAX_REFINE_BLOCKS
    assert T._refine_grid(704, 1) == (run, 1)
    assert T._refine_grid(704, run * 2) == (run, 2)
    assert T._refine_grid(704, 12640) == (run, cap)
    with pytest.raises(ValueError, match="refine_lists"):
        T._refine_grid(2 ** 31 // cap + 1, 10 ** 6)


def test_fused_query_plain_matches_jax():
    """The fused dense query's plain version against JAX's K6 and K5 in
    interpret mode, on a bounce-like pack over the CS 128 table."""
    rng = np.random.default_rng(5)
    p = np.ascontiguousarray(_rays(rng, 2 * TILE), dtype=np.float32)
    p[7, TILE:] = 0.0
    js = jax_scene(t=0.0)
    j_acc = jax_build(js.mesh, cluster_size=128)
    acc = build_cluster_accel(build_default_scene(device="cpu").mesh,
                              cluster_size=128)
    jp = jnp.asarray(p)
    jlo, jhi = JT._tile_extents_pallas(jp, TILE, interpret=True)
    je = JT._refine_dense(jp, j_acc.cluster_min, j_acc.cluster_max, TILE,
                          interpret=True, tile_alive=jhi[:, 7] > 0.0)
    lo, hi, ent = T.refine_dense_extents(torch.from_numpy(p),
                                         acc.cluster_min, acc.cluster_max)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(ent.numpy(), np.asarray(je))
    assert ent[0].any() and not ent[1].any()
