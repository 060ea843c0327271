"""The split design of the walks (csrc/walk.cu, camera.cu, gstream.cu),
made executable on the CPU.

The kernels give a tile's visit list to several blocks ("segments"), which
run in any order and at the same time, merge per ray through one packed
(bits(t) << 32) | slot key with a minimum, and keep the front-to-back early
exit by voting on the hits the other segments have published so far. The
claim is that the result is the plain version's, bit for bit, whatever the
order and whatever a segment happens to see. `split_walk` below is that
design in plain PyTorch: every block is a coroutine that advances one stage
at a time, a seeded scheduler picks which one runs next, and keys are
int64. A unit of rays is a pack tile (K1/K2), a pass of up to 1,024 camera
rays derived as the camera kernel derives them, or a pack tile with one
list per group of the table (K3: ids local to the group, slots offset by
the group's first slot, each group's entry bounds and union box for the
exit); every list of a unit is dealt to at most `tile_blocks` blocks, and
all the unit's blocks share one set of keys.

Bars: t, slot and attributes (nearest), t and flag (occlusion, under a
scalar t_max and a per-ray row) `torch.equal` to `walk_plain`,
`walk_camera_plain` or `walk_gstream_plain` on every lane of every alive
tile — no tolerance: the merge and the exit are exact. Plus the Python the
wrappers gained: segment sizes, the grid limit, the key scratch and the
16-byte alignment check of the tables.
"""

from typing import List, NamedTuple, Optional

import numpy as np
import pytest
import torch

import raytracing_tpu_torch.kernels.traverse as T
from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                  build_default_scene)
from raytracing_tpu_torch.ops.sampling import stratified_offsets

torch.set_num_threads(2)

INF = float("inf")
EPS = 1e-8
TILE = T.RAY_TILE
EMPTY_KEY = (0x7F800000 << 32) | T._BIG_ID


@pytest.fixture(scope="module")
def accels():
    scene = build_default_scene(device="cpu")
    return {cs: build_cluster_accel(scene.mesh, cluster_size=cs)
            for cs in (16, 128)}


def _pack(seed):
    """Three tiles: a narrow fan from the left through both teapots in a
    row (every ray hits the first, so the exit has the second to skip),
    incoherent rays among the teapots (one lane in ten dead), and a tile
    with no alive lane (no visits)."""
    rng = np.random.default_rng(seed)
    d1 = np.concatenate([np.ones((TILE, 1)),
                         rng.uniform(-0.03, 0.03, (TILE, 2))], axis=1)
    o1 = np.tile(np.array([-9.0, -0.5, 7.5]), (TILE, 1))
    o2 = rng.uniform(-3, 3, (2 * TILE, 3))
    o2[:, 2] += 7.0
    d2 = rng.normal(size=(2 * TILE, 3))
    o = np.concatenate([o1, o2])
    d = np.concatenate([d1, d2])
    alive = rng.uniform(size=3 * TILE) > 0.1
    alive[2 * TILE:] = False
    p = np.concatenate([o.T, np.ones((1, 3 * TILE)), d.T,
                        alive[None].astype(np.float64)])
    return torch.from_numpy(np.ascontiguousarray(p, dtype=np.float32))


def _pack_key(t, s):
    return (t.view(torch.int32).to(torch.int64) << 32) | s.to(torch.int64)


def _unpack_key(key):
    return ((key >> 32).to(torch.int32).view(torch.float32),
            (key & 0xFFFFFFFF).to(torch.int32))


def _scene_exit(o, d, bbox):
    """walk_core.cuh's scene_exit: the rays' exit from the union box,
    inflated a few ulp; -inf for a ray that misses it."""
    tiny = torch.tensor(1e-20, dtype=torch.float32)
    deg = d.abs() < tiny
    dk = torch.where(deg, tiny, d)
    t1 = (bbox[:3, None] - o) / dk
    t2 = (bbox[3:, None] - o) / dk
    lo = torch.where(deg, -INF, torch.minimum(t1, t2)).amax(dim=0)
    hi = torch.where(deg, INF, torch.maximum(t1, t2)).amin(dim=0)
    exit_t = hi * torch.tensor(1.0 + 1e-5, dtype=torch.float32) \
        + torch.tensor(1e-6, dtype=torch.float32)
    return torch.where((lo <= exit_t) & (exit_t >= 0.0), exit_t, -INF)


class WalkList(NamedTuple):
    """One list a unit's blocks walk: ids [W] (local to `geo`), the
    positions listed, entry bounds [W] and union box [6] (exit only), the
    table, the slot of its first triangle, and where its visits count."""

    ids: torch.Tensor
    listed: int
    tnear: Optional[torch.Tensor]
    bbox: Optional[torch.Tensor]
    geo: torch.Tensor
    slot_base: int
    visits_at: object


class Unit(NamedTuple):
    """Rays one set of keys serves: a pack [8, L] whose lanes are output
    lanes [start, start + L), their per-ray limits [1, L] or None, and the
    lists walked for them."""

    rays: torch.Tensor
    start: int
    row: Optional[torch.Tensor]
    lists: List[WalkList]


class Query(NamedTuple):
    nearest: bool
    t_max: float
    pmto: bool
    cs: int
    eps: float
    ee_batch: int


def _block(unit, wl, parts, seg, stage, q, keys, occ_t, split, visits):
    """One block as a coroutine: segments `parts` of list `wl`, walked
    `stage` visits at a time; it yields wherever another block may run in
    between (after each read of the keys and after every stage). A segment
    that settles ends the block: the rest of its list lies farther."""
    lanes = slice(unit.start, unit.start + unit.rays.shape[1])
    rays = unit.rays
    alive = rays[7] != 0
    use_exit = wl.tnear is not None and q.nearest
    best_t = torch.full((1, rays.shape[1]), INF)
    best_s = torch.full((1, rays.shape[1]), T._BIG_ID, dtype=torch.int32)
    exit_t = _scene_exit(rays[0:3], rays[4:7], wl.bbox) if use_exit else None

    def share():  # publish what this block holds, fold the rest in
        nonlocal best_t, best_s
        if not (split and use_exit):
            return
        keys[lanes] = torch.minimum(keys[lanes], _pack_key(best_t[0],
                                                           best_s[0]))
        t, s = _unpack_key(keys[lanes])
        best_t, best_s = t[None].clone(), s[None].clone()

    def settled(pos):
        reach = torch.minimum(best_t[0], exit_t)
        return bool((~alive | (reach < wl.tnear[pos])).all())

    for part in parts:
        j0 = part * seg
        trips = min(seg, wl.listed - j0)
        share()
        yield
        done = voted = 0
        if not (use_exit and trips > 0 and settled(j0)):
            while done < trips:
                nin = min(stage, trips - done)
                j = j0 + done
                t, s, _ = T.walk_plain(
                    rays, wl.ids[None, j:j + nin], torch.tensor([nin]),
                    wl.geo, None, 0, q.cs, q.eps, q.nearest, q.t_max, q.pmto,
                    unit.row, ray_tile=rays.shape[1])
                if q.nearest:
                    s = torch.where(s != T._BIG_ID, s + wl.slot_base, s)
                    best_t, best_s = T._merge_nearest(best_t, best_s, t, s)
                else:
                    best_t = torch.minimum(best_t, t)
                done += nin
                yield
                if use_exit and done < trips and done - voted >= q.ee_batch:
                    voted = done
                    share()
                    if settled(j0 + done):
                        break
        visits[wl.visits_at] += done
        if done < trips:
            break
    if q.nearest:
        keys[lanes] = torch.minimum(keys[lanes], _pack_key(best_t[0],
                                                           best_s[0]))
    else:
        occ_t[lanes] = torch.minimum(occ_t[lanes], best_t[0])


def split_walk(units, n, q, seg, stage, order_seed, attr=None, n_attrs=0,
               tile_blocks=None):
    """The split walk of `units` (n output lanes): every list in segments
    of `seg` visits, dealt to at most `tile_blocks` blocks (one block per
    segment by default); a unit that lists nothing runs one empty block of
    its first list; the blocks interleaved by a scheduler seeded with
    `order_seed`. Returns (t, slot or flag, attrs | None, visits)."""
    keys = torch.full((n,), EMPTY_KEY, dtype=torch.int64)
    occ_t = torch.full((n,), INF)
    visits = {}
    running = []
    for unit in units:
        blocks = []
        for wl in unit.lists:
            visits.setdefault(wl.visits_at, 0)
            n_parts = -(-wl.listed // seg)
            cap = n_parts if tile_blocks is None else tile_blocks
            blocks += [(wl, range(b, n_parts, cap))
                       for b in range(min(n_parts, cap))]
        if not blocks:
            blocks = [(unit.lists[0], range(1))]
        running += [_block(unit, wl, parts, seg, stage, q, keys, occ_t,
                           len(blocks) > 1, visits) for wl, parts in blocks]
    rng = np.random.default_rng(order_seed)
    while running:
        k = int(rng.integers(len(running)))
        try:
            next(running[k])
        except StopIteration:
            running.pop(k)
    if not q.nearest:
        return occ_t[None], (occ_t[None] < INF).to(torch.int32), None, visits
    t, s = _unpack_key(keys)
    return (t[None], s[None], T._winner_attrs(attr, s[None], n_attrs, q.cs),
            visits)


def _pack_units(args, kw):
    """The K1/K2 launch `walk(*args, **kw)` as units: one per tile."""
    rays8, ids, cnt, geo, _, _, cs, eps, nearest, t_max, pmto, row = args
    early = kw.get("tnear") is not None and nearest
    units = []
    for tile in range(rays8.shape[1] // TILE):
        lanes = slice(tile * TILE, (tile + 1) * TILE)
        units.append(Unit(rays8[:, lanes].contiguous(), tile * TILE,
                          None if row is None else row[:, lanes].contiguous(),
                          [WalkList(ids[tile], min(int(cnt[tile]),
                                                   ids.shape[1]),
                                    kw["tnear"][tile] if early else None,
                                    kw["bbox"] if early else None, geo, 0,
                                    tile)]))
    return units, Query(nearest, t_max, pmto, cs, eps, kw.get("ee_batch", 1))


def _camera_units(args, kw):
    """The camera launch `walk_camera(*args, **kw)` as units: one per
    (tile, pass of up to 1,024 lanes), its rays derived as the kernel
    derives them (origin 0, every lane alive), each pass walking the
    tile's whole list."""
    offs, cam, tile0, n_tiles, ids, cnt, geo, _, _, cs, eps = args
    early = kw.get("tnear") is not None
    rt = cam.ray_tile
    dx, dy, dz = T._camera_dir_rows(n_tiles * rt, offs, cam, tile0 * rt)
    zero, one = torch.zeros_like(dx), torch.ones_like(dx)
    rays8 = torch.cat([zero, zero, zero, one, dx, dy, dz, one])
    units = []
    for tile in range(n_tiles):
        for base in range(0, rt, TILE):
            lanes = slice(tile * rt + base, tile * rt + min(rt, base + TILE))
            units.append(Unit(rays8[:, lanes].contiguous(), lanes.start,
                              None,
                              [WalkList(ids[tile], min(int(cnt[tile]),
                                                       ids.shape[1]),
                                        kw["tnear"][tile] if early else None,
                                        kw["bbox"], geo, 0, tile)]))
    return units, Query(True, INF, True, cs, eps, kw.get("ee_batch", 1))


def _group_units(args, kw):
    """The K3 launch `walk_gstream(*args, **kw)` as units: one per tile,
    with one list per group."""
    (rays8, ids, cnt, geo, _, _, cs, gsz, eps, nearest, t_max, pmto,
     row) = args
    early = kw.get("tnear") is not None and nearest
    units = []
    for tile in range(rays8.shape[1] // TILE):
        lanes = slice(tile * TILE, (tile + 1) * TILE)
        lists = [WalkList(ids[g, tile], min(int(cnt[g, tile]), ids.shape[2]),
                          kw["tnear"][g, tile] if early else None,
                          kw["bbox"][g] if early else None,
                          geo[g * gsz:(g + 1) * gsz], g * gsz * cs,
                          (g, tile))
                 for g in range(ids.shape[0])]
        units.append(Unit(rays8[:, lanes].contiguous(), tile * TILE,
                          None if row is None else row[:, lanes].contiguous(),
                          lists))
    return units, Query(nearest, t_max, pmto, cs, eps, kw.get("ee_batch", 1))


def _alive_tiles(rays8):
    """Lanes of tiles with an alive lane: a dead tile lists nothing, and a
    dead lane of an alive tile is walked like any other (without the exit
    its result is `walk_plain`'s too)."""
    return (rays8[7].reshape(-1, TILE) != 0).any(dim=1) \
        .repeat_interleave(TILE)


def _equal(got, want, m):
    for g, w in zip(got[:3], want):
        if w is not None:
            assert torch.equal(g[..., m], w[..., m])


def _four_groups(monkeypatch):
    """K3's lists over 4 groups: 256 clusters of 16 (790 in the table), 32
    of 128 (100)."""
    monkeypatch.setattr(T, "_group_clusters",
                        lambda accel, n_attrs: 256 if accel.cluster_size == 16
                        else 32)


def _launch(walk, acc, monkeypatch, nearest, early=None, seed=5, row=None,
            t_max=INF):
    """(units, query, the plain version's result, attribute table, lanes
    to compare, visits listed per key, dead lanes or None) of one launch:
    `pack` the K1 entry's frustum lists over `_pack(seed)`, `groups` K3's
    over the same rays in 4 groups, `camera` the camera walk over 4 tiles
    of 1,024 rays across the teapots (blocks 27-30 of a 128x96x4 frame)."""
    na = acc.attr_blocks.shape[1] if nearest else 0
    if walk == "camera":
        cam = T.Camera(128, 96, 4, RenderConfig().scale, 16, 16)
        args, kw = T._camera_walk_args(acc, stratified_offsets(4), cam, 27,
                                       4, na, EPS, early_exit=early)
        units, q = _camera_units(args, kw)
        listed = {k: min(int(c), args[4].shape[1])
                  for k, c in enumerate(args[5])}
        every = torch.ones(4 * TILE, dtype=torch.bool)
        return (units, q, T.walk_camera_plain(*args), args[7], every, listed,
                None)
    rp = _pack(seed)
    if row is not None:
        row = row[:, :rp.shape[1]].contiguous()
    if walk == "pack":
        args, kw = T._groups_walk_args(acc, rp, EPS, nearest, t_max, na,
                                       early_exit=early, tmax_row=row)
        units, q = _pack_units(args, kw)
        want = T.walk_plain(*args)
    else:
        _four_groups(monkeypatch)
        args, kw = T._gstream_walk_args(acc, rp, EPS, nearest, t_max, na,
                                        early_exit=early, tmax_row=row)
        assert args[1].shape[0] == 4
        units, q = _group_units(args, kw)
        want = T.walk_gstream_plain(*args)
    assert (kw["tnear"] is not None) == bool(early and nearest)
    listed = {wl.visits_at: wl.listed for u in units for wl in u.lists}
    # With the exit a dead lane does not vote, so its result may differ.
    cmp = rp[7] != 0 if early else _alive_tiles(rp)
    return (units, q, want, args[4], cmp, listed,
            slice(2 * TILE, 3 * TILE))


def _case_ids(*params):
    """Test ids: the pack walk's as they always were, the others prefixed
    with the walk."""
    walk, *rest = params
    return "-".join(([] if walk == "pack" else [walk])
                    + [{False: "noexit", True: "exit"}.get(x, str(x))
                       if isinstance(x, bool) else str(x) for x in rest])


NEAREST_CASES = [(w, cs, e, seed) for w in ("pack", "camera", "groups")
                 for cs in (16, 128) for e in (False, True) for seed in (0, 1)]


@pytest.mark.parametrize("walk,cs,early,order_seed", NEAREST_CASES,
                         ids=[_case_ids(*c) for c in NEAREST_CASES])
def test_split_nearest_equals_plain(accels, monkeypatch, walk, cs, early,
                                    order_seed):
    """Nearest with attributes, in segments of a few stages: over the K1
    entry's frustum lists (CS 16 ~200 long, CS 128 ~30), the camera walk's
    and K3's. Order seed 1 also deals each list to at most 2 blocks, so a
    block walks several segments and leaves its list where one settles."""
    acc = accels[cs]
    units, q, want, attr, cmp, listed, dead = _launch(
        walk, acc, monkeypatch, True, early, 5 + order_seed)
    stage = 128 // cs
    seg = 4 * stage
    assert max(listed.values()) > 2 * seg  # several segments per list
    got = split_walk(units, want[0].shape[1], q, seg, stage, order_seed,
                     attr, acc.attr_blocks.shape[1],
                     tile_blocks=2 if order_seed else None)
    hits = int(torch.isfinite(want[0][0][cmp]).sum())
    assert 300 < hits < int(cmp.sum())
    _equal(got, want, cmp)
    made = got[3]
    if early:
        assert all(made[k] <= c for k, c in listed.items())
        assert sum(made.values()) < sum(listed.values())  # skipped some
    else:
        assert made == listed
    if walk == "groups" and early:
        # A group whose nearest entry lies beyond a hit found in another
        # group is skipped by its first vote, on the keys alone.
        assert any(made[k] == 0 < c for k, c in listed.items())
    if dead is not None:  # the dead tile reads miss, attributes 0
        assert not any(c for k, c in listed.items()
                       if (k if isinstance(k, int) else k[1]) == 2)
        assert bool(torch.isinf(got[0][0, dead]).all())
        assert bool((got[1][0, dead] == T._BIG_ID).all())
        assert not bool(got[2][:, dead].any())


OCCLUSION_CASES = [(w, cs, r) for w in ("pack", "groups") for cs in (16, 128)
                   for r in ("scalar", "tmax_row")]


@pytest.mark.parametrize("walk,cs,per_ray", OCCLUSION_CASES,
                         ids=[_case_ids(*c) for c in OCCLUSION_CASES])
def test_split_occlusion_equals_plain(accels, monkeypatch, walk, cs, per_ray):
    """Occlusion keeps min t under the limit (not just a flag), merged as
    a 32-bit minimum of bits(t); never an exit. +inf limits arrive as 3e38
    and some are 0 (a padded lane)."""
    acc = accels[cs]
    row = None
    if per_ray == "tmax_row":
        row = torch.linspace(0.5, 30.0, 3 * TILE)
        row[::7] = 3e38
        row[3::11] = 0.0
        row = row[None].contiguous()
    units, q, want, _, m, _, dead = _launch(walk, acc, monkeypatch, False,
                                            seed=9, row=row, t_max=6.0)
    stage = 128 // cs
    got = split_walk(units, want[0].shape[1], q, 2 * stage, stage, 3)
    assert 100 < int(want[1][0][m].sum()) < int(m.sum())
    _equal(got, want, m)
    # the merged bits order as the floats do
    t = want[0][0][torch.isfinite(want[0][0])]
    order = torch.argsort(t)
    assert bool((t.view(torch.int32)[order].diff() >= 0).all())
    assert not bool(got[1][0, dead].any())


@pytest.mark.parametrize("chunk", [False, True], ids=["frame", "overrun"])
@pytest.mark.parametrize("shape", [(64, 48, 1), (32, 32, 4), (32, 32, 8)],
                         ids=["rt256", "rt1024", "rt2048"])
def test_split_camera_passes_and_chunks(accels, shape, chunk):
    """The camera walk with the exit over tiles of 256 rays (sky tiles
    that list nothing among them), 1,024 and 2,048 (two passes over one
    list), the whole frame and a chunk of 4 tiles from the frame's
    second-last block on (its last two repeat the frame's last block)."""
    acc = accels[16]
    w, h, spp = shape
    cam = T.Camera(w, h, spp, RenderConfig().scale, 16, 16)
    n_tiles = cam.grid[0] * cam.grid[1]
    tile0, tiles = (n_tiles - 2, 4) if chunk else (0, n_tiles)
    args, kw = T._camera_walk_args(acc, stratified_offsets(spp), cam, tile0,
                                   tiles, acc.attr_blocks.shape[1], EPS,
                                   early_exit=True)
    units, q = _camera_units(args, kw)
    assert len(units) == tiles * -(-cam.ray_tile // TILE)
    want = T.walk_camera_plain(*args)
    got = split_walk(units, want[0].shape[1], q, 8, 8, 2, args[7],
                     acc.attr_blocks.shape[1], tile_blocks=3)
    _equal(got, want, torch.ones(want[0].shape[1], dtype=torch.bool))
    cnt = args[5]
    assert int(cnt.max()) > 3 * 8  # a block walks several segments
    passes = -(-cam.ray_tile // TILE)
    assert all(got[3][k] <= passes * int(c) for k, c in enumerate(cnt))
    if chunk:  # the overrun repeats the last block: its lanes, its results
        rt = cam.ray_tile
        for a in want:
            assert torch.equal(a[:, 2 * rt:3 * rt], a[:, 3 * rt:])
    empty = (cnt == 0).repeat_interleave(cam.ray_tile)
    assert bool(empty.any()) == (shape[2] == 1 and not chunk)
    assert bool(torch.isinf(got[0][0, empty]).all())


@pytest.mark.parametrize("early", [False, True], ids=["noexit", "exit"])
@pytest.mark.parametrize("order_seed", [0, 1, 2])
def test_split_tie_takes_the_lower_slot(accels, early, order_seed):
    """Two coplanar triangles: every cluster the fan's tile lists is
    listed twice, the second time as a copy at the table's end (a higher
    slot), each visit a segment of its own. Whichever segment merges first,
    the lower slot wins, as in `walk_plain`."""
    acc = accels[128]
    rp = _pack(5)[:, :TILE].contiguous()
    na = acc.attr_blocks.shape[1]
    (_, ids, cnt, geo, attr, *rest), kw = T._groups_walk_args(
        acc, rp, EPS, True, INF, na, early_exit=True)
    c = geo.shape[0]
    n = int(cnt[0])
    twice = torch.stack([ids[:, :n] + c, ids[:, :n]], dim=2).reshape(1, 2 * n)
    tnear2 = kw["tnear"][:, :n].repeat_interleave(2, dim=1).contiguous()
    args = (rp, twice.contiguous(), cnt * 2, torch.cat([geo, geo]),
            torch.cat([attr, attr]), *rest)
    want = T.walk_plain(*args)
    hit = torch.isfinite(want[0][0])
    assert int(hit.sum()) > 300 and bool((want[1][0][hit] < c * 128).all())
    units, q = _pack_units(args, dict(tnear=tnear2 if early else None,
                                      bbox=kw["bbox"] if early else None))
    got = split_walk(units, TILE, q, 1, 1, order_seed, args[4], na)
    _equal(got, want, rp[7] != 0)


def test_packed_key_orders_as_t_then_slot():
    t = torch.tensor([1e-7, 0.5, 0.5, 2.0, 3e38, INF])
    s = torch.tensor([9, 7, 8, 0, 1, T._BIG_ID], dtype=torch.int32)
    key = _pack_key(t, s)
    assert bool((key.diff() > 0).all()) and int(key[-1]) == EMPTY_KEY
    t2, s2 = _unpack_key(key)
    assert torch.equal(t2, t) and torch.equal(s2, s)


@pytest.mark.parametrize("cs,seg", [(4, 64), (16, 16), (64, 4), (128, 2)])
def test_walk_segment_is_whole_stages_and_vote_batches(cs, seg):
    assert T._walk_segment(cs) == seg
    stage = max(1, 128 // cs)
    assert seg % stage == 0
    assert seg % T._ee_batch_for(cs) == 0 and seg % T._dma_ee_batch(cs) == 0


def test_walk_grid_counts_a_tiles_blocks_and_refuses_too_many():
    assert T._walk_grid("walk", 704, 100, 2) == 50
    assert T._walk_grid("walk", 64, 790, 16, most=64) == 50
    assert T._walk_grid("walk", 2500, 12640, 2, most=64) == 64
    assert T._walk_grid("walk", 2 ** 20, 2047, 1) == 2047
    assert T._walk_grid("walk", 2 ** 20, 10 ** 6, 1, most=2047) == 2047
    with pytest.raises(ValueError, match=r"walk: 1048576 tiles of 2048 "
                       r"listed visits, 1 to a block, make 2147483648 "
                       r"blocks"):
        T._walk_grid("walk", 2 ** 20, 2048, 1)


def test_camera_and_group_grids():
    """The camera walk: passes of up to 1,024 rays, each pass's list split
    in segments of 128 triangles for a launch of few tiles, 512 for one of
    many; K3 likewise, a tile's lists in all groups sharing one cap of
    blocks."""
    assert T._camera_grid(2500, 1024, 353, 128) == (4, 64, 1)
    assert T._camera_grid(2500, 1024, 790, 16) == (32, 25, 1)
    assert T._camera_grid(64, 1024, 790, 16) == (8, 64, 1)
    assert T._camera_grid(600, 2048, 100, 128) == (4, 25, 2)
    assert T._camera_grid(12, 256, 790, 16) == (8, 64, 1)
    assert T._gstream_grid(2500, 4, 4096, 128) == (4, 16)
    assert T._gstream_grid(2500, 13, 4096, 128) == (4, 4)
    assert T._gstream_grid(64, 4, 4096, 128) == (1, 16)
    assert T._gstream_grid(64, 100, 300, 16) == (8, 1)
    with pytest.raises(ValueError, match="walk_gstream"):
        T._gstream_grid(2 ** 30, 2, 4096, 4)


def test_merge_keys_scratch():
    rp = _pack(1)
    keys = T._merge_keys(rp, True)
    assert keys.dtype == torch.int64 and keys.shape == (rp.shape[1],)
    assert keys.data_ptr() % 8 == 0 and keys.is_contiguous()
    assert T._merge_keys(rp, False) is None


@pytest.mark.parametrize("fault", ["cs6", "cs132", "offset", "stride"])
def test_walk_tables_must_be_16_byte_aligned(fault):
    """The kernels stage a cluster's block with 16-byte copies."""
    nt, c = 1, 3
    ids = torch.zeros((nt, c), dtype=torch.int32)
    cnt = torch.zeros(nt, dtype=torch.int64)
    cs = {"cs6": 6, "cs132": 132}.get(fault, 8)
    flat = torch.zeros(16 + c * 13 * cs)
    geo = flat[:c * 12 * cs].view(c, 12, cs)
    if cs == 8:  # the table as it should be passes
        T._check_walk_tables("walk", nt, ids, cnt, geo, None, cs, None, None)
    if fault == "offset":
        geo = flat[1:1 + c * 12 * cs].view(c, 12, cs)
    elif fault == "stride":  # blocks 12 * 8 + 2 floats apart
        geo = flat[:c * 98].view(c, 98)[:, :96].view(c, 12, cs)
    with pytest.raises(ValueError, match="16-byte aligned"):
        T._check_walk_tables("walk", nt, ids, cnt, geo, None, cs, None, None)
