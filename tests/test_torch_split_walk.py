"""The pack walk's split design (csrc/walk.cu), made executable on the CPU.

The kernel gives a tile's visit list to several blocks ("segments"), which
run in any order and at the same time, merge per ray through one packed
(bits(t) << 32) | slot key with a minimum, and keep the front-to-back early
exit by voting on the hits the other segments have published so far. The
claim is that the result is `walk_plain`'s, bit for bit, whatever the order
and whatever a segment happens to see. `split_walk` below is that design in
plain PyTorch: every segment is a coroutine that advances one stage at a
time, a seeded scheduler picks which one runs next, and keys are int64.

Bars: t, slot and attributes (nearest), t and flag (occlusion, under a
scalar t_max and a per-ray row) `torch.equal` to `walk_plain` on every lane
of every alive tile — no tolerance: the merge and the exit are exact. Plus
the Python the wrapper gained: segment sizes, the grid limit, the key
scratch and the 16-byte alignment check of the tables.
"""

import numpy as np
import pytest
import torch

import raytracing_tpu_torch.kernels.traverse as T
from raytracing_tpu_torch import build_cluster_accel, build_default_scene

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


def _segment(tile, j0, seg, stage, ee_batch, args, tnear, bbox, keys, occ_t,
             split, visits):
    """One block of the split walk as a coroutine: it yields wherever
    another block may run in between (after its first read of the keys and
    after every stage)."""
    rays8, ids, cnt, geo, _, _, cs, eps, nearest, t_max, pmto, tmax_row = args
    lanes = slice(tile * TILE, (tile + 1) * TILE)
    rays = rays8[:, lanes].contiguous()
    row = None if tmax_row is None else tmax_row[:, lanes].contiguous()
    alive = rays[7] != 0
    trips = min(seg, min(int(cnt[tile]), ids.shape[1]) - j0)
    use_exit = tnear is not None and nearest
    best_t = torch.full((1, TILE), INF)
    best_s = torch.full((1, TILE), T._BIG_ID, dtype=torch.int32)

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
        return bool((~alive | (reach < tnear[tile, j0 + pos])).all())

    share()
    yield
    exit_t = _scene_exit(rays[0:3], rays[4:7], bbox) if use_exit else None
    done = voted = 0
    if not (use_exit and trips > 0 and settled(0)):
        while done < trips:
            nin = min(stage, trips - done)
            t, s, _ = T.walk_plain(
                rays, ids[tile:tile + 1, j0 + done:j0 + done + nin],
                torch.tensor([nin]), geo, None, 0, cs, eps, nearest, t_max,
                pmto, row)
            if nearest:
                best_t, best_s = T._merge_nearest(best_t, best_s, t, s)
            else:
                best_t = torch.minimum(best_t, t)
            done += nin
            yield
            if use_exit and done < trips and done - voted >= ee_batch:
                voted = done
                share()
                if settled(done):
                    break
    visits[tile] += done
    if nearest:
        keys[lanes] = torch.minimum(keys[lanes], _pack_key(best_t[0],
                                                           best_s[0]))
    else:
        occ_t[lanes] = torch.minimum(occ_t[lanes], best_t[0])


def split_walk(args, seg, stage, order_seed, tnear=None, bbox=None,
               ee_batch=1):
    """The split walk over `walk_plain`'s arguments: every tile's list in
    segments of `seg` visits, walked `stage` visits at a time, the
    segments interleaved by a scheduler seeded with `order_seed`. Returns
    (t, slot or flag, attrs | None, visits per tile)."""
    rays8, ids, cnt, _, attr, n_attrs, cs, _, nearest = args[:9]
    n = rays8.shape[1]
    nt = n // TILE
    keys = torch.full((n,), EMPTY_KEY, dtype=torch.int64)
    occ_t = torch.full((n,), INF)
    visits = [0] * nt
    running = []
    for tile in range(nt):
        listed = min(int(cnt[tile]), ids.shape[1])
        starts = range(0, max(listed, 1), seg)
        running += [_segment(tile, j0, seg, stage, ee_batch, args, tnear,
                             bbox, keys, occ_t, len(starts) > 1, visits)
                    for j0 in starts]
    rng = np.random.default_rng(order_seed)
    while running:
        k = int(rng.integers(len(running)))
        try:
            next(running[k])
        except StopIteration:
            running.pop(k)
    if not nearest:
        return occ_t[None], (occ_t[None] < INF).to(torch.int32), None, visits
    t, s = _unpack_key(keys)
    return (t[None], s[None], T._winner_attrs(attr, s[None], n_attrs, cs),
            visits)


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


@pytest.mark.parametrize("order_seed", [0, 1])
@pytest.mark.parametrize("early", [False, True], ids=["noexit", "exit"])
@pytest.mark.parametrize("cs", [16, 128])
def test_split_nearest_equals_plain(accels, cs, early, order_seed):
    """Nearest with attributes over the frustum lists (the K1 entry's), in
    segments of a few stages: the CS 16 lists are ~200 long, the CS 128
    ones ~30."""
    acc = accels[cs]
    rp = _pack(5 + order_seed)
    na = acc.attr_blocks.shape[1]
    args, kw = T._groups_walk_args(acc, rp, EPS, True, INF, na,
                                   early_exit=early)
    assert (kw["tnear"] is not None) == early
    stage = 128 // cs
    seg = 4 * stage
    assert int(args[2].max()) > 2 * seg  # several segments per tile
    want = T.walk_plain(*args)
    got = split_walk(args, seg, stage, order_seed, kw["tnear"], kw["bbox"],
                     kw["ee_batch"])
    alive = rp[7] != 0
    hits = int(torch.isfinite(want[0][0][alive]).sum())
    assert 300 < hits < int(alive.sum())
    # With the exit a dead lane does not vote, so its result may differ.
    _equal(got, want, alive if early else _alive_tiles(rp))
    listed = [min(int(c), args[1].shape[1]) for c in args[2]]
    if early:
        assert all(v <= c for v, c in zip(got[3], listed))
        assert sum(got[3]) < sum(listed)  # the exit skipped something
    else:
        assert got[3] == listed
    # The dead tile reads miss, attributes 0.
    dead = slice(2 * TILE, 3 * TILE)
    assert listed[2] == 0 and bool(torch.isinf(got[0][0, dead]).all())
    assert bool((got[1][0, dead] == T._BIG_ID).all())
    assert not bool(got[2][:, dead].any())


@pytest.mark.parametrize("per_ray", [False, True], ids=["scalar", "tmax_row"])
@pytest.mark.parametrize("cs", [16, 128])
def test_split_occlusion_equals_plain(accels, cs, per_ray):
    """Occlusion keeps min t under the limit (not just a flag), merged as
    a 32-bit minimum of bits(t); never an exit. +inf limits arrive as 3e38
    and some are 0 (a padded lane)."""
    acc = accels[cs]
    rp = _pack(9)
    row = None
    if per_ray:
        row = torch.linspace(0.5, 30.0, rp.shape[1])
        row[::7] = 3e38
        row[3::11] = 0.0
        row = row[None].contiguous()
    args, kw = T._groups_walk_args(acc, rp, EPS, False, 6.0, 0, tmax_row=row)
    assert kw["tnear"] is None
    stage = 128 // cs
    want = T.walk_plain(*args)
    got = split_walk(args, 2 * stage, stage, 3)
    m = _alive_tiles(rp)
    assert 100 < int(want[1][0][m].sum()) < int(m.sum())
    _equal(got, want, m)
    # the merged bits order as the floats do
    t = want[0][0][torch.isfinite(want[0][0])]
    order = torch.argsort(t)
    assert bool((t.view(torch.int32)[order].diff() >= 0).all())
    dead = slice(2 * TILE, 3 * TILE)
    assert not bool(got[1][0, dead].any())


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
    got = split_walk(args, 1, 1, order_seed,
                     tnear2 if early else None, kw["bbox"] if early else None)
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
