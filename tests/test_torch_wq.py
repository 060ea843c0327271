"""The work division of K4, the work-queue walk (csrc/wq.cu), made
executable on the CPU.

The kernel builds a queue of real work items on the device (an exclusive
scan of ceil(min(cnt, width) / u) over the tiles) and walks it with a
persistent grid: every warp takes `WQ_RUN` consecutive units from a
shared counter, a unit being one item of one 128-lane warp of a tile; it
culls each visit with its own rays (the TPU's lane-cull slab test, voted
over the warp's alive rays), stages the entered clusters into its own two
slots, one copy in flight while the last one is intersected, keeps its
rays' best (t, slot) across its run and merges once a run.

That is modelled here in plain PyTorch: every warp is a coroutine that
yields wherever the card could run another warp in between (after a take,
while a copy lands), and a seeded scheduler picks the next one. Merges are the kernel's order-free ones: a packed (bits(t) << 32) |
slot int64 minimum, or the minimum of t for occlusion.

Bars: t, slot and attributes (nearest, capped), t and flag (occlusion
under a scalar limit and a per-ray row) `torch.equal` to `walk_wq_plain`
on every alive lane — no tolerance: the cull skips only what no alive ray
of the warp enters, and the merges do not depend on the order. A dead
lane's result is meaningless, as in K1/K2; a warp with no alive ray culls
every visit and its lanes read miss.
"""

import numpy as np
import pytest
import torch

import raytracing_tpu_torch.kernels.traverse as T
from raytracing_tpu_torch import build_cluster_accel, build_default_scene

torch.set_num_threads(2)

INF = float("inf")
EPS = 1e-8
LANES = 128  # a warp's share of a tile: 32 threads x 4 rays
EMPTY_KEY = (0x7F800000 << 32) | T._BIG_ID


@pytest.fixture(scope="module")
def accels():
    scene = build_default_scene(device="cpu")
    return {cs: build_cluster_accel(scene.mesh, cluster_size=cs,
                                    variants=("pmt", "mt"))
            for cs in (16, 128)}


def _pack(seed, n):
    """Bounce-like rays among the teapots (one lane in ten dead), and one
    128-lane warp with no alive ray."""
    rng = np.random.default_rng(seed)
    o = np.array([1.0, -1.2, 7.5]) + rng.normal(scale=[2.0, 0.6, 1.5],
                                                size=(n, 3))
    d = rng.normal(size=(n, 3))
    alive = rng.uniform(size=n) > 0.1
    alive[3 * LANES:4 * LANES] = False
    p = np.concatenate([o.T, np.ones((1, n)), d.T,
                        alive[None].astype(np.float64)])
    return torch.from_numpy(np.ascontiguousarray(p, dtype=np.float32))


def _pack_key(t, s):
    return (t.view(torch.int32).to(torch.int64) << 32) | s.to(torch.int64)


def _unpack_key(key):
    return ((key >> 32).to(torch.int32).view(torch.float32),
            (key & 0xFFFFFFFF).to(torch.int32))


class Launch:
    """One K4 launch `walk_wq(*args, **kw)` as the models see it: the
    lists, the queue, the merge state, and a warp's walk of some clusters
    for its 128 lanes."""

    def __init__(self, args, kw):
        (self.rays, self.ids, self.cnt, self.geo, self.attr, self.n_attrs,
         self.cs, self.eps, self.nearest, self.t_max, self.family,
         self.row) = args
        self.u, self.tile = kw["u"], kw["ray_tile"]
        self.bounds = kw["lane_bounds"]
        self.width = self.ids.shape[1]
        self.first = T.wq_queue_plain(self.cnt, self.width, self.u).tolist()
        self.nt = self.cnt.shape[0]
        self.subtiles = self.tile // LANES
        n = self.rays.shape[1]
        self.keys = torch.full((n,), EMPTY_KEY, dtype=torch.int64)
        self.occ = torch.full((n,), INF)
        self.pack = self.rays.reshape(8, -1, 1, LANES)
        self.merges = 0

    def listed(self, tile):
        return min(int(self.cnt[tile]), self.width)

    def warp_rays(self, base):
        lanes = slice(base, base + LANES)
        row = None if self.row is None else self.row[:, lanes].contiguous()
        return self.rays[:, lanes].contiguous(), row

    def entered(self, base, cl):
        """The warp at lane `base` culls clusters cl: True where it walks
        them (some alive ray of the warp enters the box)."""
        sub = torch.full((len(cl),), base // LANES, dtype=torch.int64)
        enter = T._lane_enters(self.pack, sub, torch.tensor(cl),
                               self.bounds)
        return enter.any(dim=1)

    def walk(self, base, cl, best):
        """Fold the warp's hits on clusters cl into best = (t, slot)."""
        if not cl:
            return best
        rays, row = self.warp_rays(base)
        t, s, _ = T.walk_plain(rays, torch.tensor([cl], dtype=torch.int32),
                               torch.tensor([len(cl)]), self.geo, None, 0,
                               self.cs, self.eps, self.nearest, self.t_max,
                               self.family, row, ray_tile=LANES)
        if self.nearest:
            return T._merge_nearest(best[0], best[1], t, s)
        return torch.minimum(best[0], t), best[1]

    def merge(self, base, best):
        lanes = slice(base, base + LANES)
        self.merges += 1
        if self.nearest:
            self.keys[lanes] = torch.minimum(
                self.keys[lanes], _pack_key(best[0][0], best[1][0]))
        else:
            self.occ[lanes] = torch.minimum(self.occ[lanes], best[0][0])

    def result(self):
        if not self.nearest:
            return (self.occ[None], (self.occ[None] < INF).to(torch.int32),
                    None)
        t, s = _unpack_key(self.keys)
        return (t[None], s[None],
                T._winner_attrs(self.attr, s[None], self.n_attrs, self.cs))


def _no_hit():
    return (torch.full((1, LANES), INF),
            torch.full((1, LANES), T._BIG_ID, dtype=torch.int32))


def _unit(launch, x):
    """Work unit x: (tile, warp of the tile, item), numbered tile by tile,
    warp by warp, item by item (the kernel's decoding)."""
    first, s = launch.first, launch.subtiles
    tile = max(t for t in range(launch.nt) if first[t] <= x // s)
    items = first[tile + 1] - first[tile]
    y = x - first[tile] * s
    return tile, y // items, y % items


def _warp_walker(launch, counter):
    """One warp of the walk as a coroutine."""
    run = T.WQ_RUN
    units = launch.first[-1] * launch.subtiles
    held, best = None, None
    while True:
        x0 = counter[0]
        counter[0] += run
        yield  # another warp may take the next units meanwhile
        if x0 >= units:
            break
        for x in range(x0, min(x0 + run, units)):
            tile, w, k = _unit(launch, x)
            base = tile * launch.tile + w * LANES
            if base != held:
                if held is not None:
                    launch.merge(held, best)
                held, best = base, _no_hit()
            row = launch.ids[tile].tolist()
            cl = row[k * launch.u:min(k * launch.u + launch.u,
                                      launch.listed(tile))]
            keep = launch.entered(base, cl) if cl else []
            cl = [c for c, kept in zip(cl, keep) if kept]
            yield  # the copies land
            best = launch.walk(base, cl, best)
    if held is not None:
        launch.merge(held, best)


def warp_walk(launch, warps, order_seed):
    """The walk over `warps` warps interleaved by a seeded scheduler."""
    counter = [0]
    running = [_warp_walker(launch, counter) for _ in range(warps)]
    _schedule(running, order_seed)
    return launch.result()


def _schedule(running, order_seed):
    rng = np.random.default_rng(order_seed)
    while running:
        k = int(rng.integers(len(running)))
        try:
            next(running[k])
        except StopIteration:
            running.pop(k)


def _launch(accels, cs, family, mode, tile, n=1024):
    """(Launch, the plain result, alive lanes) of a K4 launch over the
    refined lists of `_pack(3, n)`."""
    acc = accels[cs]
    p = _pack(3, n)
    nearest = mode in ("nearest", "capped")
    t_max = {"nearest": INF, "capped": 4.0}.get(mode, 30.0)
    row = (torch.linspace(0.5, 30.0, p.shape[1])[None].contiguous()
           if mode == "tmax_row" else None)
    na = acc.attr_blocks.shape[1] if nearest else 0
    args, kw = T._wq_walk_args(acc, p, EPS, nearest, t_max, na,
                               tmax_row=row, variant=family, ray_tile=tile)
    want = T.walk_wq_plain(*args, **kw)
    return Launch(args, kw), want, p[7] != 0


def _equal(got, want, alive):
    assert bool(torch.isfinite(want[0][0][alive]).any())
    for g, w in zip(got, want):
        if w is not None:
            assert torch.equal(g[..., alive], w[..., alive])


CASES = [(128, "pmt", "nearest", 1024), (128, "pmt", "occlusion", 128),
         (128, "mt", "capped", 1024), (128, "pmt", "tmax_row", 1024),
         (128, "mt", "nearest", 128), (16, "pmt", "nearest", 1024),
         (16, "mt", "occlusion", 1024), (16, "pmt", "capped", 128),
         (16, "mt", "tmax_row", 128)]


@pytest.mark.parametrize("cs,family,mode,tile", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_warp_walk_equals_plain(accels, cs, family, mode, tile):
    """The walk over 5 warps against `walk_wq_plain`; the dead warp's
    lanes read miss, and a warp merges at most once a take."""
    launch, want, alive = _launch(accels, cs, family, mode, tile)
    got = warp_walk(launch, 5, order_seed=cs + tile)
    _equal(got, want, alive)
    dead = slice(3 * LANES, 4 * LANES)
    assert bool(torch.isinf(got[0][0, dead]).all())
    units = launch.first[-1] * launch.subtiles
    assert 0 < launch.merges <= -(-units // T.WQ_RUN)


def test_queue_holds_the_real_items():
    """Tile t holds ceil(min(cnt, width) / u) items: none for cnt 0, the
    width's for cnt > width."""
    cnt = torch.tensor([0, 1, 4, 5, 9, 30, 0, 12], dtype=torch.int32)
    first = T.wq_queue_plain(cnt, 12, 4)
    items = [0, 1, 1, 2, 3, 3, 0, 3]
    assert first.dtype == torch.int32
    assert first.tolist() == [0] + np.cumsum(items).tolist()
    assert T.wq_queue_plain(cnt[:0], 12, 4).tolist() == [0]


@pytest.mark.parametrize("case", ["cnt0", "over_width", "one_tile"])
def test_edge_lists(accels, case):
    """Lists with nothing (every lane reads miss), counts past the width
    (only the width is walked), one tile holding all the work."""
    launch, _, alive = _launch(accels, 128, "pmt", "nearest", 1024, n=2048)
    ids, cnt = launch.ids, launch.cnt.clone()
    width, nt = ids.shape[1], cnt.shape[0]
    if case == "cnt0":
        cnt.zero_()
        items = 0
    elif case == "over_width":
        cnt[:] = width + 5
        items = nt * -(-width // 4)
    else:
        cnt[1:] = 0
        items = -(-min(int(cnt[0]), width) // 4)
    args = (launch.rays, ids, cnt, launch.geo, launch.attr, launch.n_attrs,
            launch.cs, EPS, True, INF, T.PMT, None)
    kw = dict(u=4, ray_tile=1024, lane_bounds=launch.bounds)
    assert int(T.wq_queue_plain(cnt, width, 4)[-1]) == items
    want = T.walk_wq_plain(*args, **kw)
    got = warp_walk(Launch(args, kw), 4, order_seed=2)
    if case == "cnt0":
        assert bool(torch.isinf(got[0]).all())
        assert bool((got[1] == T._BIG_ID).all()) and not bool(got[2].any())
    else:
        _equal(got, want, alive)
