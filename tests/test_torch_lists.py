"""The list build of a kernel query (phases 1 and 2: a tile's extents, the
interval slab test against the cluster boxes, the front-to-back
compaction) on the CPU, through its plain versions.

- `tile_lists_plain` and `lists_from_extents_plain` against the
  composition they stand for (`tile_extents_plain`, `_frustum_slabs`,
  `_compact_lists`, the dead-tile rule; K3's group form), bit for bit:
  CS 16 and CS 128, with and without a cap, with K5's entered bits as the
  mask, camera mode's closed-form extents, at every tile of RAY_TILES and
  at the composed tiles 384 and 2,048, on a pack with dead tiles.
- Against the JAX package's `_tile_visit_lists_soa` and
  `_visit_lists_single` (its Pallas extents in interpret mode): counts
  equal, and at every position below the count the ids equal and tnear
  within rtol 1e-6 (XLA may contract a*b+c).
- The card wrappers' own composition of a tile outside RAY_TILES (K6 at
  the launch tile, folded, then the list build from the extents), their
  launches replaced by the plain versions, against the plain version at
  the tile.
- Camera mode's list build (`camera_lists`) on CPU tensors against the
  composition it stands for: the closed-form extents, then the direct
  lists or the two pooled stages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracing_tpu.kernels.traverse as JT
from raytracing_tpu.accel.packets import build_cluster_accel as jax_build
from raytracing_tpu.geometry.scene import build_default_scene as jax_scene

import raytracing_tpu_torch.kernels.traverse as T
from raytracing_tpu_torch.accel import packets
from raytracing_tpu_torch.accel.packets import accel_from_numpy
from raytracing_tpu_torch.ops.sampling import stratified_offsets

torch.set_num_threads(2)

TILES = T.RAY_TILES + (384, 2048)
CAP = 3.0


@pytest.fixture(scope="module")
def accels():
    js = jax_scene(t=0.0)
    out = {}
    for cs in (16, 128):
        j = jax_build(js.mesh, cluster_size=cs)
        out[cs] = (j, accel_from_numpy(
            {k: (None if v is None else np.asarray(v))
             for k, v in j._asdict().items()}, device="cpu"))
    return out


@pytest.fixture(scope="module")
def pack():
    """6,144 bounce-like rays among the teapots, one lane in ten dead:
    rays 512-767 with 3 alive lanes, 1,280-1,535 and 4,096-5,119 with
    none, so that at every tile but 2,048 some tile is dead. Ray 600's
    direction is (0, 1, 0): two axes of its tile's direction interval
    reach 0."""
    rng = np.random.default_rng(23)
    n = 6144
    o = np.array([1.0, -1.2, 7.5]) + rng.normal(scale=[2.0, 0.6, 1.5],
                                                size=(n, 3))
    d = rng.normal(size=(n, 3))
    d[600] = [0.0, 1.0, 0.0]
    alive = (rng.uniform(size=n) > 0.1).astype(np.float64)
    alive[512:768] = 0.0
    alive[[519, 600, 712]] = 1.0
    alive[1280:1536] = 0.0
    alive[4096:5120] = 0.0
    p = np.concatenate([o.T, np.ones((1, n)), d.T, alive[None]])
    return np.ascontiguousarray(p, dtype=np.float32)


def _composed(lo, hi, cmin, cmax, t_cap=None, mask=None):
    """The list build as the query paths wrote it before the list
    kernels: the slab test, the mask, the stable compaction."""
    flags, t_near = T._frustum_slabs(
        lo[:, 0:3], hi[:, 0:3], lo[:, 4:7], hi[:, 4:7],
        lambda k: cmin[None, :, k], lambda k: cmax[None, :, k], t_cap)
    if mask is not None:
        flags = flags & mask
    return T._compact_lists(flags, t_near)


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
        if a.is_floating_point():  # the bits: -0.0 against +0.0 too
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("ray_tile", TILES)
@pytest.mark.parametrize("t_cap", [None, CAP], ids=["uncapped", "capped"])
@pytest.mark.parametrize("cs", [16, 128])
def test_tile_lists_plain_is_the_composition(accels, pack, cs, t_cap,
                                             ray_tile):
    """(lo, hi, ids, tnear, cnt): K6's extents, the lists, cnt 0 on a dead
    tile; its lists are still the sort of its flags, as before."""
    _, acc = accels[cs]
    tp = torch.from_numpy(pack)
    lo, hi = T.tile_extents_plain(tp, ray_tile)
    ids, tnear, cnt = _composed(lo, hi, acc.cluster_min, acc.cluster_max,
                                t_cap)
    cnt = torch.where(hi[:, 7] > 0.0, cnt, 0)
    got = T.tile_lists_plain(tp, acc.cluster_min, acc.cluster_max, t_cap,
                             ray_tile)
    _same(got, (lo, hi, ids, tnear, cnt))
    assert int(cnt.sum()) > 0
    assert (ray_tile == 2048) == bool((hi[:, 7] > 0).all())
    # The query path's lists are these.
    _same(T._tile_visit_lists_soa(tp, acc.cluster_min, acc.cluster_max,
                                  t_cap, ray_tile), got[2:])


@pytest.mark.parametrize("case", ["entered", "entered_capped", "camera",
                                  "dead_extents"])
def test_lists_from_extents_plain_is_the_composition(accels, pack, case):
    """From extents given: K5's dense query's extents and entered bits as
    the mask (the bounce levels' lists, with and without the cap), camera
    mode's closed form over the CS 16 table, and extents with dead tiles'
    +/-3e38 rows and no mask."""
    cs = 16 if case == "camera" else 128
    _, acc = accels[cs]
    cmin, cmax = acc.cluster_min, acc.cluster_max
    t_cap = CAP if case == "entered_capped" else None
    mask = None
    if case == "camera":
        cam = T.Camera(64, 48, 2, 1.0, 16, 16)
        ext = T._camera_tile_extents(12, stratified_offsets(2), cam)
    else:
        tp = torch.from_numpy(pack)
        lo, hi, entered = T.refine_dense_extents_plain(tp, cmin, cmax,
                                                       t_cap, 256)
        assert not bool((hi[:, 7] > 0).all())
        if case != "dead_extents":
            mask = entered
        ext = (lo[:, 0:3], hi[:, 0:3], lo[:, 4:7], hi[:, 4:7])
    flags, t_near = T._frustum_slabs(
        *ext, lambda k: cmin[None, :, k], lambda k: cmax[None, :, k], t_cap)
    if mask is not None:
        flags = flags & mask
    want = T._compact_lists(flags, t_near)
    got = T.lists_from_extents_plain(*ext, cmin, cmax, t_cap, mask=mask)
    _same(got, want)
    assert int(want[2].sum()) > 0


@pytest.mark.parametrize("pad", [False, True], ids=["whole", "padded"])
@pytest.mark.parametrize("t_cap", [None, CAP], ids=["uncapped", "capped"])
def test_group_lists_plain_is_the_gstream_form(accels, pack, monkeypatch,
                                               t_cap, pad):
    """K3's lists (G runs of W boxes, ids local to the run, a dead tile
    listing nothing, the padded clusters struck by the mask): the group
    form as `_gstream_walk_args` wrote it, and (groups of 256, the least
    the group budget gives) that function's lists."""
    _, acc = accels[16]
    tp = torch.from_numpy(pack)
    c = acc.num_clusters
    gsz = 256 if pad else 79  # 790 = 4 x 256 - 234 = 10 x 79
    ng = -(-c // gsz)
    pad_c = ng * gsz - c
    assert bool(pad_c) == pad
    cmin = torch.cat([acc.cluster_min, torch.full((pad_c, 3), T._BIG)])
    cmax = torch.cat([acc.cluster_max, torch.full((pad_c, 3), -T._BIG)])
    lo, hi = T.tile_extents_plain(tp)
    gmin, gmax = cmin.reshape(ng, 1, gsz, 3), cmax.reshape(ng, 1, gsz, 3)
    flags, t_near = T._frustum_slabs(
        lo[None, :, 0:3], hi[None, :, 0:3], lo[None, :, 4:7],
        hi[None, :, 4:7], lambda k: gmin[..., k], lambda k: gmax[..., k],
        t_cap)
    real = torch.arange(ng * gsz) < c
    ids, tnear, cnt = T._compact_lists(flags & real.reshape(ng, 1, gsz),
                                       t_near)
    want = (ids, tnear, torch.where((hi[:, 7] > 0.0)[None], cnt, 0))
    got = T.lists_from_extents_plain(
        lo[:, 0:3], hi[:, 0:3], lo[:, 4:7], hi[:, 4:7], cmin, cmax, t_cap,
        mask=real if pad else None, groups=ng, alive=hi[:, 7])
    _same(got, want)
    assert int(want[2].sum()) > 0
    if pad:
        monkeypatch.setattr(packets, "_GROUP_BLOCK_BUDGET_BYTES", 1)
        args, kw = T._gstream_walk_args(
            acc, tp, 1e-8, True, T.INF if t_cap is None else t_cap, 4,
            early_exit=True)
        _same((args[1], kw["tnear"], args[2]), want)


@pytest.mark.parametrize("t_cap", [None, CAP], ids=["uncapped", "capped"])
@pytest.mark.parametrize("cs", [16, 128])
def test_tile_lists_equal_jax(accels, pack, cs, t_cap):
    """Against JAX's `_tile_visit_lists_soa` (Pallas extents in interpret
    mode): counts equal, ids equal and tnear at rtol 1e-6 below them."""
    j_acc, acc = accels[cs]
    jp = jnp.asarray(pack)
    jids, jtn, jcnt = JT._tile_visit_lists_soa(
        jp, j_acc.cluster_min, j_acc.cluster_max, 1024, interpret=True,
        t_cap=t_cap)
    _, _, ids, tnear, cnt = T.tile_lists_plain(
        torch.from_numpy(pack), acc.cluster_min, acc.cluster_max, t_cap)
    _equal_jax((ids, tnear, cnt), (jids, jtn, jcnt))


@pytest.mark.parametrize("case", ["entered", "camera"])
def test_lists_from_extents_equal_jax(accels, pack, case):
    """Against JAX's `_visit_lists_single` on the same extents: the bounce
    levels' lists with K5's entered bits (CS 128, tiles of 256), camera
    mode's closed form (CS 16)."""
    cs = 16 if case == "camera" else 128
    j_acc, acc = accels[cs]
    mask = None
    if case == "camera":
        cam = T.Camera(64, 48, 2, 1.0, 16, 16)
        ext = T._camera_tile_extents(12, stratified_offsets(2), cam)
    else:
        lo, hi, mask = T.refine_dense_extents_plain(
            torch.from_numpy(pack), acc.cluster_min, acc.cluster_max,
            ray_tile=256)
        ext = (lo[:, 0:3], hi[:, 0:3], lo[:, 4:7], hi[:, 4:7])
    got = T.lists_from_extents_plain(*ext, acc.cluster_min, acc.cluster_max,
                                     mask=mask)
    want = JT._visit_lists_single(
        *(jnp.asarray(e.numpy()) for e in ext), j_acc.cluster_min,
        j_acc.cluster_max,
        extra_mask=None if mask is None else jnp.asarray(mask.numpy()))
    _equal_jax(got, want)


def _equal_jax(got, want):
    ids, tnear, cnt = got
    jids, jtn, jcnt = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    assert int(cnt.sum()) > 0
    for k, c in enumerate(cnt.tolist()):
        c = min(c, jids.shape[1])
        np.testing.assert_array_equal(ids[k, :c].numpy(), jids[k, :c])
        np.testing.assert_allclose(tnear[k, :c].numpy(), jtn[k, :c],
                                   rtol=1e-6)


@pytest.fixture
def as_card(monkeypatch):
    """as_card(wrapper, *args): the wrapper's card path on CPU tensors, its
    own calls (K6 at the launch tile, the list build from extents) then
    running their plain versions (`_on_cpu` answers False once)."""
    real, card = T._on_cpu, [0]

    def on_cpu(*tensors):
        if card[0]:
            card[0] = 0
            return False
        return real(*tensors)

    monkeypatch.setattr(T, "_on_cpu", on_cpu)

    def run(wrapper, *args):
        card[0] = 1
        return wrapper(*args)

    return run


@pytest.mark.parametrize("t_cap", [None, CAP], ids=["uncapped", "capped"])
@pytest.mark.parametrize("ray_tile", [384, 2048])
def test_composed_tile_lists_equal_the_plain_version(accels, pack, as_card,
                                                     ray_tile, t_cap):
    """A tile outside RAY_TILES on the card: K6 at s, folded into the tile
    (a dead launch tile's +/-3e38 drop out), then the list build from the
    folded extents with the tile-alive value: the plain version at the
    tile, bit for bit."""
    _, acc = accels[16]
    tp = torch.from_numpy(pack)
    s, k = T._split_tile(ray_tile)
    sub = (T.tile_extents_plain(tp, s)[1][:, 7] > 0).reshape(-1, k)
    assert bool((sub.any(dim=1) & ~sub.all(dim=1)).any())
    got = as_card(T.tile_lists, tp, acc.cluster_min, acc.cluster_max, t_cap,
                  ray_tile)
    _same(got, T.tile_lists_plain(tp, acc.cluster_min, acc.cluster_max,
                                  t_cap, ray_tile))



@pytest.mark.parametrize("case", ["frame", "frame_pooled", "48x32_chunk",
                                  "48x32_bh8_pooled"])
def test_camera_lists_are_the_plain_composition(accels, monkeypatch, case):
    """Camera mode's list build (`camera_lists`) on CPU tensors: the
    closed-form extents, then the list build from them (whole frame,
    and a chunk whose blocks run past the frame's last) or the two pooled
    stages (the cluster rule lowered; the second stage alone from the
    first's lists gives the same), bit for bit; the pooled lists hold the
    direct ones as sets; nothing counts as a launch or in `lists.camera`
    off the card."""
    from raytracing_tpu_torch.utils.profiling import COUNTERS

    _, acc = accels[16]
    cmin, cmax = acc.cluster_min, acc.cluster_max
    pooled = case.endswith("pooled")
    if pooled:
        monkeypatch.setattr(T, "_SUPERTILE_MIN_C", 0)
    block = 8 if "bh8" in case else 16
    cam = (T.Camera(48, 32, 2, 1.0, block, block) if case.startswith("48x32")
           else T.Camera(96, 64, 2, 1.0, 16, 16))
    n = cam.grid[0] * cam.grid[1]
    tile0, tiles = (n - 2, 4) if case.endswith("chunk") else (0, n)
    offs = stratified_offsets(2)
    assert T._pooled(acc, cam, tile0, tiles) == pooled
    before, listed = dict(T.LAUNCHES), COUNTERS.host.get("lists.camera", 0)
    got = T.camera_lists(acc, offs, cam, tile0, tiles)
    assert T.LAUNCHES == before
    assert COUNTERS.host.get("lists.camera", 0) == listed == 0
    ext = T._camera_tile_extents(tiles, offs, cam, tile0)
    direct = T.lists_from_extents_plain(*ext, cmin, cmax)
    assert int(direct[2].sum()) > 0
    if not pooled:
        _same(got, direct)
        if case.endswith("chunk"):  # blocks past the frame repeat its last
            for a in got:
                assert torch.equal(a[-3:], a[-1:].expand_as(a[-3:]))
        return
    first = T._supertile_lists(acc, ext, cam)
    assert first[0].shape[0] == T._supertiles(cam)[4] * T._supertiles(cam)[5]
    _same(got, T._pooled_camera_lists(acc, ext, cam))
    _same(got, T._pooled_camera_lists(acc, ext, cam, first))
    assert torch.equal(got[2], direct[2])
    for k, c in enumerate(got[2].tolist()):
        assert set(got[0][k, :c].tolist()) == set(direct[0][k, :c].tolist())
