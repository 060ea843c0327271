"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs CUDA and skips without it. The file imports neither
jax nor the JAX package, so it runs where the card is:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Bars: extents (K6) and entered bits (K5, dense and gathered) equal, also
with a tile's list dealt to many blocks and with the extents folded into
the dense launch, on tiles that list everything, tiles with 1-31 alive
lanes, dead tiles and counts above the width, ten launches each; both
walk entries (K1 via `_walk_groups`, K2 via `_walk_dma`), with either
intersector, and both camera entries bit-equal in t, slot and attrs on
alive lanes (the kernels are built -fmad=false, op for op like the plain
versions); the streamed-groups walk (K3) and the work-queue walk (K4) bit-
equal to their plain versions and to K1 / K2, with either intersector, with
a scalar and a per-ray t_max; the pack walk with every tile's list split
over many blocks bit-equal to its plain version and to K4 in every mode,
and the same bits at every one of ten launches under its racing early exit;
the camera walk and K3 likewise split, bit-equal to their plain versions,
the camera walk to the pack path under shared_origin=0 and K3 to one K1
launch over the whole table, ten launches each equal;
camera rays on the card bit-equal to the CPU's; a frame on the card within
1e-4 of the CPU frame (torch's CUDA and CPU sin/cos in the sampler differ
by ulps); the walks that carry the backward's planes beside the shading
planes (A = 15 in objid mode, 20 in full mode) bit-equal to their plain
versions and to the shading walk; gradients of a render on the card within
1e-5 of each table's largest magnitude of the CPU's (the backward's
scatter-adds are atomics on the card, in another order), the limit
chip_smoke.py holds its 32x32 frame's gradients to; the CLI's frame
(`python -m raytracing_tpu_torch render`, the card by default) equal in u8
to `render()` with the same seed; the liveness probe and a real
out-of-memory error classed transient; an accel cache loaded onto the
card; the off-main-path forms — K1 mt and woop, K2 mt, K3 mt and woop, K4
mt, the capped walks and refinements of the two-phase query, the lane
cull in K1 and the camera walk — equal to their plain versions on alive
lanes.
"""

import numpy as np
import pytest
import torch

from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                  build_default_scene)
from raytracing_tpu_torch.accel import packets
from raytracing_tpu_torch.kernels import cuda
from raytracing_tpu_torch.geometry.scene import subdivided_teapot_mesh
from raytracing_tpu_torch.kernels import traverse as T
from raytracing_tpu_torch.models.camera import (block_ray_ids,
                                                camera_rays_for_ids)
from raytracing_tpu_torch.models.whitted import render
from raytracing_tpu_torch.ops.sampling import stratified_offsets
from tools.group_loop import walk_groups_loop

torch.set_num_threads(2)
pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def setup(dev):
    """CPU and CUDA copies of the default scene's CS 16 and CS 128 accels,
    and two seeded 4096-ray packs (camera-like, bounce-like; one lane in
    ten dead)."""
    scene = build_default_scene(device="cpu")
    accels = {cs: build_cluster_accel(scene.mesh, cluster_size=cs)
              for cs in (16, 128)}
    rng = np.random.default_rng(11)
    n = 4096
    o1 = rng.normal(scale=0.2, size=(n, 3))
    d1 = np.array([1.0, -1.2, 7.5]) + rng.normal(scale=[2.5, 1.5, 2.0],
                                                 size=(n, 3)) - o1
    o2 = np.array([1.0, -1.2, 7.5]) + rng.normal(scale=[2.0, 0.6, 1.5],
                                                 size=(n, 3))
    d2 = rng.normal(size=(n, 3))
    packs = []
    for o, d in ((o1, d1), (o2, d2)):
        alive = (rng.uniform(size=n) > 0.1).astype(np.float32)
        p = np.concatenate([o.T, np.ones((1, n)), d.T, alive[None]])
        packs.append(torch.from_numpy(
            np.ascontiguousarray(p, dtype=np.float32)))
    return accels, packs


def test_extents_kernel_matches_plain(setup, dev):
    _, packs = setup
    for p in packs:
        g = p.to(dev)
        before = T.LAUNCHES["extents"]
        lo, hi = T.tile_extents(g)
        assert T.LAUNCHES["extents"] == before + 1
        plo, phi = T.tile_extents_plain(g)
        assert torch.equal(lo, plo) and torch.equal(hi, phi)


def test_refine_kernel_matches_plain(setup, dev):
    accels, packs = setup
    acc = accels[128].to(dev)
    g = packs[1].to(dev)
    alive = torch.tensor([True, False, True, True], device=dev)
    k = T.refine_dense(g, acc.cluster_min, acc.cluster_max, alive)
    p = T.refine_dense_plain(g, acc.cluster_min, acc.cluster_max, alive)
    assert k.any() and not k[1].any()
    assert torch.equal(k, p)


@pytest.mark.parametrize("cs,wq,entry", [(16, False, "walk"),
                                         (128, True, "walk_dma")])
def test_walk_entries_match_plain(setup, dev, cs, wq, entry):
    accels, packs = setup
    acc_cpu = accels[cs]
    acc = acc_cpu.to(dev)
    for p in packs:
        g = p.to(dev)
        m = p[7] != 0
        before = T.LAUNCHES[entry]
        kern = T.nearest_hit_attrs_soa(acc, g, early_exit=True, wq=wq)
        assert T.LAUNCHES[entry] == before + 1
        plain = T.nearest_hit_attrs_soa(acc_cpu, p, early_exit=True, wq=wq)
        assert bool(torch.isfinite(plain[0][m]).any())
        for a, b in zip(kern, plain):
            assert torch.equal(a[..., m.to(dev)].cpu(), b[..., m])
        for t_max in (float("inf"), 3.0):
            occ = T.any_hit_soa(acc, g, t_max=t_max, wq=wq)
            occ_cpu = T.any_hit_soa(acc_cpu, p, t_max=t_max, wq=wq)
            assert torch.equal(occ.cpu()[m], occ_cpu[m])


def test_pmto_walk_matches_plain(setup, dev):
    """The origin-folded intersector through both pack entries: every ray
    of the pack leaves (0.2, -0.1, -0.5)."""
    accels, packs = setup
    p = packs[0].clone()
    origin = torch.tensor([0.2, -0.1, -0.5])
    p[0:3] = origin[:, None]
    m = p[7] != 0
    for cs, wq in ((16, False), (128, True)):
        kern = T.nearest_hit_attrs_soa(accels[cs].to(dev), p.to(dev), wq=wq,
                                       shared_origin=origin.to(dev))
        plain = T.nearest_hit_attrs_soa(accels[cs], p, wq=wq,
                                        shared_origin=origin)
        assert bool(torch.isfinite(plain[0][m]).any())
        for a, b in zip(kern, plain):
            assert torch.equal(a[..., m.to(dev)].cpu(), b[..., m])


def _shared_origin_pack(p, pmto):
    """(pack, origin | None): with `pmto` every ray leaves one point."""
    if not pmto:
        return p, None
    p = p.clone()
    origin = torch.tensor([0.2, -0.1, -0.5])
    p[0:3] = origin[:, None]
    return p, origin


def _tmax_row(n, per_ray, dev):
    """A per-ray limit row [1, n] running from 0.5 to 30, or None."""
    if not per_ray:
        return None
    return torch.linspace(0.5, 30.0, n, device=dev)[None].contiguous()


def _assert_walks_equal(kern, plain, m):
    assert bool(torch.isfinite(plain[0][0][m]).any())
    for a, b in zip(kern, plain):
        if b is not None:
            assert torch.equal(a[..., m], b[..., m])


@pytest.mark.parametrize("per_ray", [False, True], ids=["scalar", "tmax_row"])
@pytest.mark.parametrize("pmto", [False, True], ids=["pmt", "pmto"])
def test_gstream_kernel_matches_plain(setup, dev, monkeypatch, pmto, per_ray):
    """K3 over 4 groups of 256 clusters (a budget of one byte) against its
    plain version and against the K1 group loop and the single K1 launch:
    nearest with attributes (early exit forced) and occlusion."""
    accels, packs = setup
    acc = accels[16].to(dev)
    p, origin = _shared_origin_pack(packs[0], pmto)
    g = p.to(dev)
    m = (p[7] != 0).to(dev)
    so = None if origin is None else origin.to(dev)
    na = acc.attr_blocks.shape[1]
    row = _tmax_row(g.shape[1], per_ray, dev)
    single = T._walk_groups(acc, g, 1e-8, True, T.INF, na, shared_origin=so)
    single_occ = T._walk_groups(acc, g, 1e-8, False, 3.0, 0, tmax_row=row)
    monkeypatch.setattr(packets, "_GROUP_BLOCK_BUDGET_BYTES", 1)
    args, kw = T._gstream_walk_args(acc, g, 1e-8, True, T.INF, na,
                                    early_exit=True, shared_origin=so)
    assert args[1].shape[0] == 4 and kw["tnear"] is not None
    before = T.LAUNCHES["walk_gstream"]
    visits = torch.zeros(args[2].shape, dtype=torch.int32, device=dev)
    kern = T.walk_gstream(*args, **kw, visits=visits)
    assert T.LAUNCHES["walk_gstream"] == before + 1
    assert 0 < int(visits.sum()) <= int(args[2].sum())
    _assert_walks_equal(kern, T.walk_gstream_plain(*args), m)
    _assert_walks_equal(kern, single, m)
    oargs, okw = T._gstream_walk_args(acc, g, 1e-8, False, 3.0, 0,
                                      tmax_row=row)
    occ = T.walk_gstream(*oargs, **okw)
    _assert_walks_equal(occ, T.walk_gstream_plain(*oargs), m)
    _assert_walks_equal(occ, single_occ, m)
    before = T.LAUNCHES["walk"]
    loop = walk_groups_loop(acc, g, 1e-8, True, T.INF, na, early_exit=True,
                            shared_origin=so)
    assert T.LAUNCHES["walk"] == before + 4
    _assert_walks_equal(kern, loop, m)


@pytest.mark.parametrize("per_ray", [False, True], ids=["scalar", "tmax_row"])
@pytest.mark.parametrize("pmto", [False, True], ids=["pmt", "pmto"])
def test_wq_kernel_matches_plain(setup, dev, monkeypatch, pmto, per_ray):
    """K4 on the bounce-like pack over the CS 128 accel against its plain
    version and against the K2 entry on the same lists: nearest with
    attributes, occlusion, and a tile with no visits."""
    accels, packs = setup
    acc = accels[128].to(dev)
    p, origin = _shared_origin_pack(packs[1], pmto)
    p = p.clone()
    p[7, 3072:] = 0.0  # the last tile is dead: no visits
    g = p.to(dev)
    m = (p[7] != 0).to(dev)
    so = None if origin is None else origin.to(dev)
    na = acc.attr_blocks.shape[1]
    row = _tmax_row(g.shape[1], per_ray, dev)
    args, kw = T._wq_walk_args(acc, g, 1e-8, True, T.INF, na,
                               shared_origin=so)
    assert int(args[2][3]) == 0 and int(args[2][0]) > 0
    before = T.LAUNCHES["walk_wq"]
    kern = T.walk_wq(*args, **kw)
    assert T.LAUNCHES["walk_wq"] == before + 1
    _assert_walks_equal(kern, T.walk_wq_plain(*args), m)
    dargs, dkw = T._dma_walk_args(acc, g, 1e-8, True, T.INF, na,
                                  shared_origin=so)
    _assert_walks_equal(kern, T.walk(*dargs, **dkw), m)
    dead = slice(3072, 4096)
    assert bool(torch.isinf(kern[0][0, dead]).all())
    assert bool((kern[1][0, dead] == 2 ** 30).all())
    assert not bool(kern[2][:, dead].any())
    oargs, okw = T._wq_walk_args(acc, g, 1e-8, False, 3.0, 0, tmax_row=row)
    occ = T.walk_wq(*oargs, **okw)
    _assert_walks_equal(occ, T.walk_wq_plain(*oargs), m)
    doargs, dokw = T._dma_walk_args(acc, g, 1e-8, False, 3.0, 0,
                                    tmax_row=row)
    _assert_walks_equal(occ, T.walk(*doargs, **dokw), m)
    assert not bool(occ[1][0, dead].any())
    # Through the public queries, with the implementation switched.
    want = T.any_hit_soa(acc, g, t_max=3.0 if row is None else row[0],
                         wq=True)
    monkeypatch.setattr(T, "_WQ_IMPL", "grid")
    before = T.LAUNCHES["walk_wq"]
    got = T.any_hit_soa(acc, g, t_max=3.0 if row is None else row[0],
                        wq=True)
    assert T.LAUNCHES["walk_wq"] == before + 1
    assert torch.equal(got[m], want[m])
    with pytest.raises(ValueError):
        T.walk_wq(*args[:1], args[1].T, *args[2:])


def _long_list_walk(setup, dev, cs, pmto, nearest, per_ray):
    """(args, kw, alive) of a `walk` launch whose lists are as long as they
    get: the bounce-like pack against the whole table's frustum lists (the
    K1 entry), the early exit forced for nearest, the last tile dead."""
    accels, packs = setup
    acc = accels[cs].to(dev)
    p, origin = _shared_origin_pack(packs[1], pmto)
    p = p.clone()
    p[7, 3072:] = 0.0
    g = p.to(dev)
    so = None if origin is None else origin.to(dev)
    na = acc.attr_blocks.shape[1] if nearest else 0
    args, kw = T._groups_walk_args(
        acc, g, 1e-8, nearest, T.INF if nearest else 3.0, na,
        early_exit=True, shared_origin=so,
        tmax_row=_tmax_row(g.shape[1], per_ray, dev))
    assert int(args[2][0]) > 4 * T._walk_segment(cs) and int(args[2][3]) == 0
    assert (kw["tnear"] is not None) == nearest
    return args, kw, (p[7] != 0).to(dev)


@pytest.mark.parametrize("nearest,per_ray",
                         [(True, False), (False, False), (False, True)],
                         ids=["nearest", "occlusion", "occlusion-tmax_row"])
@pytest.mark.parametrize("pmto", [False, True], ids=["pmt", "pmto"])
@pytest.mark.parametrize("cs", [16, 128])
def test_split_walk_matches_plain_and_wq(setup, dev, cs, pmto, nearest,
                                         per_ray):
    """Every tile's list split over many blocks: the kernel against
    `walk_plain` and against K4 on the same lists, and a dead tile."""
    args, kw, m = _long_list_walk(setup, dev, cs, pmto, nearest, per_ray)
    before = T.LAUNCHES["walk"]
    visits = torch.zeros(4, dtype=torch.int32, device=dev)
    kern = T.walk(*args, **kw, visits=visits)
    assert T.LAUNCHES["walk"] == before + 1
    listed = args[2].to(torch.int32)
    assert bool((visits <= listed).all()) and int(visits[3]) == 0
    if not nearest:  # no exit: every listed visit is made
        assert torch.equal(visits, listed)
    _assert_walks_equal(kern, T.walk_plain(*args), m)
    _assert_walks_equal(kern, T.walk_wq(*args), m)
    dead = slice(3072, 4096)
    assert bool(torch.isinf(kern[0][0, dead]).all())
    if nearest:
        assert bool((kern[1][0, dead] == 2 ** 30).all())
        assert not bool(kern[2][:, dead].any())
    else:
        assert not bool(kern[1][0, dead].any())


@pytest.mark.parametrize("cs", [16, 128])
def test_split_walk_is_the_same_at_every_launch(setup, dev, cs):
    """The segments race on the early exit: the visits made may differ
    from launch to launch, the result on alive lanes may not."""
    args, kw, m = _long_list_walk(setup, dev, cs, False, True, False)
    first = None
    for _ in range(10):
        visits = torch.zeros(4, dtype=torch.int32, device=dev)
        t, s, a = T.walk(*args, **kw, visits=visits)
        assert 0 < int(visits.sum()) <= int(args[2].sum())
        out = (t[0][m], s[0][m], a[:, m])
        first = first or out
        for x, y in zip(out, first):
            assert torch.equal(x, y)


def test_walk_refuses_a_misaligned_table(setup, dev):
    """The kernels stage blocks with 16-byte copies: the wrapper refuses a
    table that starts 4 bytes off."""
    args, kw, _ = _long_list_walk(setup, dev, 16, False, True, False)
    geo = args[3]
    flat = torch.zeros(geo.numel() + 4, device=dev)
    off = flat[1:1 + geo.numel()].view(geo.shape).copy_(geo)
    with pytest.raises(ValueError, match="16-byte aligned"):
        T.walk(*args[:3], off, *args[4:], **kw)


def _camera_split_args(setup, dev, monkeypatch, cs, shape, chunk):
    """(args, kw) of a camera-walk launch on the default scene with the
    lists cut into one-stage segments (a few tiles: short segments; most
    tiles split over blocks), the early exit forced: the whole frame, or 4 tiles from the frame's
    second-last block on (they overrun it)."""
    accels, _ = setup
    w, h, spp, bh, bw = shape
    monkeypatch.setattr(T, "_LONG_SEGMENT_TRIANGLES", T._STAGE_TRIANGLES)
    cam = T.Camera(w, h, spp, 1.0, bh, bw)
    n_tiles = cam.grid[0] * cam.grid[1]
    tile0, tiles = (n_tiles - 2, 4) if chunk else (0, n_tiles)
    offs = stratified_offsets(spp, device=dev)
    acc = accels[cs].to(dev)
    args, kw = T._camera_walk_args(acc, offs, cam, tile0, tiles,
                                   acc.attr_blocks.shape[1], 1e-8,
                                   early_exit=True)
    assert int(args[5].max()) > 2 * T._camera_grid(tiles, cam.ray_tile,
                                                   args[4].shape[1], cs)[0]
    return args, kw


@pytest.mark.parametrize("chunk", [False, True], ids=["frame", "overrun"])
@pytest.mark.parametrize("shape", [(64, 48, 1, 16, 16), (64, 48, 4, 16, 16),
                                   (32, 32, 8, 16, 16)],
                         ids=["rt256", "rt1024", "rt2048"])
@pytest.mark.parametrize("cs,entry", [(16, "walk_camera"),
                                      (128, "walk_camera_dma")])
def test_camera_split_matches_plain(setup, dev, monkeypatch, cs, entry,
                                    shape, chunk):
    """Both camera entries with every tile's list split over blocks,
    tiles of 256 (R = 2 with dead lanes), 1,024 and 2,048 rays (two
    passes), the whole frame and an overrunning chunk: bit-equal to the
    plain version with and without the early exit, the same at each of
    ten launches under the racing exit."""
    args, kw = _camera_split_args(setup, dev, monkeypatch, cs, shape, chunk)
    assert kw["entry"] == entry
    before = T.LAUNCHES[entry]
    visits = torch.zeros(args[3], dtype=torch.int32, device=dev)
    kern = T.walk_camera(*args, **kw, visits=visits)
    assert T.LAUNCHES[entry] == before + 1
    every = torch.ones(kern[0].shape[1], dtype=torch.bool, device=dev)
    plain = T.walk_camera_plain(*args)
    _assert_walks_equal(kern, plain, every)
    assert bool((visits <= args[5] * (-(-args[1].ray_tile // 1024))).all())
    _assert_walks_equal(T.walk_camera(*args, **dict(kw, tnear=None,
                                                     bbox=None)),
                        plain, every)
    for _ in range(10):
        _assert_walks_equal(T.walk_camera(*args, **kw), kern, every)


@pytest.mark.parametrize("cs", [16, 128])
def test_camera_mode_equals_the_pack_path(setup, dev, monkeypatch, cs):
    """Camera mode (split over blocks) against the pack path under
    shared_origin=0 on the same rays in block order."""
    accels, _ = setup
    monkeypatch.setattr(T, "_LONG_SEGMENT_TRIANGLES", T._STAGE_TRIANGLES)
    acc = accels[cs].to(dev)
    cfg = RenderConfig(width=64, height=48, samples_per_pixel=4)
    offs = stratified_offsets(4, device=dev)
    got = T.nearest_hit_camera_soa(acc, offs, width=64, height=48, spp=4,
                                   scale=cfg.scale, with_attrs=True)
    o, d = camera_rays_for_ids(block_ray_ids(0, 64 * 48 * 4, cfg,
                                             device=dev), cfg)
    want = T.nearest_hit_attrs_soa(acc, T.rays_to_soa(o, d), wq=cs == 128,
                                   shared_origin=torch.zeros(3, device=dev))
    assert bool(torch.isfinite(want[0]).any())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nearest,per_ray",
                         [(True, False), (False, False), (False, True)],
                         ids=["nearest", "occlusion", "occlusion-tmax_row"])
@pytest.mark.parametrize("pmto", [False, True], ids=["pmt", "pmto"])
def test_gstream_split_matches_plain_and_one_walk(setup, dev, monkeypatch,
                                                  pmto, nearest, per_ray):
    """K3 over 4 groups of 256 clusters with the (group, tile) lists split
    into one-stage segments (4 tiles: short segments), the exit forced for
    nearest, the last tile dead: against its plain version, against one K1 launch over the whole
    table, and the same at each of ten launches."""
    accels, packs = setup
    acc = accels[16].to(dev)
    p, origin = _shared_origin_pack(packs[0], pmto)
    p = p.clone()
    p[7, 3072:] = 0.0
    g = p.to(dev)
    m = (p[7] != 0).to(dev)
    so = None if origin is None else origin.to(dev)
    na = acc.attr_blocks.shape[1] if nearest else 0
    t_max = T.INF if nearest else 3.0
    row = _tmax_row(g.shape[1], per_ray, dev)
    query = dict(early_exit=True, shared_origin=so, tmax_row=row)
    wargs, wkw = T._groups_walk_args(acc, g, 1e-8, nearest, t_max, na,
                                     **query)
    one = T.walk(*wargs, **wkw)
    monkeypatch.setattr(packets, "_GROUP_BLOCK_BUDGET_BYTES", 1)
    args, kw = T._gstream_walk_args(acc, g, 1e-8, nearest, t_max, na,
                                    **query)
    assert args[1].shape[0] == 4 and int(args[2][:, 3].sum()) == 0
    assert int(args[2].max()) > 2 * T._gstream_grid(4, 4, 256, 16)[0]
    assert (kw["tnear"] is not None) == nearest
    visits = torch.zeros(args[2].shape, dtype=torch.int32, device=dev)
    kern = T.walk_gstream(*args, **kw, visits=visits)
    assert bool((visits <= args[2]).all())
    if not nearest:
        assert torch.equal(visits, args[2].to(torch.int32))
    _assert_walks_equal(kern, T.walk_gstream_plain(*args), m)
    _assert_walks_equal(kern, one, m)
    for _ in range(10):
        _assert_walks_equal(T.walk_gstream(*args, **kw), kern, m)
    dead = slice(3072, 4096)
    assert bool(torch.isinf(kern[0][0, dead]).all())
    if nearest:
        assert bool((kern[1][0, dead] == 2 ** 30).all())
        assert not bool(kern[2][:, dead].any())
    else:
        assert not bool(kern[1][0, dead].any())


def test_per_ray_tmax_walk_matches_plain(setup, dev):
    """The K1 and K2 entries under a per-ray limit, through `any_hit_soa`:
    the card's flags equal the CPU plain path's; an infinite entry is no
    limit and a zero entry hides everything."""
    accels, packs = setup
    p = packs[1]
    m = p[7] != 0
    tm = torch.linspace(0.5, 30.0, p.shape[1])
    tm[::7] = float("inf")
    tm[3::11] = 0.0
    for cs, wq, entry in ((16, False, "walk"), (128, True, "walk_dma")):
        before = T.LAUNCHES[entry]
        occ = T.any_hit_soa(accels[cs].to(dev), p.to(dev), t_max=tm.to(dev),
                            wq=wq)
        assert T.LAUNCHES[entry] == before + 1
        occ_cpu = T.any_hit_soa(accels[cs], p, t_max=tm, wq=wq)
        assert occ_cpu[m].any() and not occ_cpu[m].all()
        assert torch.equal(occ.cpu()[m], occ_cpu[m])
        assert not bool(occ_cpu[3::11].any())


@pytest.mark.parametrize("shape", [(64, 48, 4, 16, 16), (48, 48, 3, 16, 16),
                                   (32, 32, 1, 8, 8), (32, 32, 16, 16, 16)],
                         ids=["rt1024", "rt768", "rt64", "rt4096"])
@pytest.mark.parametrize("cs,entry", [(16, "walk_camera"),
                                      (128, "walk_camera_dma")])
def test_camera_entries_match_plain(setup, dev, shape, cs, entry):
    """Tiles of 1024, 768, 64 and 4096 rays (1 to 4 rays a thread, and a
    tile walked in four passes), whole-frame and an overrunning chunk."""
    accels, _ = setup
    w, h, spp, bh, bw = shape
    acc = accels[cs].to(dev)
    offs = stratified_offsets(spp)
    kw = dict(width=w, height=h, spp=spp, bh=bh, bw=bw, with_attrs=True)
    n_tiles = (w // bw) * (h // bh)
    for chunk in (dict(), dict(tile_base=n_tiles - 2, tiles=4)):
        before = T.LAUNCHES[entry]
        # The chunked call gets the CPU table: the query moves it.
        kern = T.nearest_hit_camera_soa(acc, offs if chunk else offs.to(dev),
                                        **kw, **chunk)
        assert T.LAUNCHES[entry] == before + 1
        plain = T.nearest_hit_camera_soa(accels[cs], offs, **kw, **chunk)
        assert bool(torch.isfinite(plain[0]).any())
        for a, b in zip(kern, plain):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("block", [16, 8], ids=["bh16", "bh8"])
def test_pooled_camera_lists_on_the_card(setup, dev, monkeypatch, block):
    """Supertile pooling on the card gives the unpooled results, and the
    pooled lists are the direct ones as sets (48x32: a phase-shifted,
    padded supertile grid)."""
    accels, _ = setup
    acc = accels[16].to(dev)
    offs = stratified_offsets(4, device=dev)
    kw = dict(width=48, height=32, spp=4, bh=block, bw=block, with_attrs=True)
    monkeypatch.setattr(T, "_SUPERTILE_MIN_C", 10 ** 9)
    plain = T.nearest_hit_camera_soa(acc, offs, **kw)
    monkeypatch.setattr(T, "_SUPERTILE_MIN_C", 0)
    pooled = T.nearest_hit_camera_soa(acc, offs, **kw)
    assert bool(torch.isfinite(plain[0]).any())
    for a, b in zip(pooled, plain):
        assert torch.equal(a, b)
    cam = T.Camera(48, 32, 4, 1.0, block, block)
    n_tiles = cam.grid[0] * cam.grid[1]
    ext = T._camera_tile_extents(n_tiles, offs, cam)
    ids, _, cnt = T._visit_lists_from_extents(*ext, acc.cluster_min,
                                              acc.cluster_max)
    pids, _, pcnt = T._pooled_camera_lists(acc, ext, cam)
    assert torch.equal(cnt, pcnt)
    for k, c in enumerate(cnt.tolist()):
        assert set(pids[k, :c].tolist()) == set(ids[k, :c].tolist())


def test_camera_rays_on_the_card_are_the_cpu_rays(dev):
    """800 is no power of two: dividing by the Python number on CUDA
    (a multiply by 1/800) would move some directions by an ulp."""
    cfg = RenderConfig()
    r = cfg.width * cfg.height * cfg.samples_per_pixel
    ids = block_ray_ids(3, r // 8, cfg, device="cpu")
    _, d_cpu = camera_rays_for_ids(ids, cfg)
    _, d_dev = camera_rays_for_ids(ids.to(dev), cfg)
    assert torch.equal(d_dev.cpu(), d_cpu)
    cam = T.Camera(cfg.width, cfg.height, cfg.samples_per_pixel, 1.0, 16, 16)
    offs = stratified_offsets(cfg.samples_per_pixel)
    ext_cpu = T._camera_tile_extents(2500, offs, cam)
    ext_dev = T._camera_tile_extents(2500, offs.to(dev), cam)
    for a, b in zip(ext_dev, ext_cpu):
        assert torch.equal(a.cpu(), b)


def test_refine_lists_kernel_matches_plain(dev):
    """790 clusters (more than the dense form takes): the gathered
    refinement's bits, and the `_walk_dma` entry over its lists."""
    mesh = subdivided_teapot_mesh(levels=2, device="cpu")
    acc_cpu = build_cluster_accel(mesh, cluster_size=128)
    acc = acc_cpu.to(dev)
    rng = np.random.default_rng(3)
    n = 4096
    o = np.array([0.0, 0.0, 3.0]) + rng.normal(scale=[1.5, 1.0, 1.0],
                                               size=(n, 3))
    d = rng.normal(size=(n, 3))
    alive = (rng.uniform(size=n) > 0.1).astype(np.float32)
    alive[3072:] = 0.0  # one tile with no alive lane
    p = torch.from_numpy(np.ascontiguousarray(
        np.concatenate([o.T, np.ones((1, n)), d.T, alive[None]]),
        dtype=np.float32))
    g = p.to(dev)
    ids, _, cnt = T._narrow_lists(*T._tile_visit_lists_soa(
        g, acc.cluster_min, acc.cluster_max))
    before = T.LAUNCHES["refine_lists"]
    k = T.refine_lists(g, ids, cnt, acc.cluster_min, acc.cluster_max)
    assert T.LAUNCHES["refine_lists"] == before + 1
    pl = T.refine_lists_plain(g, ids, cnt, acc.cluster_min, acc.cluster_max)
    assert k.any() and not k[3].any() and torch.equal(k, pl)
    m = p[7] != 0
    kern = T.nearest_hit_attrs_soa(acc, g, early_exit=True, wq=True)
    plain = T.nearest_hit_attrs_soa(acc_cpu, p, early_exit=True, wq=True)
    assert T.LAUNCHES["refine_lists"] == before + 2
    assert bool(torch.isfinite(plain[0][m]).any())
    for a, b in zip(kern, plain):
        assert torch.equal(a[..., m.to(dev)].cpu(), b[..., m])
    with pytest.raises(ValueError):
        T.refine_lists(g, ids.T, cnt, acc.cluster_min, acc.cluster_max)


def _refine_pack(seed=3):
    """Seven tiles among the teapots: full tiles (one lane in ten dead;
    tile 0 with degenerate directions), tiles with 1, 5 and 31 alive
    lanes, and a dead tile."""
    rng = np.random.default_rng(seed)
    n = 7 * 1024
    o = np.array([1.0, -1.2, 7.5]) + rng.normal(scale=[2.0, 0.6, 1.5],
                                                size=(n, 3))
    d = rng.normal(size=(n, 3))
    alive = (rng.uniform(size=n) > 0.1).astype(np.float64)
    for tile, k in ((1, 1), (2, 5), (3, 31), (4, 0)):
        lanes = np.arange(tile * 1024, (tile + 1) * 1024)
        alive[lanes] = 0.0
        alive[rng.choice(lanes, k, replace=False)] = 1.0
    # A grazing ray in tile 5: it enters box [0, 1]^3 only through the
    # slab test's inflation (x enters at 1 + 3e-6, y leaves at 1).
    o[5 * 1024] = [-1.0 - 3e-6, 0.0, 0.5]
    d[5 * 1024] = [1.0, 1.0, 0.0]
    # Directions with one, two or three degenerate axes (|d| < 1e-20).
    for lane, axes in ((5, [0]), (9, [1, 2]), (17, [0, 1, 2]), (40, [2])):
        d[lane, axes] = 1e-21 if lane == 40 else 0.0
        alive[lane] = 1.0
    p = np.concatenate([o.T, np.ones((1, n)), d.T, alive[None]])
    return torch.from_numpy(np.ascontiguousarray(p, dtype=np.float32))


def _refine_lists_case(acc, case):
    """Lists over the CS 16 table (790 clusters) in one of the shapes the
    gathered refinement must get right: `imbalance` (tile 0 lists every
    cluster, tile 6 one, tile 4 — dead — one, the rest their frustum
    lists), `width` (counts above the width), `zero` (every count 0), with
    a grazing ray's box listed in tile 5."""
    p = _refine_pack()
    ids, _, cnt = T._narrow_lists(*T._tile_visit_lists_soa(
        p, acc.cluster_min, acc.cluster_max))
    c = acc.num_clusters
    ids = torch.cat([ids, ids.new_zeros((7, c - ids.shape[1]))], dim=1)
    cnt = cnt.clone()
    ids[0], cnt[0] = torch.arange(c, dtype=torch.int32), c
    cnt[6], cnt[4] = 1, 1
    cmin, cmax = acc.cluster_min.clone(), acc.cluster_max.clone()
    cmin[7], cmax[7] = 0.0, 1.0  # the grazing ray's box
    ids[5, 0] = 7
    cnt[5] = max(int(cnt[5]), 1)
    if case == "width":
        ids = ids[:, :40]
        cnt = torch.maximum(cnt, torch.tensor(45))
    elif case == "zero":
        cnt = torch.zeros_like(cnt)
    return p, ids.contiguous(), cnt, cmin, cmax


@pytest.mark.parametrize("grid", [None, (16, 3), (512, 1)],
                         ids=["default", "run16-cap3", "run512-cap1"])
@pytest.mark.parametrize("case", ["imbalance", "width", "zero"])
def test_refine_lists_split_matches_plain(setup, dev, monkeypatch, case,
                                          grid):
    """K5 gathered with each tile's list dealt to blocks in runs: bit-equal
    to its plain version beside a tile that lists every cluster, tiles
    with 1-31 alive lanes, a dead tile, counts above the width and counts
    0; the grazing ray's box entered; ten launches the same bits."""
    if grid is not None:
        monkeypatch.setattr(T, "_REFINE_RUN", grid[0])
        monkeypatch.setattr(T, "_MAX_REFINE_BLOCKS", grid[1])
    accels, _ = setup
    args = _refine_lists_case(accels[16], case)
    want = T.refine_lists_plain(*args)
    gargs = tuple(a.to(dev) for a in args)
    before = T.LAUNCHES["refine_lists"]
    for _ in range(10):
        assert torch.equal(T.refine_lists(*gargs).cpu(), want)
    assert T.LAUNCHES["refine_lists"] == before + 10
    if case == "zero":
        assert not want.any()
    else:
        assert want[0].any() and not want[4].any() and bool(want[5, 0])
        assert 0 < int(want[1:4].sum())


@pytest.mark.parametrize("cs,n_clusters", [(128, 100), (16, 512)])
def test_refine_dense_extents_matches_plain(setup, dev, cs, n_clusters):
    """The dense query in one launch (K6's extents and K5's bits, the
    tile-alive flags from its own extents) against `tile_extents_plain` and
    `refine_dense_plain`, and the dense entry with flags given, on full
    tiles, tiles with 1-31 alive lanes, a dead tile and the grazing ray,
    over the CS 128 table and over 512 clusters (the most the dense form
    takes: the CS 16 table cut there); ten launches the same bits."""
    accels, _ = setup
    acc = accels[cs]
    p = _refine_pack()
    cmin = acc.cluster_min[:n_clusters].clone()
    cmax = acc.cluster_max[:n_clusters].clone()
    cmin[7], cmax[7] = 0.0, 1.0
    plo, phi, pent = T.refine_dense_extents_plain(p, cmin, cmax)
    g, gmin, gmax = p.to(dev), cmin.to(dev), cmax.to(dev)
    counts = dict(T.LAUNCHES)
    for _ in range(10):
        lo, hi, ent = T.refine_dense_extents(g, gmin, gmax)
        assert torch.equal(lo.cpu(), plo) and torch.equal(hi.cpu(), phi)
        assert torch.equal(ent.cpu(), pent)
    assert T.LAUNCHES["refine_extents"] == counts["refine_extents"] + 10
    assert T.LAUNCHES["extents"] == counts["extents"]
    assert pent[0].any() and pent[1:4].any() and not pent[4].any()
    assert bool(pent[5, 7])
    flags = torch.tensor([True, True, True, True, False, True, False])
    want = T.refine_dense_plain(p, cmin, cmax, flags)
    got = T.refine_dense(g, gmin, gmax, flags.to(dev))
    assert torch.equal(got.cpu(), want) and not want[6].any()


def test_bad_launch_raises(dev):
    """A launch the kernel refuses raises; it is never skipped."""
    lib = cuda.library()
    x = torch.zeros((8, 1000), device=dev)
    lo = torch.empty((1, 8), device=dev)
    with pytest.raises(RuntimeError, match="extents kernel launch failed"):
        cuda.check(lib.rt_tile_extents(T._ptr(x), 1000, T._ptr(lo),
                                       T._ptr(lo), T._stream(x)), "extents")
    with pytest.raises(RuntimeError, match="refine_extents kernel launch"):
        cuda.check(lib.rt_refine_dense_extents(
            T._ptr(x), 1024, T._ptr(lo), T._ptr(lo), 513, 1, T._ptr(lo),
            T._ptr(lo), T._ptr(lo), T._stream(x)), "refine_extents")
    with pytest.raises(ValueError):
        T.tile_extents(x)
    boxes = torch.zeros((600, 3), device=dev)
    with pytest.raises(ValueError, match="at most 512"):
        T.refine_dense_extents(torch.zeros((8, 1024), device=dev), boxes,
                               boxes)


@pytest.mark.parametrize("camera", [False, True], ids=["pack", "camera"])
def test_frame_matches_cpu(dev, camera):
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=1,
                       primary_shared_origin=camera)
    draws = {}

    def uniforms(i, depth, shape):
        if (i, depth) not in draws:
            g = torch.Generator().manual_seed(100 * i + depth)
            draws[(i, depth)] = torch.rand(shape, generator=g)
        return draws[(i, depth)]

    imgs = []
    for d in (dev, torch.device("cpu")):
        scene = build_default_scene(device=d)
        acc = build_cluster_accel(scene.mesh, cluster_size=16)
        imgs.append(render(scene, cfg, accel=acc,
                           uniforms=lambda i, k, s: uniforms(i, k, s).to(d))
                    .cpu())
    assert bool(torch.isfinite(imgs[0]).all())
    assert float((imgs[0] - imgs[1]).abs().max()) <= 1e-4


def _full_mode(mesh):
    """The mesh with a color per triangle: 9 shading planes, not 4."""
    tri = torch.arange(mesh.colors.shape[0], dtype=torch.float32)[:, None]
    return mesh._replace(colors=(mesh.colors * (0.5 + 0.5 * torch.cos(tri)))
                         .clamp(0, 1).contiguous())


@pytest.mark.parametrize("mode", ["objid", "full"])
@pytest.mark.parametrize("entry", ["walk", "walk_dma"])
def test_both_walks_match_plain(setup, dev, mode, entry):
    """K1 (CS 16, primaries) and K2 (CS 128, bounce rays, early exit)
    carrying the shading and the backward's planes (A = 15 or 20): bit-
    equal to their plain versions, and to the shading walk in t, slots and
    the shading planes."""
    _, packs = setup
    mesh = build_default_scene(device="cpu").mesh
    if mode == "full":
        mesh = _full_mode(mesh)
    cs = 16 if entry == "walk" else 128
    acc = build_cluster_accel(mesh, cluster_size=cs).to(dev)
    na = acc.attr_blocks.shape[1]
    assert na == (4 if mode == "objid" else 9)
    p = (packs[0] if entry == "walk" else packs[1]).to(dev)
    m = p[7] != 0
    make = T._groups_walk_args if entry == "walk" else T._dma_walk_args
    out = {}
    for kind in ("shade", "both"):
        n = T._n_attrs(acc, kind)
        args, kw = make(acc, p, 1e-8, True, T.INF, n, early_exit=True,
                        attr_kind=kind)
        assert args[5] == n and args[4].shape[1] >= n
        assert kw["entry"] == entry + ("_both" if kind == "both" else "")
        before = T.LAUNCHES[kw["entry"]]
        out[kind] = T.walk(*args, **kw)
        assert T.LAUNCHES[kw["entry"]] == before + 1
        _assert_walks_equal(out[kind], T.walk_plain(*args), m)
    assert out["both"][2].shape[0] == na + 11
    t, s, a = out["shade"]
    tb, sb, ab = out["both"]
    assert torch.equal(t[..., m], tb[..., m])
    assert torch.equal(s[..., m], sb[..., m])
    assert torch.equal(a[:, m], ab[:na, m])


def _tri_scene(dev):
    """tests/test_grad.py's triangle facing the camera and the sun."""
    from raytracing_tpu_torch.geometry.mesh import Scene, concat_objects

    mesh = concat_objects([{
        "verts": np.array([[-2.0, -2.0, 5.0], [3.0, -2.0, 5.0],
                           [-2.0, 3.0, 5.0]], np.float32),
        "tri_v": np.array([[0, 2, 1]], np.int32),
        "colors": np.array([0.8, 0.6, 0.4], np.float32),
        "material": (1.0, 0.5, 0.5)}])
    return Scene(mesh.to(dev), torch.tensor([200.0, 300.0, -1000.0],
                                            device=dev))


@pytest.mark.parametrize("normals", ["geometric", "stored"])
def test_gradients_on_the_card_match_the_cpu(dev, normals):
    """The differentiated render (the fused "both" walk forward, the
    re-derivation and scatter-adds backward) on the card against the CPU
    port, same rays and uniforms, every table within 1e-5 of its largest
    magnitude; on the card it launches the walk with A = 15."""
    from raytracing_tpu_torch.models.whitted import render_rays

    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1,
                       reflect_depth=3, diffuse_depth=2, diffuse_scatter=4,
                       normals=normals)
    n = 16
    xs = np.linspace(-0.1, 0.15, n).astype(np.float32)
    o = np.zeros((n, 3), np.float32)
    d = np.stack([xs, xs * 0.5 + 0.02, np.ones(n, np.float32)], axis=-1)
    g = torch.Generator().manual_seed(3)
    draws = {}

    def uniforms(tag, shape):
        if tag not in draws:
            draws[tag] = torch.rand(shape, generator=g)
        return draws[tag]

    names = ("verts", "normals", "colors", "materials")
    grads = []
    for dv in (dev, torch.device("cpu")):
        scene = _tri_scene(dv)
        acc = build_cluster_accel(scene.mesh, cluster_size=8)
        tables = {k: getattr(scene.mesh, k).clone().requires_grad_()
                  for k in names}
        before = T.LAUNCHES["walk_both"]
        rgb = render_rays(scene.mesh._replace(**tables), acc, scene.sun,
                          torch.from_numpy(o).to(dv),
                          torch.from_numpy(d).to(dv), cfg,
                          lambda tag, shape: uniforms(tag, shape).to(dv))
        (rgb * rgb).sum().backward()
        if dv.type == "cuda":
            assert T.LAUNCHES["walk_both"] > before
        grads.append({k: tables[k].grad.cpu() for k in names})
    for k in names:
        card, cpu = grads[0][k], grads[1][k]
        assert bool(torch.isfinite(card).all()), k
        scale = float(cpu.abs().max())
        if k != "normals" or normals == "stored":
            assert scale > 0, k
        err = float((card - cpu).abs().max())
        assert err <= 1e-5 * scale, (k, err, scale)


def test_cli_render_on_the_card_is_render(dev, tmp_path, capsys):
    """`python -m raytracing_tpu_torch render` on the card (its default
    device) writes `to_u8` of `render()` with the same seed, bit for bit,
    and names the card and its power limit on its frame line."""
    from raytracing_tpu_torch import app
    from raytracing_tpu_torch.ops.color import to_rgba_frame
    from raytracing_tpu_torch.utils.image import read_png

    out = str(tmp_path / "f.png")
    app.main(["render", "--width", "64", "--height", "48", "--spp", "2",
              "--cluster-size", "16", "--gi-cluster-size", "128", "--seed",
              "3", "--out", out])
    printed = capsys.readouterr().out
    assert "frame: " in printed and torch.cuda.get_device_name(0) in printed
    scene = build_default_scene(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    img = render(scene, RenderConfig(width=64, height=48,
                                     samples_per_pixel=2, chunk_size=16384),
                 accel=build_cluster_accel(scene.mesh, cluster_size=16),
                 gi_accel=build_cluster_accel(scene.mesh, cluster_size=128),
                 generator=gen)
    assert np.array_equal(read_png(out), to_rgba_frame(img))


def test_device_alive_and_out_of_memory_on_the_card(dev):
    """The probe answers on the card, and an allocation beyond its memory
    raises an error the retry rule calls transient."""
    from raytracing_tpu_torch.utils.resilience import (device_alive,
                                                       is_transient)

    assert device_alive(timeout_s=60.0, device="cuda")
    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        torch.empty(2 ** 45, dtype=torch.uint8, device=dev)
    assert is_transient(ei.value)
    torch.cuda.empty_cache()


def test_load_accel_lands_on_the_card(dev, tmp_path):
    scene = build_default_scene(device="cpu")
    acc = build_cluster_accel(scene.mesh, cluster_size=16)
    p = str(tmp_path / "accel.npz")
    packets.save_accel(p, acc, mesh=scene.mesh)
    back = packets.load_accel(p, mesh=scene.mesh, cluster_size=16)
    for name in packets.ClusterAccel._fields:
        a, b = getattr(acc, name), getattr(back, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert b.device.type == "cuda" and torch.equal(b.cpu(), a), name


@pytest.mark.parametrize("n", [1, 4])
def test_sharded_frame_on_the_card_is_render(dev, n):
    """`render_sharded` over the card (n = 1) and over 4 virtual shards of
    it, at diffuse depth 1 (no draws), within 1e-5 of `render()` on the
    card: the same rays through the same kernels, only split otherwise.
    The tables stay contiguous on their way to each shard's device."""
    from raytracing_tpu_torch.parallel.shard import (make_device_mesh,
                                                     render_sharded,
                                                     replicate)

    scene = build_default_scene(device="cuda")
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    cfg = RenderConfig(width=64, height=64, samples_per_pixel=2,
                       chunk_size=2048, diffuse_depth=1)
    mesh = make_device_mesh(n, devices=["cuda:0"] * n)
    T.reset_launches()
    img = render_sharded(scene, cfg, mesh, accel=accel)
    assert T.LAUNCHES["walk"] > 0 and T.LAUNCHES["walk_dma"] > 0
    want = render(scene, cfg, accel=accel)
    assert float((img - want).abs().max()) <= 1e-5
    (acc,) = replicate((accel,), "cuda:0")
    assert all(t is None or t.is_contiguous() for t in acc)


def test_two_cards_each_launch_on_its_own(dev):
    """With two cards, a frame sharded over both: each shard's kernels run
    on its own card (its tensors' device, whichever card is current), and
    the frame is `render()`'s. Skips on a machine with one card."""
    from raytracing_tpu_torch.parallel.shard import (make_device_mesh,
                                                     render_sharded)

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    scene = build_default_scene(device="cuda:0")
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    cfg = RenderConfig(width=64, height=64, samples_per_pixel=1,
                       chunk_size=1024, diffuse_depth=1)
    with torch.cuda.device(0):
        img = render_sharded(scene, cfg, make_device_mesh(2), accel=accel)
    want = render(scene, cfg, accel=accel)
    assert float((img - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("backend", ["bruteforce", "cluster"])
def test_plain_backends_on_the_card_are_the_kernel_frame(dev, backend):
    """The brute-force and cluster backends on the card at 32x32x2 (the
    reference config's depths and fan) within 1e-5 of the kernel path's
    frame from the same seed."""
    scene = build_default_scene(device="cuda")
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=2)

    def gen():
        g = torch.Generator(device="cuda")
        g.manual_seed(4)
        return g

    kern = render(scene, cfg, accel=accel, generator=gen())
    img = render(scene, cfg.replace(backend=backend),
                 accel=accel if backend == "cluster" else None,
                 generator=gen())
    assert img.is_cuda and float((img - kern).abs().max()) <= 1e-5


def _same_on_alive(kern, want, m):
    """Kernel results (CUDA) equal to `want` on the alive lanes m."""
    for a, b in zip(kern, want):
        if b is not None:
            assert torch.equal(a[..., m], b[..., m])


@pytest.fixture
def plain_on_card(monkeypatch):
    """plain(fn, *args, **kw): fn with every kernel wrapper taking its
    plain version on the card's tensors (`_on_cpu` answers yes), as
    chip_smoke.py holds the kernels against them."""
    def plain(fn, *args, **kw):
        with monkeypatch.context() as mp:
            mp.setattr(T, "_on_cpu", lambda *tensors: True)
            return fn(*args, **kw)
    return plain


@pytest.mark.parametrize("variant,cs,form", [
    ("mt", 16, "walk"), ("woop", 16, "walk"), ("mt", 128, "walk_dma"),
    ("mt", 128, "walk_wq"), ("mt", 16, "walk_gstream"),
    ("woop", 16, "walk_gstream")], ids=lambda x: str(x))
def test_variant_walks_match_plain(setup, dev, monkeypatch, plain_on_card,
                                   variant, cs, form):
    """K1 mt and woop, K2 mt, K4 mt and K3 mt and woop (the CS 16 table in
    4 groups under a patched budget) through `nearest_hit_attrs_soa` and
    `any_hit_soa` with the family's variant: t, slots and attributes equal
    to the plain version's on alive lanes, nearest and occlusion, each
    launch counted under its family's name."""
    accels, packs = setup
    acc = accels[cs].to(dev)
    wq = form in ("walk_dma", "walk_wq")
    if form == "walk_wq":
        monkeypatch.setattr(T, "_WQ_IMPL", "grid")
    if form == "walk_gstream":
        monkeypatch.setattr(packets, "_GROUP_BLOCK_BUDGET_BYTES", 1)
    key = f"{form}_{variant}"
    for p in packs:
        g = p.to(dev)
        m = g[7] != 0
        before = T.LAUNCHES.get(key, 0)
        query = dict(early_exit=True, wq=wq, variant=variant)
        kern = T.nearest_hit_attrs_soa(acc, g, **query)
        assert T.LAUNCHES[key] == before + 1
        plain = plain_on_card(T.nearest_hit_attrs_soa, acc, g, **query)
        assert bool(torch.isfinite(plain[0][m]).any())
        _same_on_alive(kern, plain, m)
        for t_max in (float("inf"), 3.0):
            occ = T.any_hit_soa(acc, g, t_max=t_max, wq=wq, variant=variant)
            want = plain_on_card(T.any_hit_soa, acc, g, t_max=t_max, wq=wq,
                                 variant=variant)
            assert torch.equal(occ[m], want[m])


@pytest.mark.parametrize("form", ["walk", "walk_dma", "walk_dma_lists",
                                  "walk_wq", "walk_gstream"])
def test_capped_walks_match_plain(setup, dev, monkeypatch, plain_on_card,
                                  form):
    """The two-phase query at a cap of 3 through K1 (CS 16), K2 with the
    dense and the gathered K5 under the cap (CS 128), K4 and K3: equal on
    alive lanes to the plain version's and to the uncapped query's; the
    first phase's launches count as capped."""
    accels, packs = setup
    cs = 16 if form in ("walk", "walk_gstream") else 128
    acc = accels[cs].to(dev)
    if form == "walk_dma_lists":
        monkeypatch.setattr(T, "_REFINE_DENSE_MAX_C", 8)
    if form == "walk_wq":
        monkeypatch.setattr(T, "_WQ_IMPL", "grid")
    if form == "walk_gstream":
        monkeypatch.setattr(packets, "_GROUP_BLOCK_BUDGET_BYTES", 1)
    key = ("walk_dma" if form == "walk_dma_lists" else form) + "_capped"
    refine = {"walk_dma": "refine_extents_capped",
              "walk_dma_lists": "refine_lists_capped",
              "walk_wq": "refine_extents_capped"}.get(form)
    for p in packs:
        g = p.to(dev)
        m = g[7] != 0
        counts = {k: T.LAUNCHES.get(k, 0) for k in (key, refine) if k}
        kern = T.nearest_hit_attrs_soa(acc, g, wq=cs == 128, t_cap=3.0)
        for k, n in counts.items():
            assert T.LAUNCHES[k] == n + 1, k
        _same_on_alive(kern, plain_on_card(
            T.nearest_hit_attrs_soa, acc, g, wq=cs == 128, t_cap=3.0), m)
        _same_on_alive(kern, T.nearest_hit_attrs_soa(acc, g, wq=cs == 128),
                       m)


def test_capped_refinement_matches_plain(setup, dev):
    """K5 dense (with the extents, and with tile-alive flags given) and
    gathered under a cap: the bits of the plain versions, a subset of the
    uncapped bits."""
    accels, packs = setup
    acc = accels[128].to(dev)
    g = packs[1].to(dev)
    boxes = (acc.cluster_min, acc.cluster_max)
    k = T.refine_dense_extents(g, *boxes, 2.0)
    p = T.refine_dense_extents_plain(g, *boxes, 2.0)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert bool((k[2] <= T.refine_dense_extents(g, *boxes)[2]).all())
    alive = torch.ones(g.shape[1] // 1024, dtype=torch.bool, device=dev)
    assert torch.equal(T.refine_dense(g, *boxes, alive, 2.0),
                       T.refine_dense_plain(g, *boxes, alive, 2.0))
    ids, _, cnt = T._narrow_lists(*T._tile_visit_lists_soa(g, *boxes))
    assert torch.equal(T.refine_lists(g, ids, cnt, *boxes, 2.0),
                       T.refine_lists_plain(g, ids, cnt, *boxes, 2.0))


def test_lane_cull_walks_match_plain(setup, dev, plain_on_card):
    """The lane-cull pre-test in K1 (nearest with attributes, occlusion)
    and in the camera walk: equal to the plain versions and to the walks
    without it on alive lanes, launches counted as "_lc"."""
    accels, packs = setup
    for cs in (16, 128):
        acc = accels[cs].to(dev)
        g = packs[1].to(dev)
        m = g[7] != 0
        before = T.LAUNCHES.get("walk_lc", 0)
        kern = T.nearest_hit_attrs_soa(acc, g, early_exit=True,
                                       lane_cull=True)
        assert T.LAUNCHES["walk_lc"] == before + 1
        _same_on_alive(kern, plain_on_card(
            T.nearest_hit_attrs_soa, acc, g, early_exit=True,
            lane_cull=True), m)
        _same_on_alive(kern, T.nearest_hit_attrs_soa(acc, g,
                                                     early_exit=True), m)
        occ = T.any_hit_soa(acc, g, t_max=3.0, lane_cull=True)
        assert torch.equal(occ[m], T.any_hit_soa(acc, g, t_max=3.0)[m])
        assert torch.equal(occ[m], plain_on_card(
            T.any_hit_soa, acc, g, t_max=3.0, lane_cull=True)[m])
    acc = accels[16].to(dev)
    offs = stratified_offsets(2)
    cam = dict(width=64, height=64, spp=2, with_attrs=True)
    before = T.LAUNCHES.get("walk_camera_lc", 0)
    on = T.nearest_hit_camera_soa(acc, offs, lane_cull=True, **cam)
    assert T.LAUNCHES["walk_camera_lc"] == before + 1
    off = T.nearest_hit_camera_soa(acc, offs, **cam)
    plain = plain_on_card(T.nearest_hit_camera_soa, acc, offs,
                          lane_cull=True, **cam)
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    assert all(torch.equal(a, b) for a, b in zip(on, plain))
