"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs CUDA and skips without it. The file imports neither
jax nor the JAX package, so it runs where the card is:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Bars: extents (K6) and entered bits (K5, dense and gathered) equal; both
walk entries (K1 via `_walk_groups`, K2 via `_walk_dma`), with either
intersector, and both camera entries bit-equal in t, slot and attrs on
alive lanes (the kernels are built -fmad=false, op for op like the plain
versions); the streamed-groups walk (K3) and the work-queue walk (K4)
bit-equal to their plain versions and to K1 / K2, with either intersector,
with a scalar and a per-ray t_max; camera rays on the card bit-equal to the
CPU's; a frame on the card within 1e-4 of the CPU frame (torch's CUDA and
CPU sin/cos in the sampler differ by ulps).
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
    monkeypatch.setattr(T, "STREAM_GROUPS", False)
    before = T.LAUNCHES["walk"]
    loop = T._walk_groups(acc, g, 1e-8, True, T.INF, na, early_exit=True,
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
    ids = block_ray_ids(3, r // 8, cfg)
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


def test_bad_launch_raises(dev):
    """A launch the kernel refuses raises; it is never skipped."""
    lib = cuda.library()
    x = torch.zeros((8, 1000), device=dev)
    lo = torch.empty((1, 8), device=dev)
    with pytest.raises(RuntimeError, match="extents kernel launch failed"):
        cuda.check(lib.rt_tile_extents(T._ptr(x), 1000, T._ptr(lo),
                                       T._ptr(lo), T._stream()), "extents")
    with pytest.raises(ValueError):
        T.tile_extents(x)


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
