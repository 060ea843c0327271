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
scatter-adds are atomics on the card, in another order), the limit the
reference scene's 32x32 frame's gradients are held to; the CLI's frame
(`python -m raytracing_tpu_torch render`, the card by default) equal in u8
to `render()` with the same seed; the liveness probe and a real
out-of-memory error classed transient, `with_retry` getting past it; an
accel cache loaded onto the
card; the off-main-path forms — K1 mt and woop, K2 mt, K3 mt and woop, K4
mt, the capped walks and refinements of the two-phase query, the lane
cull in K1 and the camera walk — equal to their plain versions on alive
lanes; at a query's tile outside RAY_TILES (384, 2,048) every pack
wrapper's composition from launches at 128 or 1,024 equal to its plain
version at the tile; the port's spans (`utils.profiling`) in a traced
reference frame on the device's clock, with the same image and device
operations as untraced, and each walk kernel's visit counters at most its
listed visits; the rest-set merge (csrc/rest.cu) bit-equal on every lane to
its plain versions, in place, at a primary chunk's and a wavefront's size
with every attribute table, in occlusion under each kind of limit, in
camera mode over the whole frame and a chunk past its last block, at lane
counts that are not a multiple of 4, through exact ties and over rest sets
of 64 and 130 rows, and refusing strided or mistyped inputs; the area-light
shadow queries of one chunk of the 1.6M teapot's frame (K3 at level 1, K5
gathered and K2 at the binned level 2, all under the per-ray t_max) equal
to their plain versions on alive lanes, and a reduced area-light frame the
same bit for bit with its bounce levels binned and not; the area lights'
glue (csrc/light.cu) bit-equal to `light_cone` + `light_shadow_rays` and
the plain estimator at the 1.6M frame's two shapes (row- and
column-major, a permuted `rows`), whole area-light frames (the reduced
one and the benchmark cell's) bit-equal with the kernels and without, the
light's own operations and launches the same whatever its alive share,
and a differentiated term through the kernels with the plain term's image
and gradients; the accel's geometry refit on the card bit-equal to the
uploaded build at its vertices and to the CPU's refit after a pose and a
jitter, its hits a fresh build's up to ties; a fit step of the cell
`two_teapots.fit`'s kind with the refit within GRAD_PARITY_RTOL of the
CPU's at 2,048 rays, two at its size (262,144 rays) within the cell's
limits against `rtbench/reference/fit.py`, and the same step with the
spans off and on making the same launches.

Whole paths at full width: the reference frame (800x800x4), with pack-path
and camera-mode primaries, launching every kernel of its path and with the
sky's colour in its corner; the path-traced frame (4 bounces) at 64x64
and 2 spp within 1e-4 of the CPU's, and at 800x800 and 64 spp with the
sky in its corner; the reference frame bit-equal under the two-phase
query's cap, with the lane cull on and off, and at every culling tile
(128 to 2,048) against 1,024, also under gi_wq=False, through K4 and over
the group budget, a composed tile's wrapper call one launch; the camera
query on the 404k, 1.6M and 6.4M-triangle teapots hitting a plausible
share of its rays, and the 404k and 1.6M teapots' frames finite, through
the kernels their sizes take; the reference frame lit by one area light brighter
than without, launching the light's glue,
and bit-equal with its bounce queries through K4 instead of K2; the
backward of 262,144 rays (CS 16; one area light; the CS 128 bounce accel)
with the loss of the forward without grad and every gradient finite and
nonzero; the reference scene's 32x32 frame's gradients within 1e-5 of the
CPU's; the fit at `cmd_fit`'s defaults lowering a held-out loss and its
step-10 checkpoint loading back bit for bit; a fit step retried after a
real out-of-memory error equal to a clean one; the CLI's `bench` record,
`render` through an accel cache (built, then loaded, equal to a fresh
build and `to_u8` of `render()`), `render` at its defaults (the sky's
colour, the reference frame's mean within 0.5 u8), `render --profile`,
`fit` with a checkpoint and `--resume`, and `animate`; `render_sharded`
over the card and over 4 shards of it at diffuse depth 1 within 1e-5 of
`render()` at 800x800x4, and over 4 shards at the reference config with
`render()`'s mean; 2 processes
sharing the card (gloo) stitching the one-process 2-shard frame; a
one-rank NCCL train step equal to the step without a group; the train
step over 2 shards within 1e-4 of a `Fitter` step at 262,144 rays; and
`dryrun_multichip` on the card and over 2 shards of it.

A new kernel adds its equality test here and its timed row to
`chip_smoke.py`, which times the kernels and checks nothing else.
"""

import json
import os

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


def _wq_launch(setup, dev, family, mode, tile, pack=1):
    """(args, kw, alive lanes) of a K4 launch over the refined lists of
    the bounce-like pack (CS 128, the family's table; pmto: every ray
    leaves one point), nearest, capped at 3, or occlusion under a scalar
    limit or a per-ray row. A warp of the first tile has no alive ray."""
    accels, packs = setup
    acc = accels[128].to(dev)
    p, origin = _shared_origin_pack(packs[pack], family == "pmto")
    p = p.clone()
    p[7, 256:384] = 0.0
    g = p.to(dev)
    nearest = mode in ("nearest", "capped")
    na = acc.attr_blocks.shape[1] if nearest else 0
    args, kw = T._wq_walk_args(
        acc, g, 1e-8, nearest, {"nearest": T.INF, "capped": 3.0}.get(mode,
                                                                     30.0),
        na, shared_origin=None if origin is None else origin.to(dev),
        tmax_row=_tmax_row(g.shape[1], mode == "tmax_row", dev),
        variant="mt" if family == "mt" else "pmt", ray_tile=tile)
    return args, kw, g[7] != 0


@pytest.mark.parametrize("tile", [128, 256, 512, 1024])
@pytest.mark.parametrize("family", ["pmt", "pmto", "mt"])
def test_wq_every_instance_matches_plain(setup, dev, plain_on_card, family,
                                         tile):
    """The redesigned K4 at every family and tile, nearest, capped and
    occlusion under a scalar limit and a per-ray row, against
    `walk_wq_plain` on the card's tensors: equal on alive lanes, the work
    queue equal to `wq_queue_plain`, the warp with no alive ray reading
    miss, and one launch counted each."""
    for mode in ("nearest", "capped", "occlusion", "tmax_row"):
        args, kw, m = _wq_launch(setup, dev, family, mode, tile)
        key = T._count_key("walk_wq", T.MT if family == "mt" else T.PMT,
                           mode == "capped", ray_tile=tile)
        before = T.LAUNCHES.get(key, 0)
        queue = torch.empty(args[2].shape[0] + 2, dtype=torch.int32,
                            device=dev)
        kern = T.walk_wq(*args, **kw, queue=queue)
        assert T.LAUNCHES[key] == before + 1
        assert torch.equal(queue[:-1].cpu(), T.wq_queue_plain(
            args[2].cpu(), args[1].shape[1], kw["u"]))
        _assert_walks_equal(kern, plain_on_card(T.walk_wq, *args, **kw), m)
        assert bool(torch.isinf(kern[0][0, 256:384]).all())


@pytest.mark.parametrize("case", ["cnt0", "over_width", "one_tile"])
def test_wq_queue_edges_on_the_card(setup, dev, case):
    """Lists with nothing (every lane reads miss / not occluded), counts
    past the width (the width is walked), one tile holding all the work:
    K4 against its plain version on the same lists."""
    args, kw, m = _wq_launch(setup, dev, "pmt", "nearest", 1024)
    cnt = args[2].clone()
    if case == "cnt0":
        cnt.zero_()
    elif case == "over_width":
        cnt[:] = args[1].shape[1] + 5
    else:
        cnt[1:] = 0
    for nearest in (True, False):
        a = (args[:2] + (cnt,) + args[3:4]
             + ((args[4], args[5]) if nearest else (None, 0)) + args[6:8]
             + (nearest,) + args[9:])
        kern = T.walk_wq(*a, **kw)
        want = T.walk_wq_plain(*(x.cpu() if isinstance(x, torch.Tensor)
                                 else x for x in a))
        for x, y in zip(kern, want):
            if y is not None:
                assert torch.equal(x[..., m].cpu(), y[..., m.cpu()])
        if case == "cnt0":
            assert bool(torch.isinf(kern[0]).all())
            miss = 2 ** 30 if nearest else 0
            assert bool((kern[1] == miss).all())


@pytest.mark.parametrize("tile", [128, 1024])
def test_wq_is_the_same_at_every_launch_and_equals_k2(setup, dev, tile):
    """Ten launches of K4 give equal results (its warps take their work
    from a counter, in an order that differs from launch to launch), equal
    to K2 on the same lists."""
    args, kw, m = _wq_launch(setup, dev, "pmt", "nearest", tile, pack=0)
    first = T.walk_wq(*args, **kw)
    for _ in range(9):
        _assert_walks_equal(T.walk_wq(*args, **kw), first, m)
    dargs, dkw = T._dma_walk_args(setup[0][128].to(dev), args[0], 1e-8, True,
                                  T.INF, args[5], early_exit=True,
                                  ray_tile=tile)
    assert torch.equal(dargs[1], args[1]) and torch.equal(dargs[2], args[2])
    _assert_walks_equal(first, T.walk(*dargs, **dkw), m)
    with pytest.raises(ValueError):
        T.walk_wq(*args, **dict(kw, lane_bounds=None))


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
    acc = setup[0][cs]
    bounds = T._lane_bounds(acc.cluster_min, acc.cluster_max).to(dev)
    _assert_walks_equal(kern, T.walk_wq(*args, lane_bounds=bounds), m)
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
    ids, _, cnt = T.lists_from_extents(*ext, acc.cluster_min,
                                       acc.cluster_max)
    pids, _, pcnt = T._pooled_camera_lists(acc, ext, cam)
    assert torch.equal(cnt, pcnt)
    for k, c in enumerate(cnt.tolist()):
        assert set(pids[k, :c].tolist()) == set(ids[k, :c].tolist())


def _plain_camera_lists(monkeypatch):
    """`camera_lists` on its plain composition on the card's tensors, for
    a query to run with in place of the kernels (`monkeypatch.setattr`)."""
    real = T.camera_lists

    def plain(*args):
        with monkeypatch.context() as mp:
            mp.setattr(T, "_on_cpu", lambda *tensors: True)
            return real(*args)
    return plain


def _check_camera_lists(monkeypatch, dev, acc, cpu_acc, cam, tile0, tiles,
                        pooled):
    """`camera_lists` on the card against the plain composition on the CPU
    (`_camera_tile_extents`, then `lists_from_extents_plain` or
    `_pooled_camera_lists`), ids, tnear and cnt bit for bit, in one launch
    (direct) or two and the one host sync (pooled), no `lists_ext`, every
    block counted in `lists.camera`; then the query over those lists has
    the t, slot and attrs of the query over the plain lists."""
    from raytracing_tpu_torch.utils.profiling import COUNTERS

    offs = stratified_offsets(cam.spp)
    assert T._pooled(acc, cam, tile0, tiles) == pooled
    before, listed = dict(T.LAUNCHES), COUNTERS.host.get("lists.camera", 0)
    syncs = COUNTERS.host.get("syncs.narrow_lists", 0)
    got = T.camera_lists(acc, offs.to(dev), cam, tile0, tiles)
    made = {k: v - before.get(k, 0) for k, v in T.LAUNCHES.items()
            if v != before.get(k, 0)}
    assert made == ({"lists_camera_pooled": 1, "lists_camera_members": 1}
                    if pooled else {"lists_camera": 1}), made
    assert COUNTERS.host["lists.camera"] == listed + tiles
    assert COUNTERS.host.get("syncs.narrow_lists", 0) == syncs + pooled
    want = T.camera_lists(cpu_acc, offs, cam, tile0, tiles)
    assert COUNTERS.host["lists.camera"] == listed + tiles
    _bits(got, want)
    assert int(want[2].sum()) > 0 and got[0].shape[0] == tiles
    kw = dict(width=cam.width, height=cam.height, spp=cam.spp, bh=cam.bh,
              bw=cam.bw, with_attrs=True)
    if (tile0, tiles) != (0, cam.grid[0] * cam.grid[1]):
        kw.update(tile_base=tile0, tiles=tiles)
    kern = T.nearest_hit_camera_soa(acc, offs, **kw)
    with monkeypatch.context() as mp:
        mp.setattr(T, "camera_lists", _plain_camera_lists(monkeypatch))
        plain = T.nearest_hit_camera_soa(acc, offs, **kw)
    assert bool(torch.isfinite(plain[0]).any())
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [
    "frame", "frame_pooled", "frame_chunk", "48x32_bh16_past_the_end",
    "48x32_bh16", "48x32_bh8", "48x32_bh16_pooled", "48x32_bh8_pooled"])
def test_camera_lists_match_the_cpu(setup, dev, monkeypatch, case):
    """The camera query's list build on the card (csrc/lists.cu
    `rt_camera_lists`, and `rt_camera_member_lists` for the pooled lists)
    against its plain composition on the CPU: the two-teapot cell's shape
    (800x800x4 over the CS 16 table, direct; and pooled with the cluster
    rule lowered), a renderer's chunk of 64 blocks, a chunk whose blocks
    run past the frame's last, and the phase-shifted, padded supertile
    grid of a 48x32 frame at bh 16 and 8, direct and pooled."""
    accels, _ = setup
    acc = accels[16].to(dev)
    pooled = case.endswith("pooled")
    if pooled:
        monkeypatch.setattr(T, "_SUPERTILE_MIN_C", 0)
    if case.startswith("48x32"):
        block = 8 if "bh8" in case else 16
        cam = T.Camera(48, 32, 4, 1.0, block, block)
    else:
        cam = T.Camera(800, 800, 4, 1.0, 16, 16)
    n = cam.grid[0] * cam.grid[1]
    tile0, tiles = {"frame_chunk": (1216, 64),
                    "48x32_bh16_past_the_end": (n - 2, 4)}.get(case, (0, n))
    _check_camera_lists(monkeypatch, dev, acc, accels[16], cam, tile0, tiles,
                        pooled)


def test_pooled_camera_lists_at_1m6_match_the_cpu(teapot_1m6, dev,
                                                  monkeypatch):
    """The teapot_1m6.primary cell's list build: 800x800x4 over 12,640
    clusters, pooled (676 supertiles, then each of the 2,500 blocks'
    re-test of its supertile's candidates), bit for bit the CPU's."""
    _, acc = teapot_1m6
    assert acc.num_clusters > T._SUPERTILE_MIN_C
    _check_camera_lists(monkeypatch, dev, acc, acc.to("cpu"),
                        T.Camera(800, 800, 4, 1.0, 16, 16), 0, 2500, True)


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
    """A launch the kernel refuses raises; it is never skipped: a pack that
    is not whole tiles, a launch tile outside RAY_TILES (384; 2,048, above
    the largest: the wrappers build those from launches at 128 and 1,024,
    `test_composed_tiles_match_plain`), a query's tile that is not a
    multiple of 128, more clusters than the dense form takes."""
    lib = cuda.library()
    x = torch.zeros((8, 1000), device=dev)
    x4 = torch.zeros((8, 4096), device=dev)
    lo = torch.empty((1, 8), device=dev)
    with pytest.raises(RuntimeError, match="extents kernel launch failed"):
        cuda.check(lib.rt_tile_extents(T._ptr(x), 1000, 1024, T._ptr(lo),
                                       T._ptr(lo), T._stream(x)), "extents")
    for tile in (384, 2048):
        with pytest.raises(RuntimeError, match="extents kernel launch"):
            cuda.check(lib.rt_tile_extents(T._ptr(x4), 4096, tile,
                                           T._ptr(lo), T._ptr(lo),
                                           T._stream(x4)), "extents")
    with pytest.raises(RuntimeError, match="refine_extents kernel launch"):
        cuda.check(lib.rt_refine_dense_extents(
            T._ptr(x), 1024, 1024, T._ptr(lo), T._ptr(lo), 513, 1,
            T._ptr(lo), T._ptr(lo), T._ptr(lo), T._stream(x)),
            "refine_extents")
    with pytest.raises(ValueError):
        T.tile_extents(x)
    with pytest.raises(ValueError, match="a positive multiple of 128"):
        T.tile_extents(x4, 1000)
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
    """The probe answers on the card, an allocation beyond its memory
    raises an error the retry rule calls transient, and `with_retry` gets
    past it on its second attempt."""
    from raytracing_tpu_torch.utils.resilience import (device_alive,
                                                       is_transient,
                                                       with_retry)

    assert device_alive(timeout_s=60.0, device="cuda")
    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        torch.empty(2 ** 45, dtype=torch.uint8, device=dev)
    assert is_transient(ei.value)
    torch.cuda.empty_cache()
    tries = []

    def alloc():
        tries.append(1)
        if len(tries) == 1:
            torch.empty(2 ** 45, dtype=torch.uint8, device=dev)
        return float(torch.ones(4, device=dev).sum())

    assert with_retry(alloc, retries=2, backoff_s=0.0) == 4.0
    assert len(tries) == 2


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


@pytest.mark.parametrize("n", [1, 4])
def test_full_width_sharded_frame_on_the_card_is_render(dev, n):
    """`render_sharded` over the card (n = 1) and over 4 virtual shards of
    it, at the reference config's width (800x800x4, CS 16 and the
    auto-built CS 128 bounce accel) and diffuse depth 1 (no draws), within
    MULTI_ATOL of `render()` on the card, launching the walks, the
    refinement and the list builds."""
    from raytracing_tpu_torch.parallel.shard import (make_device_mesh,
                                                     render_sharded)

    scene = build_default_scene(device="cuda")
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    cfg = RenderConfig(diffuse_depth=1)
    want = render(scene, cfg, accel=accel)
    T.reset_launches()
    img = render_sharded(scene, cfg, make_device_mesh(n, devices=["cuda:0"]
                                                      * n), accel=accel)
    torch.cuda.synchronize()
    assert all(T.LAUNCHES[k] > 0 for k in ("walk", "walk_dma",
                                           "refine_extents", "lists",
                                           "lists_ext")), dict(T.LAUNCHES)
    assert img.shape == want.shape
    assert float((img - want).abs().max()) <= MULTI_ATOL


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
    plain version on the card's tensors (`_on_cpu` answers yes): the
    plain versions on the card, as the kernel table times them."""
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


# ---------------------------------------------------------------------------
# The bounce levels' culling tile: every pack kernel at tiles of 128-512
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ray_tile", [256, 128, 512])
def test_extents_and_dense_refine_at_a_smaller_tile(setup, dev, ray_tile):
    """K6 and K5 dense (with K6's extents in the launch, and with flags
    given) at a tile of `ray_tile` rays (a block of ray_tile / 4
    threads): equal to their plain versions at that tile on the refine
    pack (tiles with 1-31 alive lanes, a dead tile, degenerate
    directions, the grazing ray), ten launches; counted as "_rt<T>"."""
    accels, _ = setup
    acc = accels[128]
    p = _refine_pack()
    cmin, cmax = acc.cluster_min.clone(), acc.cluster_max.clone()
    cmin[7], cmax[7] = 0.0, 1.0
    g, gmin, gmax = p.to(dev), cmin.to(dev), cmax.to(dev)
    plo, phi = T.tile_extents_plain(p, ray_tile)
    _, _, pent = T.refine_dense_extents_plain(p, cmin, cmax,
                                              ray_tile=ray_tile)
    assert plo.shape == (p.shape[1] // ray_tile, 8)
    counts = dict(T.LAUNCHES)
    for _ in range(10):
        lo, hi = T.tile_extents(g, ray_tile)
        assert torch.equal(lo.cpu(), plo) and torch.equal(hi.cpu(), phi)
        flo, fhi, fent = T.refine_dense_extents(g, gmin, gmax,
                                                ray_tile=ray_tile)
        assert torch.equal(flo.cpu(), plo) and torch.equal(fhi.cpu(), phi)
        assert torch.equal(fent.cpu(), pent)
    key = f"_rt{ray_tile}"
    assert T.LAUNCHES["extents" + key] == counts.get("extents" + key, 0) + 10
    assert T.LAUNCHES["refine_extents" + key] == counts.get(
        "refine_extents" + key, 0) + 10
    assert T.LAUNCHES["extents"] == counts["extents"]
    assert pent.any() and not pent[4 * 1024 // ray_tile].any()
    flags = phi[:, 7] > 0.0
    flags[0] = False
    want = T.refine_dense_plain(p, cmin, cmax, flags, ray_tile=ray_tile)
    got = T.refine_dense(g, gmin, gmax, flags.to(dev), ray_tile=ray_tile)
    assert torch.equal(got.cpu(), want) and not want[0].any()


@pytest.mark.parametrize("ray_tile", [256, 128])
@pytest.mark.parametrize("case", ["imbalance", "width"])
def test_refine_lists_at_a_smaller_tile(setup, dev, case, ray_tile):
    """K5 gathered at a smaller tile over the CS 16 table's lists, a tile
    that lists every cluster beside short ones, a dead tile, counts above
    the width: the plain version's bits, ten launches."""
    accels, _ = setup
    acc = accels[16]
    p = _refine_pack()
    ids, _, cnt = T._narrow_lists(*T._tile_visit_lists_soa(
        p, acc.cluster_min, acc.cluster_max, ray_tile=ray_tile))
    c = acc.num_clusters
    ids = torch.cat([ids, ids.new_zeros((ids.shape[0], c - ids.shape[1]))],
                    dim=1)
    cnt = cnt.clone()
    ids[0], cnt[0] = torch.arange(c, dtype=torch.int32), c
    if case == "width":
        ids = ids[:, :40]
        cnt = torch.maximum(cnt, torch.tensor(45))
    args = (p, ids.contiguous(), cnt, acc.cluster_min, acc.cluster_max)
    want = T.refine_lists_plain(*args, ray_tile=ray_tile)
    gargs = tuple(a.to(dev) for a in args)
    for _ in range(10):
        assert torch.equal(T.refine_lists(*gargs, ray_tile=ray_tile).cpu(),
                           want)
    dead = 4 * 1024 // ray_tile
    assert want[0].any() and not want[dead].any()


@pytest.mark.parametrize("form,ray_tile", [
    ("walk", 256), ("walk_lc", 256), ("walk_dma", 256), ("walk_dma", 128),
    ("walk_dma", 512), ("walk_dma_lists", 256), ("walk_wq", 256),
    ("walk_gstream", 256)], ids=lambda x: str(x))
def test_walks_at_a_smaller_tile_match_plain(setup, dev, monkeypatch,
                                             plain_on_card, form, ray_tile):
    """K1 (nearest with attributes and occlusion under a scalar and a
    per-ray t_max; with the lane cull), K2 over the dense and the
    gathered K5's lists, K4 and K3 at a smaller tile, through
    `nearest_hit_attrs_soa` / `any_hit_soa(ray_tile=)`: equal on alive
    lanes to the plain versions at that tile and to the default tile's
    kernels; each launch counted as "<form>_rt<T>"."""
    accels, packs = setup
    cs = 16 if form in ("walk", "walk_lc", "walk_gstream") else 128
    acc = accels[cs].to(dev)
    if form == "walk_dma_lists":
        monkeypatch.setattr(T, "_REFINE_DENSE_MAX_C", 8)
    if form == "walk_wq":
        monkeypatch.setattr(T, "_WQ_IMPL", "grid")
    if form == "walk_gstream":
        monkeypatch.setattr(packets, "_GROUP_BLOCK_BUDGET_BYTES", 1)
    query = dict(early_exit=True, wq=cs == 128, lane_cull=form == "walk_lc")
    key = {"walk_dma_lists": "walk_dma"}.get(form, form) + f"_rt{ray_tile}"
    for p in packs:
        g = p.to(dev)
        m = g[7] != 0
        before = T.LAUNCHES.get(key, 0)
        kern = T.nearest_hit_attrs_soa(acc, g, ray_tile=ray_tile, **query)
        assert T.LAUNCHES[key] == before + 1
        plain = plain_on_card(T.nearest_hit_attrs_soa, acc, g,
                              ray_tile=ray_tile, **query)
        assert bool(torch.isfinite(plain[0][m]).any())
        _same_on_alive(kern, plain, m)
        _same_on_alive(kern, T.nearest_hit_attrs_soa(acc, g, **query), m)
        row = torch.linspace(0.5, 6.0, g.shape[1], device=dev)
        for t_max in (3.0, row):
            occ = T.any_hit_soa(acc, g, t_max=t_max, ray_tile=ray_tile,
                                **{k: v for k, v in query.items()
                                   if k != "early_exit"})
            want = plain_on_card(T.any_hit_soa, acc, g, t_max=t_max,
                                 ray_tile=ray_tile, wq=query["wq"],
                                 lane_cull=query["lane_cull"])
            assert torch.equal(occ[m], want[m])


@pytest.mark.parametrize("cs", [16, 128])
def test_split_walk_at_a_smaller_tile_is_the_same_at_every_launch(
        setup, dev, cs):
    """The pack walk at 256 over the bounce pack's long lists (a block of
    64 threads, keys and a finish counter per tile of 256), the exit
    forced: ten launches, the same t, slots and attributes on alive lanes,
    the plain version's."""
    accels, packs = setup
    acc = accels[cs].to(dev)
    g = packs[1].to(dev)
    m = g[7] != 0
    args, kw = T._groups_walk_args(acc, g, 1e-8, True, float("inf"),
                                   acc.attr_blocks.shape[1],
                                   early_exit=True, ray_tile=256)
    assert kw["ray_tile"] == 256 and args[2].shape == (16,)
    assert int(args[2].max()) > 2 * T._walk_segment(cs)
    want = T.walk_plain(*args, ray_tile=256)
    first = None
    for _ in range(10):
        visits = torch.zeros(16, dtype=torch.int32, device=dev)
        t, s, a = T.walk(*args, **kw, visits=visits)
        assert 0 < int(visits.sum()) <= int(args[2].sum())
        out = (t[0][m], s[0][m], a[:, m])
        first = first or out
        for x, y in zip(out, first):
            assert torch.equal(x, y)
    _same_on_alive((t, s, a), want, m)


@pytest.mark.parametrize("ray_tile", [384, 2048])
def test_composed_tiles_match_plain(setup, dev, monkeypatch, ray_tile):
    """A query's tile outside RAY_TILES (384 = 3 x 128, 2,048 = 2 x
    1,024): each wrapper launches at s (`_split_tile`) with the lists
    repeated and folds the launch tiles into the tile — K6 and K5 dense
    (flags given, and with K6) on the refine pack padded to whole tiles
    (dead launch tiles inside alive tiles), K5 gathered over the CS 16
    lists, K1 with the lane cull and K2 with the early exit (visits summed
    over the launch tiles), K3 in 4 groups and K4 (its queue the
    launch's) on the bounce-like pack: each equal to its plain version at
    the tile (the walks on alive lanes), each launch counted at s."""
    accels, packs = setup
    s, k = T._split_tile(ray_tile)
    key = "" if s == T.RAY_TILE else f"_rt{s}"
    p, _ = T._pad_rays_soa(_refine_pack(), ray_tile)
    a16, a128 = accels[16].to(dev), accels[128].to(dev)
    g = p.to(dev)
    boxes = (a128.cluster_min, a128.cluster_max)
    plo, phi = T.tile_extents_plain(g, ray_tile)
    sub = (T.tile_extents_plain(g, s)[1][:, 7] > 0).reshape(-1, k)
    assert bool((sub.any(dim=1) & ~sub.all(dim=1)).any())
    counts = dict(T.LAUNCHES)
    lo, hi = T.tile_extents(g, ray_tile)
    assert torch.equal(lo, plo) and torch.equal(hi, phi)
    assert T.LAUNCHES["extents" + key] == counts.get("extents" + key, 0) + 1
    flags = phi[:, 7] > 0
    assert torch.equal(T.refine_dense(g, *boxes, flags, ray_tile=ray_tile),
                       T.refine_dense_plain(g, *boxes, flags,
                                            ray_tile=ray_tile))
    got = T.refine_dense_extents(g, *boxes, ray_tile=ray_tile)
    want = T.refine_dense_extents_plain(g, *boxes, ray_tile=ray_tile)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    ids, _, cnt = T._narrow_lists(*T._tile_visit_lists_soa(
        g, a16.cluster_min, a16.cluster_max, ray_tile=ray_tile))
    lists = (g, ids, cnt, a16.cluster_min, a16.cluster_max)
    keep = T.refine_lists(*lists, ray_tile=ray_tile)
    assert keep.any() and torch.equal(
        keep, T.refine_lists_plain(*lists, ray_tile=ray_tile))

    rp, _ = T._pad_rays_soa(packs[1].to(dev), ray_tile)
    m = rp[7] != 0
    na = a16.attr_blocks.shape[1]
    for acc, build, extra in (
            (a16, T._groups_walk_args, dict(lane_cull=True)),
            (a128, T._dma_walk_args, {})):
        args, kw = build(acc, rp, 1e-8, True, T.INF, na, early_exit=True,
                         ray_tile=ray_tile, **extra)
        before = T.LAUNCHES.get(kw["entry"] + ("_lc" if extra else "") + key,
                                0)
        visits = torch.zeros(args[2].shape, dtype=torch.int32, device=dev)
        got = T.walk(*args, **kw, visits=visits)
        assert T.LAUNCHES[kw["entry"] + ("_lc" if extra else "") + key] \
            == before + 1
        assert 0 < int(visits.sum()) <= k * int(args[2].sum())
        _same_on_alive(got, T.walk_plain(
            *args, ray_tile=ray_tile, lane_bounds=kw.get("lane_bounds")), m)
    args, kw = T._wq_walk_args(a128, rp, 1e-8, True, T.INF, na,
                               ray_tile=ray_tile)
    queue = torch.empty(args[2].shape[0] * k + 2, dtype=torch.int32,
                        device=dev)
    got = T.walk_wq(*args, **kw, queue=queue)
    assert torch.equal(queue[:-1], T.wq_queue_plain(
        args[2].repeat_interleave(k), args[1].shape[1], kw["u"]))
    _same_on_alive(got, T.walk_wq_plain(*args, **kw), m)
    monkeypatch.setattr(packets, "_GROUP_BLOCK_BUDGET_BYTES", 1)
    args, kw = T._gstream_walk_args(a16, rp, 1e-8, True, T.INF, na,
                                    early_exit=True, ray_tile=ray_tile)
    assert args[1].shape[0] == 4
    _same_on_alive(T.walk_gstream(*args, **kw),
                   T.walk_gstream_plain(*args, ray_tile=ray_tile), m)


# ---------------------------------------------------------------------------
# The list builds (csrc/lists.cu)
# ---------------------------------------------------------------------------


def _bits(got, want):
    """Equal bit for bit: floats by their bits (-0.0 against +0.0 too)."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a.cpu(), b.cpu())


def _awkward_boxes(n, seed, dev):
    """n boxes against extents at the origin looking along +x: lo.x of
    +0.0 and -0.0 (entry bounds +0.0 and -0.0), of 1 and 2 (ties), boxes
    behind the origin (unflagged: +inf), the rest at random."""
    r = np.random.default_rng(seed)
    lo = r.normal(size=(n, 3)).astype(np.float32)
    kind = r.integers(0, 6, size=n)
    lo[kind == 0, 0] = 0.0
    lo[kind == 1, 0] = -0.0
    lo[kind == 2, 0] = 1.0
    lo[kind == 3, 0] = 2.0
    hi = lo + np.abs(r.normal(size=(n, 3))).astype(np.float32) + 0.1
    lo[kind == 4, 0], hi[kind == 4, 0] = -3.0, -1.0
    return (torch.from_numpy(np.ascontiguousarray(lo)).to(dev),
            torch.from_numpy(np.ascontiguousarray(hi)).to(dev))


def _awkward_extents(nt, dev):
    """Tiles at the origin: along +x with y and z unbounded (keys +-0.0,
    ties); every axis unbounded (every key -inf); an x interval from
    -1e-30 (below TINY) to 3e38, unbounded too; and a dead tile's
    +/-3e38 rows (denormal reciprocals)."""
    z = torch.zeros((nt, 3), device=dev)
    d_lo = torch.tensor([0.5, -1.0, -1.0], device=dev).repeat(nt, 1)
    d_hi = torch.tensor([1.0, 1.0, 1.0], device=dev).repeat(nt, 1)
    d_lo[1::4] = -1.0
    d_lo[2::4, 0], d_hi[2::4, 0] = -1.0e-30, 3e38
    o_lo, o_hi = z.clone(), z.clone()
    o_lo[3::4], o_hi[3::4] = 3e38, -3e38
    d_lo[3::4], d_hi[3::4] = 3e38, -3e38
    return o_lo, o_hi, d_lo, d_hi


def _widest_group(setup):
    """The widest row a list build takes on the main paths: the group
    `_group_clusters` gives an occlusion query (no attribute rows) at CS
    16, above the kernel's shared-memory sort."""
    accels, _ = setup
    w = T._group_clusters(accels[16], 0)
    assert w > T._LISTS_SORT_CAP
    return w


@pytest.mark.parametrize("groups", [None, 3])
@pytest.mark.parametrize("width", [100, 790, 4096, 6320, "widest"])
def test_lists_from_extents_matches_plain(setup, dev, plain_on_card, width,
                                          groups):
    """The list build from extents against its plain version on the card,
    whole arrays bit for bit, on keys built to tie, at +0.0 and -0.0, -inf
    on unbounded tiles, +inf unflagged, on a dead tile's extents; with and
    without a cap, a mask (every tile's, and one shared by the tiles) and
    the tile-alive values; the plain versions on the card and on the CPU
    agree (torch.sort orders +-0.0 and ties the same on both)."""
    if width == "widest":
        width = _widest_group(setup)
    g = groups or 1
    cmin, cmax = _awkward_boxes(width * g, width + g, dev)
    ext = _awkward_extents(8, dev)
    rng = np.random.default_rng(width)
    masks = (torch.from_numpy(rng.uniform(size=(8, width * g)) < 0.8),
             torch.from_numpy(rng.uniform(size=width * g) < 0.8))
    alive = torch.tensor([1.0, 0.0, 2.0, 1.0, -1.0, 1.0, 1.0, 0.5],
                         device=dev)
    for kw in (dict(), dict(t_cap=1.5, mask=masks[0].to(dev), alive=alive),
               dict(mask=masks[1].to(dev))):
        before = dict(T.LAUNCHES)
        got = T.lists_from_extents(*ext, cmin, cmax, groups=groups, **kw)
        key = "lists_ext" + ("_capped" if "t_cap" in kw else "")
        assert T.LAUNCHES[key] == before.get(key, 0) + 1
        want = plain_on_card(T.lists_from_extents, *ext, cmin, cmax,
                             groups=groups, **kw)
        _bits(got, want)
        assert int(got[2].sum()) > 0
        cpu = T.lists_from_extents(
            *(e.cpu() for e in ext), cmin.cpu(), cmax.cpu(), groups=groups,
            **{k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()})
        _bits(want, cpu)
    # The keys hold the cases they were built for.
    tn = got[1].reshape(-1, width)
    assert bool((tn == float("-inf")).any()) and bool((tn == 0.0).any())
    zero = tn[(tn == 0.0)]
    assert bool(torch.signbit(zero).any()) and not bool(
        torch.signbit(zero).all())


@pytest.mark.parametrize("cap", [None, 3.0], ids=["uncapped", "capped"])
@pytest.mark.parametrize("ray_tile", [1024, 256, 128, 384, 2048])
@pytest.mark.parametrize("cs", [16, 128])
def test_tile_lists_matches_plain(setup, dev, plain_on_card, cs, ray_tile,
                                  cap):
    """The list build from a pack (K6's extents and the lists in one
    launch; at 384 and 2,048 K6 at the launch tile, folded, and the build
    from extents) against its plain version on the card, bit for bit,
    on both seeded packs with a dead tile and a tile of 3 alive lanes."""
    accels, packs = setup
    acc = accels[cs].to(dev)
    for p in packs:
        q = p.clone()
        q[7, :3072] = 0.0
        q[7, [2100, 2500, 3000]] = 1.0
        g, _ = T._pad_rays_soa(q.to(dev), ray_tile)
        before = dict(T.LAUNCHES)
        got = T.tile_lists(g, acc.cluster_min, acc.cluster_max, cap,
                           ray_tile)
        s, k = T._split_tile(ray_tile)
        key = T._count_key("lists" if k == 1 else "lists_ext",
                           capped=cap is not None,
                           ray_tile=ray_tile if k == 1 else T.RAY_TILE)
        assert T.LAUNCHES[key] == before.get(key, 0) + 1
        want = plain_on_card(T.tile_lists, g, acc.cluster_min,
                             acc.cluster_max, cap, ray_tile)
        _bits(got, want)
        assert not bool((got[1][:, 7] > 0).all()) and int(got[4].sum()) > 0


def test_list_builds_reach_no_plain_ops_on_the_card(setup, dev, monkeypatch):
    """The call sites of the list builds (the pack queries' lists, the
    bounce levels' dense refined lists, K3's group lists, camera mode's
    lists of a chunk, of a whole frame and through supertiles) run no
    `_frustum_slabs`, no `_compact_lists` and no camera extents in PyTorch
    on the card, but for the one that stays plain: the gathered
    refinement's recompaction."""
    accels, packs = setup
    a16, a128 = accels[16].to(dev), accels[128].to(dev)
    seen = []
    for name in ("_frustum_slabs", "_compact_lists", "_camera_tile_extents"):
        real = getattr(T, name)
        monkeypatch.setattr(T, name, lambda *a, _r=real, _n=name, **k:
                            seen.append(_n) or _r(*a, **k))
    g = packs[1].to(dev)
    na = a16.attr_blocks.shape[1]
    T.nearest_hit_attrs_soa(a16, g)                      # lists
    T.nearest_hit_attrs_soa(a128, g, wq=True)            # dense refined
    with monkeypatch.context() as mp:
        mp.setattr(packets, "_GROUP_BLOCK_BUDGET_BYTES", 1)
        args, _ = T._gstream_walk_args(a16, g, 1e-8, True, T.INF, na)
        assert args[1].shape[0] == 4                     # K3's groups
    offs = stratified_offsets(1).to(dev)
    T.nearest_hit_camera_soa(a16, offs, width=64, height=48, spp=1,
                             tile_base=0, tiles=4)       # camera mode
    T.nearest_hit_camera_soa(a16, offs, width=64, height=48, spp=1)
    monkeypatch.setattr(T, "_SUPERTILE_MIN_C", 0)
    before = dict(T.LAUNCHES)
    T.nearest_hit_camera_soa(a16, offs, width=64, height=48, spp=1)
    assert T.LAUNCHES["lists_camera_members"] == (
        before["lists_camera_members"] + 1)              # pooled
    assert seen == []


def test_a_direct_camera_query_is_one_list_launch(setup, dev):
    """A whole-frame camera query below `_SUPERTILE_MIN_C` clusters builds
    its lists in one launch of `rt_camera_lists`: no `lists_ext`, no
    pooled stage, no host sync."""
    from raytracing_tpu_torch.utils.profiling import COUNTERS

    accels, _ = setup
    offs = stratified_offsets(4, device=dev)
    before = dict(T.LAUNCHES)
    syncs = dict(COUNTERS.host)
    T.nearest_hit_camera_soa(accels[16].to(dev), offs, width=64, height=48,
                             spp=4)
    made = {k: v - before.get(k, 0) for k, v in T.LAUNCHES.items()
            if k.startswith("lists") and v != before.get(k, 0)}
    assert made == {"lists_camera": 1}, made
    assert {k: v for k, v in COUNTERS.host.items() if k.startswith("syncs.")
            } == {k: v for k, v in syncs.items() if k.startswith("syncs.")}


@pytest.mark.parametrize("camera", [False, True], ids=["pack", "camera"])
def test_frame_with_plain_list_builds_is_equal(dev, monkeypatch, camera):
    """A reference frame at 128 x 128 (4 spp, every level) bit-equal to the
    same frame with the two list-build wrappers on their plain versions."""
    cfg = RenderConfig(width=128, height=128, chunk_size=16384,
                       primary_shared_origin=camera)
    scene = build_default_scene(device=dev)
    acc = build_cluster_accel(scene.mesh, cluster_size=16)

    def frame():
        gen = torch.Generator(device=dev)
        gen.manual_seed(3)
        return render(scene, cfg, accel=acc, generator=gen)

    T.reset_launches()
    img = frame()
    assert T.LAUNCHES["lists_ext"] > 0
    assert T.LAUNCHES["lists" if not camera else "lists_camera"] > 0
    monkeypatch.setattr(T, "tile_lists", T.tile_lists_plain)
    monkeypatch.setattr(T, "lists_from_extents", T.lists_from_extents_plain)
    monkeypatch.setattr(T, "camera_lists", _plain_camera_lists(monkeypatch))
    T.reset_launches()
    plain = frame()
    assert (T.LAUNCHES["lists"] == T.LAUNCHES["lists_ext"]
            == T.LAUNCHES["lists_camera"] == 0)
    assert torch.equal(img, plain)


def _traced_reference_frame(dev, on):
    """The reference frame (`RenderConfig()`, CS 16 + the auto-built CS 128
    bounce accel) under `torch.profiler` with the spans `on` or off:
    (image, device operations, the runtime's launch and copy calls,
    rt.frame's host interval or None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from raytracing_tpu_torch.utils.profiling import tracing

    scene = build_default_scene(device=dev)
    acc = build_cluster_accel(scene.mesh, cluster_size=16)
    gen = torch.Generator(device=dev)
    render(scene, RenderConfig(), accel=acc, generator=gen.manual_seed(3))
    torch.cuda.synchronize()
    was = tracing(on)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            img = render(scene, RenderConfig(), accel=acc,
                         generator=gen.manual_seed(3))
            torch.cuda.synchronize()
    finally:
        tracing(was)
    evs = prof.events()
    ops = [e for e in evs if e.device_type == DeviceType.CUDA
           and not e.name.startswith("rt.")]
    calls = [e for e in evs if e.device_type != DeviceType.CUDA
             and e.name.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy",
                                    "cudaMemset"))]
    frames = [e.time_range for e in evs if e.name == "rt.frame"
              and e.device_type != DeviceType.CUDA]
    return img, ops, calls, frames[0] if frames else None


def test_spans_share_the_device_clock_and_change_nothing(dev):
    """A traced reference frame: the spans change neither the image nor
    the launches (the port's `LAUNCHES` and the runtime's launch and copy
    calls, equal, a frame's worth: 22,843 device operations a frame since
    the rest merge is one launch a query; the profiler's device operations
    within the 0-3 it drops at a session's start with the spans off too:
    38,746 and 38,743 in two untraced sessions of the frame before it, on
    an H100); every device
    operation starts inside rt.frame or after it (none before it opens:
    the spans and the CUDA activity are on one clock, the first operation
    inside it), and every launch and copy the runtime was asked for lies
    inside rt.frame."""
    T.reset_launches()
    img0, ops0, calls0, none = _traced_reference_frame(dev, False)
    launches0 = dict(T.LAUNCHES)
    T.reset_launches()
    img1, ops1, calls, frame = _traced_reference_frame(dev, True)
    assert none is None and frame is not None
    assert torch.equal(img0, img1) and T.LAUNCHES == launches0
    assert len(calls0) == len(calls) > 20000
    assert abs(len(ops0) - len(ops1)) <= 3 and len(ops1) > 20000
    starts = sorted(e.time_range.start for e in ops1)
    assert frame.start <= starts[0] <= frame.end
    assert calls and all(frame.start <= c.time_range.start
                         and c.time_range.end <= frame.end for c in calls)


@pytest.mark.parametrize("walk", ["k1_k2", "k3", "k4", "camera"])
def test_walk_visit_counters_on_the_card(setup, dev, monkeypatch, walk):
    """Under counting each walk kernel's visits are positive and at most
    its listed visits (K4 counts the listed ones), its lane tests the
    visits x its tile's rays x the cluster size; the frame's walks (K1,
    K2) over a counted reference frame likewise."""
    from raytracing_tpu_torch.utils.profiling import COUNTERS, counting

    accels, packs = setup
    g = packs[0].to(dev)
    was = counting(True)
    COUNTERS.reset()
    try:
        if walk == "k1_k2":
            scene = build_default_scene(device=dev)
            render(scene, RenderConfig(), accel=build_cluster_accel(
                scene.mesh, cluster_size=16))
            lanes = None
        elif walk == "k3":
            monkeypatch.setattr(packets, "_GROUP_BLOCK_BUDGET_BYTES", 1)
            T.nearest_hit_attrs_soa(accels[16].to(dev), g)
            lanes = T.RAY_TILE * 16
        elif walk == "k4":
            monkeypatch.setattr(T, "_WQ_IMPL", "grid")
            T.nearest_hit_attrs_soa(accels[128].to(dev), g, wq=True)
            lanes = T.RAY_TILE * 128
        else:
            T.nearest_hit_camera_soa(accels[16].to(dev),
                                     stratified_offsets(4).to(dev),
                                     width=128, height=96, spp=4)
            lanes = 1024 * 16
        c = COUNTERS.read()
    finally:
        counting(was)
    assert 0 < c["walk.visits"] <= c["walk.listed"]
    if walk == "k4":
        assert c["walk.visits"] == c["walk.listed"]
    if lanes is not None:
        assert c["walk.lane_tests"] == c["walk.visits"] * lanes
    else:
        assert c["walk.lane_tests"] >= c["walk.visits"] * 1024 * 16
        assert c["syncs.level"] > 0 and c["alive.level2"] > 0


# ---------------------------------------------------------------------------
# The rest-set merge (csrc/rest.cu) against its plain versions, every lane
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rest_accels(dev):
    """On the card: the default scene's CS 16 accel in objid mode (A = 4
    shading planes) and with a color per triangle (A = 9); the test
    scene of tests/test_torch_rest.py with 31 quads (64 rest rows: the
    default rest_max) and with 64 (130 rows, two staged runs of the
    kernel's 64)."""
    from test_torch_rest import rest_mesh

    scene = build_default_scene(device="cpu")
    return {"objid": build_cluster_accel(scene.mesh, cluster_size=16),
            "full": build_cluster_accel(_full_mode(scene.mesh),
                                        cluster_size=16),
            "quads64": build_cluster_accel(rest_mesh(small=31),
                                           cluster_size=16),
            "quads130": build_cluster_accel(rest_mesh(small=64),
                                            cluster_size=16, rest_max=200)}


def _rest_acc(rest_accels, key, dev):
    return rest_accels[key].to(dev)


def _rest_pack(n, dev, seed=5):
    """A seeded [8, n] pack: rays leaving points above the ground (y = -3)
    in random directions, two in three of them downward; one lane in ten
    dead (the merge computes them all the same)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lo = torch.tensor([[-10.0], [-2.9], [0.0]], device=dev)
    span = torch.tensor([[20.0], [6.0], [20.0]], device=dev)
    o = torch.rand((3, n), generator=g, device=dev) * span + lo
    d = torch.randn((3, n), generator=g, device=dev)
    down = torch.rand(n, generator=g, device=dev) < 0.67
    d[1] = torch.where(down, -d[1].abs(), d[1])
    alive = (torch.rand(n, generator=g, device=dev) > 0.1).float()
    return torch.cat([o, torch.ones((1, n), device=dev), d,
                      alive[None]]).contiguous()


def _walk_like(n, n_attrs, dev, seed=6):
    """Walk results to merge into: t +inf (a miss) on half the lanes, else
    uniform in [0, 30); slots and attributes random."""
    g = torch.Generator(device=dev).manual_seed(seed)
    t = torch.rand((1, n), generator=g, device=dev) * 30.0
    t = torch.where(torch.rand((1, n), generator=g, device=dev) < 0.5,
                    float("inf"), t)
    slot = torch.randint(0, 1000, (1, n), generator=g, device=dev,
                         dtype=torch.int32)
    attrs = (torch.rand((n_attrs, n), generator=g, device=dev)
             if n_attrs else None)
    return t, slot, attrs


def _clones(*xs):
    return tuple(None if x is None else x.clone() for x in xs)


def _rest_equal(got, want):
    """Equal on every lane, floats by their bits."""
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def _rest_nearest(acc, p, walk_out, na, kind="shade"):
    """(kernel, plain) nearest merges of the pack p into copies of walk_out;
    the kernel's in place, one launch."""
    want = T._merge_rest_nearest_rows(acc, *T._rows(p), *_clones(*walk_out),
                                      1e-8, na, kind)
    mine = _clones(*walk_out)
    before = T.LAUNCHES["rest_merge"]
    got = T._merge_rest_nearest(acc, p, *mine, 1e-8, na, kind)
    assert T.LAUNCHES["rest_merge"] == before + 1
    assert all(a is b for a, b in zip(got, mine))       # in place
    return got, want


@pytest.mark.parametrize("mode,kind", [
    ("objid", None), ("objid", "shade"), ("full", "shade"), ("full", "grad"),
    ("full", "both")], ids=["A0", "A4", "A9", "A11", "A20"])
@pytest.mark.parametrize("n", [65536, 720896])
def test_rest_merge_pack_matches_plain(rest_accels, dev, n, mode, kind):
    """The pack merge at a primary chunk's and a bounce wavefront's size,
    with no attributes and with each attribute table the queries carry,
    bit-equal to the plain version on every lane, dead ones too."""
    acc = _rest_acc(rest_accels, mode, dev)
    na = 0 if kind is None else T._n_attrs(acc, kind)
    assert na == {None: 0, "shade": 4 if mode == "objid" else 9,
                  "grad": 11, "both": 20}[kind]
    p = _rest_pack(n, dev)
    walk_out = _walk_like(n, na, dev)
    got, want = _rest_nearest(acc, p, walk_out, na, kind or "shade")
    _rest_equal(got, want)
    took = want[0] < walk_out[0]
    assert 0.05 < float(took.float().mean()) < 0.95


@pytest.mark.parametrize("limit", ["inf", "finite", "tmax_row"])
def test_rest_merge_occlusion_matches_plain(rest_accels, dev, limit):
    """The occlusion merge on a wavefront's 720,896 rays, under no limit,
    a finite scalar t_max and per-ray limits: the flags OR-ed in place,
    bit-equal to the plain version."""
    acc = _rest_acc(rest_accels, "objid", dev)
    n = 720896
    p = _rest_pack(n, dev, seed=7)
    g = torch.Generator(device=dev).manual_seed(8)
    occ = torch.rand(n, generator=g, device=dev) < 0.2
    t_max = 7.5 if limit == "finite" else T.INF
    row = ((torch.rand((1, n), generator=g, device=dev) * 15.0).contiguous()
           if limit == "tmax_row" else None)
    want = T._merge_rest_occlusion(acc, p, occ.clone(), 1e-8, t_max, row)
    mine = occ.clone()
    before = T.LAUNCHES["rest_merge"]
    got = T._merge_rest_any_hit(acc, p, mine, 1e-8, t_max, row)
    assert T.LAUNCHES["rest_merge"] == before + 1 and got is mine
    assert torch.equal(got, want)
    assert bool((want & ~occ).any()) and not bool(want.all())


@pytest.mark.parametrize("case", ["frame", "frame_attrs", "chunk_overrun"])
def test_rest_merge_camera_matches_plain(rest_accels, dev, case):
    """Camera mode: the whole 800x800x4 frame (2,560,000 rays, without and
    with the shading planes) and a chunk of 64 blocks from block 2,480,
    whose last 44 lie past the frame and repeat its last block; the
    directions derived in the kernel, bit-equal to `_camera_dir_rows`."""
    acc = _rest_acc(rest_accels, "objid", dev)
    cfg = RenderConfig()
    cam = T.Camera(cfg.width, cfg.height, cfg.samples_per_pixel, cfg.scale,
                   16, 16)
    offs = stratified_offsets(cfg.samples_per_pixel).to(dev)
    tile0, nt = (2480, 64) if case == "chunk_overrun" else (0, 2500)
    n = nt * cam.ray_tile
    na = 0 if case == "frame" else acc.attr_blocks.shape[1]
    walk_out = _walk_like(n, na, dev, seed=9)
    d_rows = T._camera_dir_rows(n, offs, cam, tile0 * cam.ray_tile)
    zero = torch.zeros_like(d_rows[0])
    want = T._merge_rest_nearest_rows(acc, (zero, zero, zero), d_rows,
                                      *_clones(*walk_out), 1e-8, na)
    mine = _clones(*walk_out)
    before = T.LAUNCHES["rest_merge"]
    got = T._merge_rest_camera(acc, offs, cam, tile0, *mine, 1e-8, na)
    assert T.LAUNCHES["rest_merge"] == before + 1
    assert all(a is b for a, b in zip(got, mine))
    _rest_equal(got, want)
    assert bool((want[1] >= acc.order.shape[0]).any())


def test_rest_merge_lanes_one_a_thread(rest_accels, dev):
    """Where the rays are not a multiple of 4, a thread takes one lane:
    a pack of 1,001 rays (nearest with attributes, and occlusion) and a
    27x27 camera frame in 3x3 blocks (729 rays)."""
    acc = _rest_acc(rest_accels, "objid", dev)
    na = acc.attr_blocks.shape[1]
    p = _rest_pack(1001, dev, seed=10)
    got, want = _rest_nearest(acc, p, _walk_like(1001, na, dev), na)
    _rest_equal(got, want)
    occ = torch.zeros(1001, dtype=torch.bool, device=dev)
    want = T._merge_rest_occlusion(acc, p, occ.clone(), 1e-8, 9.0)
    assert torch.equal(T._merge_rest_any_hit(acc, p, occ, 1e-8, 9.0), want)
    cam = T.Camera(27, 27, 1, 1.0, 3, 3)
    offs = stratified_offsets(1).to(dev)
    walk_out = _walk_like(729, 0, dev)
    d_rows = T._camera_dir_rows(729, offs, cam)
    zero = torch.zeros_like(d_rows[0])
    want = T._merge_rest_nearest_rows(acc, (zero, zero, zero), d_rows,
                                      *_clones(*walk_out), 1e-8, 0)
    got = T._merge_rest_camera(acc, offs, cam, 0, *_clones(*walk_out), 1e-8,
                               0)
    _rest_equal(got, want)


def test_rest_merge_ties_on_the_card(rest_accels, dev):
    """Rays through the ground's shared diagonal: where both ground rows
    give the same t the lowest rest index wins, and a walk hit at the rest
    set's t keeps its slot and attributes; a copy of the ground (rows 2
    and 3) never wins over rows 0 and 1."""
    from test_torch_rest import _diagonal_rays

    acc = _rest_acc(rest_accels, "quads64", dev)
    s0 = acc.order.shape[0]
    n = 65536
    o, d = (x.to(dev) for x in _diagonal_rays(n))
    p = torch.cat([o, torch.ones((1, n), device=dev), d,
                   torch.ones((1, n), device=dev)]).contiguous()
    t_r = T._rest_t_rows(*T._rows(p), acc.rest_blocks, 1e-8)
    tmin = t_r.amin(dim=0)
    tie = torch.isfinite(tmin) & (t_r[0] == tmin) & (t_r[1] == tmin)
    assert int(tie.sum()) > 1000
    na = acc.attr_blocks.shape[1]
    t, slot, attrs = _walk_like(n, na, dev)
    half = torch.arange(n, device=dev) % 2 == 0
    t = torch.where(half, tmin, float("inf"))[None].contiguous()
    got, want = _rest_nearest(acc, p, (t, slot, attrs), na)
    _rest_equal(got, want)
    assert torch.equal(got[1][0][half], slot[0][half])   # the walk keeps it
    assert bool((got[1][0][tie & ~half] == s0).all())
    copy = s0 + torch.tensor([2, 3], device=dev)
    assert not bool(torch.isin(got[1][0][~half], copy).any())


@pytest.mark.parametrize("key", ["quads64", "quads130"])
def test_rest_merge_many_rest_rows(rest_accels, dev, key):
    """Rest sets of several small objects: 64 rows (one staged run) and
    130 (three runs of at most 64, ties across runs kept by the lowest
    index), nearest with attributes and occlusion, bit-equal."""
    acc = _rest_acc(rest_accels, key, dev)
    rr = acc.rest_blocks.shape[0]
    assert rr == {"quads64": 64, "quads130": 130}[key]
    na = acc.attr_blocks.shape[1]
    n = 65536
    p = _rest_pack(n, dev, seed=11)
    walk_out = _walk_like(n, na, dev)
    got, want = _rest_nearest(acc, p, walk_out, na)
    _rest_equal(got, want)
    j = want[1][want[0] < walk_out[0]] - acc.order.shape[0]
    assert int(j.max()) >= 4 and len(torch.unique(j)) > 8
    if rr > 64:
        assert int(j.max()) < 66    # quads 32 on repeat rows 2-65
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    want = T._merge_rest_occlusion(acc, p, occ.clone(), 1e-8, 12.0)
    assert torch.equal(T._merge_rest_any_hit(acc, p, occ, 1e-8, 12.0), want)


def test_rest_merge_refuses_bad_inputs(rest_accels, dev):
    """A non-contiguous or wrong-dtype input raises, the kernel's entry
    refuses an empty rest set, and nothing falls back to the plain
    version."""
    acc = _rest_acc(rest_accels, "objid", dev)
    na = acc.attr_blocks.shape[1]
    n = 4096
    p = _rest_pack(n, dev)
    t, slot, attrs = _walk_like(n, na, dev)
    bad = [
        (p, t.repeat(1, 2)[:, ::2], slot, attrs),              # strided t
        (p, t, slot.long(), attrs),                            # i64 slots
        (p.double(), t, slot, attrs),                          # f64 rays
        (p, t, slot, attrs.T.contiguous().T),                  # strided attrs
        (torch.cat([p, p], 1)[:, ::2], t, slot, attrs),        # strided rays
    ]
    before = T.LAUNCHES["rest_merge"]
    for args in bad:
        with pytest.raises(ValueError, match="rest_merge"):
            T._merge_rest_nearest(acc, *args, 1e-8, na)
    with pytest.raises(ValueError, match="rest_merge"):
        T._merge_rest_any_hit(acc, p, torch.zeros(n, device=dev), 1e-8,
                              T.INF)
    assert T.LAUNCHES["rest_merge"] == before
    lib = cuda.library()
    with pytest.raises(RuntimeError, match="rest_merge kernel launch"):
        cuda.check(lib.rt_rest_merge(
            T._ptr(p), n, None, 0, 0, 0, 0, 0, 0, 0.0, 0.0,
            T._ptr(acc.rest_blocks), 0, None, 0, None, 0, 0, 1e-8, 0,
            T.INF, None, T._ptr(t), T._ptr(slot), None, None, T._stream(p)),
            "rest_merge")


# --- the area-light frame at the 1.6M teapot's shapes ----------------------

LIGHT = ([[1.0, 8.0, 7.0]], [1.5], [[1.5, 1.5, 1.5]])


def _sphere_light(dev):
    from raytracing_tpu_torch.geometry.mesh import SphereLight

    return SphereLight(*(torch.tensor(v, device=dev) for v in LIGHT))


@pytest.fixture(scope="module")
def teapot_1m6(dev):
    """The 1,617,920-triangle teapot and its one CS 128 accel (12,640
    clusters, over the group budget), as the cell teapot_1m6.arealight
    builds them."""
    mesh = subdivided_teapot_mesh(levels=4, device=dev)
    return mesh, build_cluster_accel(mesh, cluster_size=128)


def test_area_light_launches_of_the_1m6_chunk_match_plain(
        teapot_1m6, dev, monkeypatch, plain_on_card):
    """The shadow queries of one chunk's area-light term, as the renderer
    makes them at the 1.6M frame's shapes (800x800x4, chunks of 65,536,
    a fan of 10, 4 light samples): level 1's 65,536 rays through K3 under
    the per-ray t_max, level 2's 720,896 binned rays through K5 gathered
    and K2 under it. Each query's flags equal its plain version's on the
    alive lanes."""
    from raytracing_tpu_torch.models import whitted

    mesh, accel = teapot_1m6
    cfg = RenderConfig(light_samples=4)
    calls = []
    real = whitted.any_hit

    def spy(mesh_, acc, o, d, config, t_max=T.INF, **kw):
        before = dict(T.LAUNCHES)
        out = real(mesh_, acc, o, d, config, t_max=t_max, **kw)
        if isinstance(t_max, torch.Tensor):
            made = {k for k, v in T.LAUNCHES.items() if v != before.get(k)}
            calls.append((acc, o.clone(), d.clone(), t_max.clone(), kw,
                          out.clone(), made))
        return out

    monkeypatch.setattr(whitted, "any_hit", spy)
    # Chunk 9 of the frame's 40 runs across the teapot.
    ids = block_ray_ids(9, cfg.chunk_size, cfg, 16, 16, device=dev)
    o, d = camera_rays_for_ids(ids, cfg)
    gen = torch.Generator(device=dev).manual_seed(3)
    sun = torch.tensor([0.0, 25_000.0, 100_000.0], device=dev)
    img = whitted.render_rays(
        mesh, accel, sun, o, d, cfg,
        lambda tag, shape: torch.rand(shape, generator=gen, device=dev),
        lights=_sphere_light(dev))
    assert bool(torch.isfinite(img).all())
    rays = [c[1].shape[0] for c in calls]
    assert rays == [65_536] * 4 + [720_896] * 4
    for acc, o_, d_, tm, kw, got, made in calls:
        alive = kw["alive"]
        assert bool(alive.any())
        if o_.shape[0] == 65_536:
            assert "walk_gstream" in made
        else:
            assert {"walk_dma", "refine_lists"} <= made
        want = plain_on_card(real, mesh, acc, o_, d_, cfg, t_max=tm, **kw)
        assert torch.equal(got[alive], want[alive])


def test_area_light_frame_on_the_card_is_the_same_binned_or_not(dev):
    """A reduced area-light frame (the default scene at 128x128x4 in four
    chunks, CS 16 and the auto-built CS 128 bounce accel, 4 light
    samples) is the same bit for bit with its bounce levels binned and
    not: each ray keeps its row's light draw."""
    from raytracing_tpu_torch.geometry.mesh import Scene

    base = build_default_scene(device=dev)
    lit = Scene(base.mesh, base.sun, _sphere_light(dev))
    accel = build_cluster_accel(base.mesh, cluster_size=16)
    cfg = RenderConfig(width=128, height=128, chunk_size=16384,
                       light_samples=4)
    imgs = [render(lit, cfg.replace(bin_secondary=b), accel=accel,
                   generator=torch.Generator(device=dev).manual_seed(5))
            for b in (True, False)]
    assert torch.equal(imgs[0], imgs[1])
    dark = render(base, cfg, accel=accel,
                  generator=torch.Generator(device=dev).manual_seed(5))
    assert float((imgs[0] - dark).max()) > 1e-3


# --- the area lights' glue, csrc/light.cu -----------------------------------

def _light_inputs(n, dev, columns, seed=0):
    """Shaded points around the benchmark's light: some inside it, some at
    its centre, some level with it (the tangent frame's other axis),
    normals every way, 80% hits; pos and n row-major or column-major (the
    kernel path's attribute planes); albedo/pi and colour likewise."""
    g = torch.Generator().manual_seed(seed)
    lo = torch.tensor([-6.0, -3.0, 0.0])
    pos = lo + torch.rand(n, 3, generator=g) * torch.tensor([12.0, 12.0, 14.0])
    pos[::89] = torch.tensor(LIGHT[0][0])
    pos[::97, 2] = LIGHT[0][0][2]
    nrm = torch.randn(n, 3, generator=g)
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    attrs = torch.rand(4, n, generator=g)
    hit = torch.rand(n, generator=g) < 0.8
    if columns:
        pos, nrm = (x.T.contiguous().T for x in (pos, nrm))
        rows = attrs.T                      # strides (1, n)
    else:
        rows = attrs.T.contiguous()         # strides (4, 1)
    color, alb = rows[:, :3], rows[:, 3]
    return [x.to(dev) for x in (pos, nrm, hit, alb, color)]


def _lights2(dev):
    """The benchmark's light and a second one in front of the teapots."""
    from raytracing_tpu_torch.geometry.mesh import SphereLight

    return SphereLight(
        torch.tensor(LIGHT[0] + [[-2.0, 3.0, 1.0]], device=dev),
        torch.tensor(LIGHT[1] + [0.7], device=dev),
        torch.tensor(LIGHT[2] + [[0.4, 0.6, 0.9]], device=dev))


@pytest.mark.parametrize("n,binned,columns,ns", [
    (65_536, False, False, 4), (720_896, True, False, 4),
    (65_536, False, True, 3), (720_896, True, True, 4)],
    ids=["level1", "binned", "level1-columns-ns3", "binned-columns"])
def test_light_kernels_match_plain(dev, n, binned, columns, ns):
    """At the 1.6M frame's two shapes (level 1's 65,536 rays, and the
    binned level's 720,896 with a permuted `rows`), row- and column-major:
    each sample's direction, n·l, alive flag and t_max from `light_sample`
    have the bits of `light_cone` + `light_shadow_rays`, and the term that
    `light_fold` folds over two lights and ns samples (seeded occlusion)
    has the bits of the plain estimator. Two launches a sample, none
    more."""
    from raytracing_tpu_torch.kernels import light as LK
    from raytracing_tpu_torch.models import whitted

    pos, nrm, hit, alb, color = _light_inputs(n, dev, columns)
    lights = _lights2(dev)
    g = torch.Generator(device=dev).manual_seed(4)
    rows = torch.randperm(n, generator=g, device=dev) if binned else None
    acc = torch.empty(n, device=dev)
    total = torch.empty(n, 3, device=dev)
    want = torch.zeros_like(pos)
    before = dict(T.LAUNCHES)
    for li in range(2):
        cone = whitted.light_cone(lights, li, pos)
        acc_p = torch.zeros_like(cone.dist)
        for s in range(ns):
            u = torch.rand(n, 2, generator=g, device=dev)
            u[::101] = 0.0
            occ = torch.rand(n, generator=g, device=dev) < 0.3
            got = LK.light_sample(pos, nrm, hit, u, rows, lights, li)
            plain = whitted.light_shadow_rays(
                cone, pos, nrm, hit, u if rows is None else u[rows])
            _bits(got, plain)
            assert bool(got[2].any()) and not bool(got[2].all())
            LK.light_fold(acc, total, got[2], occ, got[1], s, ns, li,
                          lights, pos, alb, color)
            vis = plain[2] & ~occ
            acc_p = acc_p + torch.where(vis, torch.clamp_min(plain[1], 0.0),
                                        0.0)
            if s < ns - 1:  # the last fold writes the term, not acc
                _bits([acc], [acc_p])
        want = want + ((acc_p / ns * cone.omega)[:, None]
                       * lights.emission[li])
    want = want * alb[:, None] * color
    _bits([total], [want])
    assert float(want.abs().max()) > 0
    assert T.LAUNCHES["light_sample"] - before["light_sample"] == 2 * ns
    assert T.LAUNCHES["light_fold"] - before["light_fold"] == 2 * ns


def _lit_frame(scene, lights, cfg, accel, dev, seed=5):
    from raytracing_tpu_torch.geometry.mesh import Scene

    return render(Scene(scene.mesh, scene.sun, lights), cfg, accel=accel,
                  generator=torch.Generator(device=dev).manual_seed(seed))


@pytest.mark.parametrize("case", ["default", "teapot_1m6"])
def test_light_frame_equals_the_plain_frame(dev, monkeypatch, request, case):
    """A whole area-light frame (bounce levels binned, 4 light samples)
    through the kernels is the frame of the plain functions bit for bit:
    the default scene at 128x128x4 with the CS 128 bounce accel, and the
    benchmark cell's frame (800x800x4 on the 1.6M teapot). On the kernel
    run `area_light.fused` equals `rays.area_light` and each sample is one
    `light_sample` and one `light_fold`; the plain run launches neither."""
    from raytracing_tpu_torch.models import whitted
    from raytracing_tpu_torch.utils import profiling as P

    if case == "default":
        scene = build_default_scene(device=dev)
        accel = build_cluster_accel(scene.mesh, cluster_size=16)
        cfg = RenderConfig(width=128, height=128, chunk_size=16384,
                           light_samples=4)
    else:
        from raytracing_tpu_torch.geometry.mesh import Scene

        mesh, accel = request.getfixturevalue("teapot_1m6")
        scene = Scene(mesh, torch.tensor([0.0, 25_000.0, 100_000.0],
                                         device=dev))
        cfg = RenderConfig(light_samples=4)
    assert cfg.bin_secondary
    lights = _sphere_light(dev)
    P.COUNTERS.reset()
    img = _lit_frame(scene, lights, cfg, accel, dev)
    counts = P.COUNTERS.read()
    assert counts["area_light.fused"] == counts["rays.area_light"] > 0
    assert (counts["launches.light_sample"] == counts["launches.light_fold"]
            > 0)
    monkeypatch.setattr(whitted, "_fused_light", lambda *a: False)
    P.COUNTERS.reset()
    plain = _lit_frame(scene, lights, cfg, accel, dev)
    counts = P.COUNTERS.read()
    assert counts["area_light.fused"] == 0 < counts["rays.area_light"]
    assert counts["launches.light_sample"] == counts["launches.light_fold"] == 0
    assert torch.equal(img, plain)


def test_light_launches_do_not_depend_on_the_alive_share(teapot_1m6, dev,
                                                         monkeypatch):
    """The light's own glue (the operations `area_light_term` dispatches
    outside its any-hit queries, and `LAUNCHES`' light entries) over the
    1.6M teapot's frame at 128x128x4 is the same with the benchmark's
    light above and behind the teapot and with it in front of it (z = -1),
    where many times more of its shadow rays are alive: every lane is
    prepared and folded, alive or not."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from raytracing_tpu_torch.geometry.mesh import Scene, SphereLight
    from raytracing_tpu_torch.models import whitted
    from raytracing_tpu_torch.utils import profiling as P

    state = {"term": 0, "query": 0}
    real_term, real_any = whitted.area_light_term, whitted.any_hit

    def term(*a, **kw):
        state["term"] += 1
        try:
            return real_term(*a, **kw)
        finally:
            state["term"] -= 1

    def any_hit(*a, **kw):
        state["query"] += 1
        try:
            return real_any(*a, **kw)
        finally:
            state["query"] -= 1

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if state["term"] and not state["query"]:
                Ops.n += 1
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(whitted, "area_light_term", term)
    monkeypatch.setattr(whitted, "any_hit", any_hit)
    mesh, accel = teapot_1m6
    scene = Scene(mesh, torch.tensor([0.0, 25_000.0, 100_000.0], device=dev))
    cfg = RenderConfig(width=128, height=128, chunk_size=16384,
                       light_samples=4)
    seen = []
    for z in (LIGHT[0][0][2], -1.0):
        lights = SphereLight(torch.tensor([[1.0, 8.0, z]], device=dev),
                             torch.tensor(LIGHT[1], device=dev),
                             torch.tensor(LIGHT[2], device=dev))
        Ops.n = 0
        P.COUNTERS.reset()
        was = P.counting(True)
        try:
            with Ops():
                _lit_frame(scene, lights, cfg, accel, dev)
            counts = P.COUNTERS.read()
        finally:
            P.counting(was)
        seen.append((Ops.n, counts["launches.light_sample"],
                     counts["launches.light_fold"],
                     counts["alive.area_light"] / counts["rays.area_light"]))
    (ops0, s0, f0, alive0), (ops1, s1, f1, alive1) = seen
    assert (ops0, s0, f0) == (ops1, s1, f1) and s0 > 0
    assert alive1 > 3 * alive0 > 0


def test_light_term_with_grad_on_the_card_runs_the_kernels(dev,
                                                           monkeypatch):
    """With the mesh tables and the lights' tables requiring grad, the
    term on the card still runs the kernels (`_KernelLightSum`: one
    `light_sample` and one `light_fold` a sample, `area_light.fused`
    equal to `rays.area_light`); its image has the bits of the frame
    without grad and of the plain functions' term (`_fused_light` off),
    and so do the lights' gradients. The mesh tables' gradients are summed
    in another order (the term's share of the points' gradient arrives as
    one tensor, and the card's scatter-adds are atomics, so two plain runs
    differ too): each within 1e-5 of its largest entry, GRAD_PARITY_RTOL
    (the verts' read 1.1e-6 on an H100)."""
    from raytracing_tpu_torch.geometry.mesh import SphereLight
    from raytracing_tpu_torch.models import whitted
    from raytracing_tpu_torch.utils import profiling as P

    scene = build_default_scene(device=dev)
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    cfg = RenderConfig(width=64, height=64, light_samples=4)
    o, d = camera_rays_for_ids(block_ray_ids(5, 4096, cfg, device=dev), cfg)
    fixed = _sphere_light(dev)

    def rays(grad):
        g = torch.Generator(device=dev).manual_seed(2)
        live = {k: getattr(scene.mesh, k).clone().requires_grad_(grad)
                for k in ("verts", "colors", "materials")}
        lights = SphereLight(*(t.clone().requires_grad_(grad)
                               for t in fixed))
        P.COUNTERS.reset()
        before = dict(T.LAUNCHES)
        with torch.set_grad_enabled(grad):
            rgb = whitted.render_rays(
                scene.mesh._replace(**live), accel, scene.sun, o, d, cfg,
                lambda tag, shape: torch.rand(shape, generator=g,
                                              device=dev),
                lights=lights)
        counts = P.COUNTERS.read()
        launched = [T.LAUNCHES[k] - before[k]
                    for k in ("light_sample", "light_fold")]
        if grad:
            (rgb * rgb).sum().backward()
        grads = [t.grad for t in (*live.values(), *lights)]
        return rgb.detach(), counts, launched, grads

    rgb, counts, launched, grads = rays(True)
    assert counts["area_light.fused"] == counts["rays.area_light"] > 0
    assert launched[0] == launched[1] > 0 and launched[0] % 4 == 0
    assert all(bool(torch.isfinite(t).all()) and float(t.abs().max()) > 0
               for t in grads)
    want, _, want_launched, _ = rays(False)
    assert launched == want_launched
    assert torch.equal(rgb, want)
    monkeypatch.setattr(whitted, "_fused_light", lambda *a: False)
    plain, counts, launched, plain_grads = rays(True)
    assert counts["area_light.fused"] == 0 and launched == [0, 0]
    assert torch.equal(plain, rgb)
    for got, ref in zip(grads[:3], plain_grads[:3]):
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    for got, ref in zip(grads[3:], plain_grads[3:]):
        assert torch.equal(got, ref)


# --- whole paths on the card at full width ----------------------------------

# A frame on the card against the CPU frame: torch's CUDA and CPU sin/cos
# in the sampler differ by ulps.
FRAME_PARITY_ATOL = 1e-4
SKY_ATOL = 1e-3
SKY = (torch.tensor([0x87, 0xCE, 0xEB]) / 255.0) ** (1 / 2.2)
# A frame against one of the same scene and camera with other samples
# (another cluster size, other chunks or shards): the means of 640,000
# pixels, in u8 counts, agree within the samples' noise, which averages far
# below half a count; a kernel that lost or misplaced hits would move whole
# regions.
CLI_MEAN_ATOL = 0.5
# A sharded or 2-process frame against the frame it must equal (the same
# rays through the same kernels: only the shards, chunks and bins differ).
MULTI_ATOL = 1e-5
# Card against CPU gradients, in units of each table's largest magnitude on
# the CPU: the backward's scatter-adds are atomics on the card, so sums come
# in another order, and the sampler's sin/cos differ by ulps between the
# devices. An H100 80GB HBM3 at 700 W read 7.6e-8 to 7.0e-7 over two runs.
GRAD_PARITY_RTOL = 1e-5
# The sharded train step's gradients against one unsharded Fitter step at
# 262,144 rays, in units of each table's largest magnitude, both under
# deterministic algorithms (two Fitter steps then read 0.0). Each entry
# sums the contributions of up to 2.9M rays in f32, and the two steps sum
# them in another order: the sharded step sums each shard's half, then the
# two halves. On an H100 80GB HBM3 (700 W) that order alone read 2.07e-5
# (verts), 1.52e-5 (colors) and 9.4e-6 (materials), above
# GRAD_PARITY_RTOL (held at 1,024 rays). The bar is the one the CPU tests
# hold a fit step to against JAX's (rtol 1e-4); a lost or doubled shard
# moves a gradient by half of itself.
TRAIN_STEP_RTOL = 1e-4


def _seeded(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _reference_accels(dev):
    """The default scene on the card, its CS 16 accel and the CS 128
    bounce accel."""
    scene = build_default_scene(device=dev)
    return (scene, build_cluster_accel(scene.mesh, cluster_size=16),
            build_cluster_accel(scene.mesh, cluster_size=128))


@pytest.mark.parametrize("camera", [False, True], ids=["pack", "camera"])
def test_reference_frame_on_the_card_launches_every_kernel(dev, camera):
    """The reference frame (800x800x4, CS 16 and the auto-built CS 128
    bounce accel), with pack-path or camera-mode primaries, launches the
    walks, the refinement, the list builds and the rest-set merge, and its
    corner pixel is the sky's colour; the frame is finite."""
    scene, acc16, _ = _reference_accels(dev)
    T.reset_launches()
    img = render(scene, RenderConfig(primary_shared_origin=camera),
                 accel=acc16)
    torch.cuda.synchronize()
    need = ["walk", "walk_dma", "refine_extents", "lists", "lists_ext",
            "rest_merge"] + (["walk_camera", "lists_camera"] if camera
                             else [])
    assert all(T.LAUNCHES[k] > 0 for k in need), dict(T.LAUNCHES)
    assert img.shape == (800, 800, 3) and bool(torch.isfinite(img).all())
    assert float((img[2, 2].cpu() - SKY).abs().max()) <= SKY_ATOL


def test_path_traced_frame_on_the_card_matches_the_cpu(dev):
    """The path tracer (4 bounces, chunks of 131,072 pixels, CS 16 and the
    auto-built CS 128 bounce accel) on the card: at 64x64 and 2 spp within
    FRAME_PARITY_ATOL of the CPU frame with the same uniforms; at 800x800
    and 64 spp (five chunks) finite, launching the walks, the refinement
    and the list builds, with the sky's colour in its corner."""
    from raytracing_tpu_torch import PathTracerConfig
    from raytracing_tpu_torch.models import path_tracer

    cfg = RenderConfig(width=64, height=64, chunk_size=131072)
    pt = PathTracerConfig(max_bounces=4, samples_per_pixel=2)
    draws = {}

    def uniforms(i, s, tag, shape):
        key = (i, s, tag)
        if key not in draws:
            g = torch.Generator().manual_seed(
                100000 * i + 1000 * s + 10 * tag[1] + (tag[0] == "scatter"))
            draws[key] = torch.rand(shape, generator=g)
        return draws[key]

    imgs = []
    for d in (dev, torch.device("cpu")):
        scene = build_default_scene(device=d)
        acc = build_cluster_accel(scene.mesh, cluster_size=16)
        T.reset_launches()
        imgs.append(path_tracer.render(
            scene, cfg, pt, accel=acc,
            uniforms=lambda i, s, tag, shape, d=d:
            uniforms(i, s, tag, shape).to(d)).cpu())
        if d.type == "cuda":
            launches = dict(T.LAUNCHES)
    assert bool(torch.isfinite(imgs[0]).all())
    assert float((imgs[0] - imgs[1]).abs().max()) <= FRAME_PARITY_ATOL
    assert float((imgs[0][2, 2] - SKY).abs().max()) <= SKY_ATOL
    assert all(launches[k] > 0 for k in ("walk", "walk_dma", "refine_extents",
                                         "lists", "lists_ext")), launches

    full = RenderConfig(width=800, height=800, chunk_size=131072)
    scene = build_default_scene(device=dev)
    acc = build_cluster_accel(scene.mesh, cluster_size=16)
    T.reset_launches()
    img = path_tracer.render(
        scene, full, PathTracerConfig(max_bounces=4, samples_per_pixel=64),
        accel=acc)
    torch.cuda.synchronize()
    launches = dict(T.LAUNCHES)
    assert img.shape == (800, 800, 3) and bool(torch.isfinite(img).all())
    assert float((img[2, 2].cpu() - SKY).abs().max()) <= SKY_ATOL
    assert all(launches[k] > 0 for k in ("walk", "walk_dma", "refine_extents",
                                         "lists", "lists_ext")), launches


def _by_entry(launches):
    """A frame's launches summed over the launch tiles ("walk_dma_rt128"
    counts as "walk_dma")."""
    import re

    out = {}
    for key, v in launches.items():
        if v:
            base = re.sub(r"_rt\d+$", "", key)
            out[base] = out.get(base, 0) + v
    return out


def _one_launch_a_call(composed, base):
    """Whether a frame at a composed tile made one launch a wrapper call,
    as the frame `base` at 1,024 did, where a list build from a pack is two
    launches at a composed tile: K6 at the launch tile, then the list build
    from its folded extents."""
    c, b = _by_entry(composed), _by_entry(base)
    moved = c.get("lists_ext", 0) - b.get("lists_ext", 0)
    c["extents"] = c.get("extents", 0) - moved
    c["lists_ext"] = c.get("lists_ext", 0) - moved
    c["lists"] = c.get("lists", 0) + moved
    return {k: v for k, v in c.items() if v} == b


NO_WQ, NO_LC = dict(gi_wq=False), dict(gi_lane_cull=False)
NO_COARSE = dict(gi_cluster_size=0)
# (id, config change, the change whose frame it must equal, patches): the
# bounce levels' settings that change no pixel of the reference frame.
BOUNCE_SETTINGS = (
    [("cap", dict(gi_cap_frac=0.1), {}, {}),
     ("gi_wq_false-lane_cull", NO_WQ, {**NO_WQ, **NO_LC}, {})]
    + [(f"tile{t}", dict(gi_ray_tile=t), {}, {})
       for t in (512, 256, 384, 2048)]
    + [(f"gi_wq_false-tile{t}", {**NO_WQ, "gi_ray_tile": t}, NO_WQ, {})
       for t in (256, 384, 2048)]
    + [("gi_wq_false-no_lane_cull-tile256",
        {**NO_WQ, **NO_LC, "gi_ray_tile": 256}, {**NO_WQ, **NO_LC}, {})]
    + [(f"grid-no_coarse-tile{t}", {**NO_COARSE, "gi_ray_tile": t},
        NO_COARSE, dict(impl="grid")) for t in (256, 128, 384, 2048)]
    + [("gi_wq_false-no_coarse-over_budget-tile256",
        {**NO_WQ, **NO_COARSE, "gi_ray_tile": 256}, {**NO_WQ, **NO_COARSE},
        dict(budget=1))])


@pytest.mark.parametrize("change,other,patch",
                         [c[1:] for c in BOUNCE_SETTINGS],
                         ids=[c[0] for c in BOUNCE_SETTINGS])
def test_bounce_settings_leave_the_reference_frame_the_same(
        dev, monkeypatch, change, other, patch):
    """The reference frame (800x800x4, CS 16) under a setting of its bounce
    levels equal bit for bit to the frame without it: the two-phase
    query's cap (gi_cap_frac 0.1), the lane cull on against off, and every
    culling tile (gi_ray_tile) against 1,024, under gi_wq=False, under
    `_WQ_IMPL = "grid"` with no coarse bounce accel, and with the group
    budget patched below one group. At the composed tiles (384, 2,048) a
    wrapper call is one launch, as at 1,024; the frame without the lane
    cull launches no lane-cull walk."""
    if "impl" in patch:
        monkeypatch.setattr(T, "_WQ_IMPL", patch["impl"])
    if "budget" in patch:
        monkeypatch.setattr(packets, "_GROUP_BLOCK_BUDGET_BYTES",
                            patch["budget"])
    scene = build_default_scene(device=dev)
    acc16 = build_cluster_accel(scene.mesh, cluster_size=16)
    imgs, launches = [], []
    for c in (change, other):
        T.reset_launches()
        imgs.append(render(scene, RenderConfig(**c), accel=acc16))
        torch.cuda.synchronize()
        launches.append(dict(T.LAUNCHES))
    assert bool(torch.isfinite(imgs[0]).all())
    assert torch.equal(imgs[0], imgs[1])
    if change.get("gi_ray_tile") in (384, 2048):
        assert _one_launch_a_call(*launches), launches
    for c, fl in zip((change, other), launches):
        if c.get("gi_lane_cull") is False:
            assert not any("_lc" in k and v for k, v in fl.items()), fl


# The camera query's hit share on the subdivided teapots: the camera frames
# the teapot, whose silhouette changes little with subdivision.
HIT_GATE_LARGE = (0.05, 0.95)


@pytest.mark.parametrize("levels,cs", [(3, 64), (4, 128), (5, 128)],
                         ids=["404k", "1m6", "6m4"])
def test_large_scene_camera_query_hits_a_plausible_share(dev, levels, cs):
    """`nearest_hit_camera_soa` at 800x800x4 on the subdivided teapot of
    404k (CS 64), 1.6M and 6.4M (CS 128) triangles launches the camera walk
    and hits within HIT_GATE_LARGE of its rays."""
    mesh = subdivided_teapot_mesh(levels=levels, device=dev)
    acc = build_cluster_accel(mesh, cluster_size=cs, variants=("pmt",))
    T.reset_launches()
    t, _ = T.nearest_hit_camera_soa(acc, stratified_offsets(4, device=dev),
                                    width=800, height=800, spp=4)
    torch.cuda.synchronize()
    walk = "walk_camera_dma" if cs % 128 == 0 else "walk_camera"
    assert T.LAUNCHES[walk] > 0, dict(T.LAUNCHES)
    frac = float(torch.isfinite(t).float().mean())
    assert HIT_GATE_LARGE[0] < frac < HIT_GATE_LARGE[1], frac


@pytest.mark.parametrize("levels", [3, 4], ids=["404k", "1m6"])
def test_large_scene_frame_on_the_card(dev, levels):
    """The reference frame (800x800x4) of the subdivided teapot under the
    sun, finite: at 404k triangles on CS 64 with a CS 128 bounce accel,
    launching the split walks, the gathered refinement and the list
    builds; at 1.6M on CS 128, its primary and shadow queries through K3
    (no K1 launch), the gathered refinement on its bounces, and no
    rest-set merge (one object)."""
    from raytracing_tpu_torch.geometry.mesh import Scene
    from raytracing_tpu_torch.geometry.scene import sun_position

    mesh = subdivided_teapot_mesh(levels=levels, device=dev)
    scene = Scene(mesh=mesh, sun=sun_position(0.0).to(dev))
    if levels == 3:
        acc = build_cluster_accel(mesh, cluster_size=64, variants=("pmt",))
        gi = build_cluster_accel(mesh, cluster_size=128, variants=("pmt",))
    else:
        acc = build_cluster_accel(mesh, cluster_size=128,
                                  variants=("pmt",))
        gi = None
    T.reset_launches()
    img = render(scene, RenderConfig(), accel=acc, gi_accel=gi)
    torch.cuda.synchronize()
    fl = dict(T.LAUNCHES)
    assert img.shape == (800, 800, 3) and bool(torch.isfinite(img).all())
    if levels == 3:
        assert all(fl[k] > 0 for k in ("refine_lists", "walk_dma", "walk",
                                        "lists")), fl
    else:
        assert fl["walk_gstream"] > 0 and fl["walk"] == 0, fl
        assert fl["refine_lists"] > 0 and fl["rest_merge"] == 0, fl


def test_area_light_frame_through_k4_is_the_k2_frame(dev, monkeypatch):
    """The reference frame lit by one spherical light (4 shadow samples)
    launches the walks, the refinement, the list builds and the light's
    glue, and is brighter than the frame without the light; with
    `_WQ_IMPL = "grid"` every bounce query goes through K4 and none through
    K2, and the frame from the same seed is the same bit for bit."""
    from raytracing_tpu_torch.geometry.mesh import Scene

    base, acc16, _ = _reference_accels(dev)
    lit = Scene(base.mesh, base.sun, _sphere_light(dev))
    cfg = RenderConfig(light_samples=4)
    imgs, launches = {}, {}
    for which in ("dma", "grid"):
        monkeypatch.setattr(T, "_WQ_IMPL", which)
        T.reset_launches()
        imgs[which] = render(lit, cfg, accel=acc16,
                             generator=_seeded(dev, 5))
        torch.cuda.synchronize()
        launches[which] = dict(T.LAUNCHES)
    dma, grid = launches["dma"], launches["grid"]
    assert all(dma[k] > 0 for k in ("walk", "walk_dma", "refine_extents",
                                    "lists", "lists_ext", "light_sample",
                                    "light_fold")), dma
    assert grid["walk_wq"] == dma["walk_dma"] > 0 == grid["walk_dma"], grid
    assert torch.equal(imgs["grid"], imgs["dma"])
    dark = render(base, cfg, accel=acc16, generator=_seeded(dev, 5))
    assert float(imgs["dma"].mean()) > float(dark.mean())


@pytest.mark.parametrize("case", ["cs16", "arealight", "gi128"])
def test_backward_262k_on_the_card(dev, case):
    """The backward cell of `bench_suite.py:80-130` on the card: the
    262,144 camera rays of blocks 90-105 of the reference frame through
    `render_rays`, loss sum(rgb^2), on the CS 16 accel, with one area light
    or with the CS 128 bounce accel. The forward under grad gives the loss
    of the forward without it, every gradient (verts, colors, materials)
    is finite and nonzero, and the walks that carry the backward's planes
    launch (and K2 and K5 dense with the bounce accel, the light's glue
    with the light)."""
    from raytracing_tpu_torch.models.whitted import render_rays

    scene, acc16, acc128 = _reference_accels(dev)
    gi = acc128 if case == "gi128" else None
    lights = _sphere_light(dev) if case == "arealight" else None
    cfg = RenderConfig()
    o, d = camera_rays_for_ids(torch.cat([
        block_ray_ids(i, 16384, cfg, 16, 16, device=dev)
        for i in range(90, 106)]), cfg)

    def run(grad):
        gen = _seeded(dev, 3)
        live = {k: getattr(scene.mesh, k).clone().requires_grad_(grad)
                for k in ("verts", "colors", "materials")}
        with torch.set_grad_enabled(grad):
            rgb = render_rays(scene.mesh._replace(**live), acc16, scene.sun,
                              o, d, cfg, lambda tag, shape: torch.rand(
                                  shape, generator=gen, device=dev),
                              gi_accel=gi, lights=lights)
            loss = (rgb * rgb).sum()
        if grad:
            loss.backward()
        return loss.detach(), live

    loss_f, _ = run(False)
    T.reset_launches()
    loss_b, live = run(True)
    torch.cuda.synchronize()
    assert bool(loss_f == loss_b), (float(loss_f), float(loss_b))
    for k, v in live.items():
        assert v.grad is not None and bool(v.grad.isfinite().all()) \
            and float(v.grad.abs().max()) > 0, k
    need = ["walk_both"] + (["walk_dma_both", "refine_extents"] if gi
                            is not None else []) + (
        ["light_sample", "light_fold"] if lights is not None else [])
    assert all(T.LAUNCHES[k] > 0 for k in need), dict(T.LAUNCHES)


def test_reference_gradients_on_the_card_match_the_cpu(dev):
    """The gradients of one `render_rays` over the 1,024 block-ordered
    rays of a 32x32 1-spp frame of the reference scene (CS 16 with the CS
    128 bounce accel, full depth), loss sum(rgb^2), on the card against
    the CPU port on the same rays and uniforms: each table within
    GRAD_PARITY_RTOL of its largest magnitude."""
    from raytracing_tpu_torch.models.whitted import render_rays

    cfg = RenderConfig(width=32, height=32, samples_per_pixel=1)
    draws = {}

    def uniforms(tag, shape):
        if tag not in draws:
            draws[tag] = torch.rand(shape, generator=torch.Generator()
                                    .manual_seed(len(draws) + 11))
        return draws[tag]

    names = ("verts", "normals", "colors", "materials")
    grads = []
    for d in (dev, torch.device("cpu")):
        scene = build_default_scene(device=d)
        acc = build_cluster_accel(scene.mesh, cluster_size=16)
        gi = build_cluster_accel(scene.mesh, cluster_size=128)
        o, dirs = camera_rays_for_ids(
            block_ray_ids(0, 1024, cfg, 16, 16, device=d), cfg)
        tables = {k: getattr(scene.mesh, k).clone().requires_grad_()
                  for k in names}
        rgb = render_rays(scene.mesh._replace(**tables), acc, scene.sun, o,
                          dirs, cfg, lambda tag, shape: uniforms(tag, shape)
                          .to(d), gi_accel=gi)
        (rgb * rgb).sum().backward()
        grads.append({k: v.grad.cpu() for k, v in tables.items()})
    for k in names:
        card, cpu = grads[0][k], grads[1][k]
        scale = float(cpu.abs().max())
        assert bool(torch.isfinite(card).all()) and scale > 0, k
        err = float((card - cpu).abs().max())
        assert err <= GRAD_PARITY_RTOL * scale, (k, err, scale)


def test_fit_on_the_card_lowers_the_held_out_loss(dev, tmp_path):
    """The inverse fit at `cmd_fit`'s defaults (raytracing_tpu/app.py:
    221-243, 319-322): the CS 128 accel, the target the port's own
    800x800x4 render, colors x 0.5, 4,096 rays a step, Adam at lr 1e-2, 20
    steps, every loss finite. The loss on one fixed held-out batch of
    4,096 rays falls, a checkpoint saved at step 10 loads back bit for bit,
    and the steps launch the walks that carry the backward's planes."""
    from raytracing_tpu_torch.models import inverse
    from raytracing_tpu_torch.utils import checkpoint as ckpt

    cfg = RenderConfig(chunk_size=16384)
    scene, _, acc128 = _reference_accels(dev)
    target = render(scene, cfg, accel=acc128)
    fitter = inverse.Fitter(scene, target,
                            {"colors": scene.mesh.colors * 0.5}, cfg,
                            accel=acc128, learning_rate=1e-2)

    def draws(seed):
        gen = _seeded(dev, seed)
        return gen, (lambda tag, shape: torch.rand(shape, generator=gen,
                                                   device=dev))

    held = torch.randint(0, fitter.n_rays, (4096,),
                         generator=_seeded(dev, 123), device=dev)

    def held_loss():
        with torch.no_grad():
            return float(fitter.loss(held, draws(77)[1]))

    before = held_loss()
    gen, uniforms = draws(0)
    path = str(tmp_path / "fit_step10.npz")
    T.reset_launches()
    losses = []
    for i in range(20):
        idx = torch.randint(0, fitter.n_rays, (4096,), generator=gen,
                            device=dev)
        losses.append(fitter.step(idx, uniforms))
        if i + 1 == 10:
            st = fitter.state(10)
            ckpt.save(path, st["params"], st["opt_state"], step=10)
            snap = {"params": {k: v.clone() for k, v in st["params"].items()},
                    "state": {j: {n: v.clone() for n, v in e.items()}
                              for j, e in st["opt_state"]["state"].items()},
                    "groups": st["opt_state"]["param_groups"]}
    assert all(T.LAUNCHES[k] > 0 for k in ("walk_both", "walk_dma_both"))
    assert all(np.isfinite(losses)), losses
    assert held_loss() < before
    params, opt_state, step, _ = ckpt.load(path, snap["params"],
                                           fitter.optimizer.state_dict())
    assert step == 10 and opt_state["param_groups"] == snap["groups"]
    assert all(torch.equal(params[k], v) for k, v in snap["params"].items())
    assert all(torch.equal(opt_state["state"][j][n], v)
               for j, e in snap["state"].items() for n, v in e.items())


def test_fit_step_retried_after_out_of_memory_on_the_card(dev, monkeypatch,
                                                          tmp_path):
    """A fit of 3 steps whose second step fails after `optimizer.step()`
    with a real out-of-memory error, retried, ends with the params and
    losses of a clean fit bit for bit (both under deterministic
    algorithms, so the backward's scatter-adds sum in one order)."""
    from raytracing_tpu_torch.models import inverse

    scene, acc16, _ = _reference_accels(dev)
    cfg = RenderConfig(width=64, height=64, samples_per_pixel=1)
    target = render(scene, cfg, accel=acc16)

    def run(**kw):
        return inverse.fit(scene, target,
                           {"colors": scene.mesh.colors * 0.5}, cfg,
                           accel=acc16, steps=3, rays_per_step=1024,
                           generator=_seeded(dev, 9), **kw)

    real_step = inverse.Fitter.step
    calls = []

    def faulty(self, idx, uniforms):
        loss = real_step(self, idx, uniforms)
        calls.append(1)
        if len(calls) == 2:
            torch.empty(2 ** 45, dtype=torch.uint8, device=dev)
        return loss

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        clean = run()
        monkeypatch.setattr(inverse.Fitter, "step", faulty)
        retried = run(retries=2, checkpoint_path=str(tmp_path / "r.npz"))
    finally:
        torch.use_deterministic_algorithms(was)
    assert len(calls) == 4
    assert retried.losses == clean.losses
    assert torch.equal(retried.params["colors"], clean.params["colors"])


def test_cli_bench_on_the_card(dev, capsys):
    """`python -m raytracing_tpu_torch bench`: one record naming the card,
    a positive primary rays/s and a plausible hit fraction."""
    from raytracing_tpu_torch import app, bench

    app.main(["bench"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "primary_rays_per_s_per_chip_teapot"
    assert rec["unit"] == "rays/s" and rec["value"] > 0
    assert rec["device"] == torch.cuda.get_device_name(0)
    assert bench.HIT_GATE[0] < rec["hit_fraction"] < bench.HIT_GATE[1]


def test_cli_render_through_an_accel_cache_on_the_card(dev, tmp_path,
                                                       capsys):
    """`render` of the reference frame (CS 16 with the CS 128 bounce
    accel, chunks of 65,536) twice through an accel cache, built and
    saved, then loaded: the loaded accel is a fresh build field by field,
    on the card, and both PNGs are `to_u8` of `render()` with the same
    seed, bit for bit."""
    from raytracing_tpu_torch import app
    from raytracing_tpu_torch.ops.color import to_rgba_frame
    from raytracing_tpu_torch.utils.image import read_png

    cache = str(tmp_path / "accel16.npz")
    argv = ["render", "--cluster-size", "16", "--gi-cluster-size", "128",
            "--chunk-size", "65536", "--seed", "0", "--accel-cache", cache]
    pngs = []
    for how in ("built", "loaded from"):
        pngs.append(str(tmp_path / f"ref_{len(pngs)}.png"))
        app.main(argv + ["--out", pngs[-1]])
        assert f"16, {how}" in capsys.readouterr().out
    scene, acc16, acc128 = _reference_accels(dev)
    loaded = packets.load_accel(cache, mesh=scene.mesh, cluster_size=16)
    for name in packets.ClusterAccel._fields:
        a, b = getattr(acc16, name), getattr(loaded, name)
        assert (a is None) == (b is None), name
        assert a is None or (b.is_cuda and torch.equal(a, b)), name
    want = to_rgba_frame(render(scene, RenderConfig(), accel=acc16,
                                gi_accel=acc128, generator=_seeded(dev, 0)))
    for png in pngs:
        assert np.array_equal(read_png(png), want), png


def test_cli_render_at_its_defaults_on_the_card(dev, tmp_path):
    """`render` at the CLI's defaults (800x800x4, CS 128, chunks of
    16,384) launches the walks, the refinement and the list builds; its
    PNG has the sky's colour in its corner and the reference frame's mean
    within CLI_MEAN_ATOL u8 (the same scene and camera, other samples)."""
    from raytracing_tpu_torch import app
    from raytracing_tpu_torch.ops.color import to_rgba_frame
    from raytracing_tpu_torch.utils.image import read_png

    png = str(tmp_path / "defaults.png")
    T.reset_launches()
    app.main(["render", "--out", png])
    torch.cuda.synchronize()
    assert all(T.LAUNCHES[k] > 0 for k in ("walk", "walk_dma",
                                           "refine_extents", "lists",
                                           "lists_ext")), dict(T.LAUNCHES)
    scene, acc16, acc128 = _reference_accels(dev)
    want = to_rgba_frame(render(scene, RenderConfig(), accel=acc16,
                                gi_accel=acc128, generator=_seeded(dev, 0)))
    img = read_png(png)
    sky = np.round(255 * SKY.numpy().astype(np.float64))
    assert img.shape == want.shape
    assert np.abs(img[2, 2, :3] - sky).max() <= 1, img[2, 2]
    assert abs(float(img[..., :3].mean())
               - float(want[..., :3].mean())) <= CLI_MEAN_ATOL


def test_cli_render_profile_on_the_card(dev, tmp_path):
    """`render --profile` on the card writes a trace that names the walk
    and refinement kernels."""
    from raytracing_tpu_torch import app

    prof = str(tmp_path / "prof")
    app.main(["render", "--width", "64", "--height", "64", "--cluster-size",
              "16", "--gi-cluster-size", "128", "--profile", prof, "--out",
              str(tmp_path / "small.png")])
    with open(os.path.join(prof, "trace.json")) as f:
        trace = f.read()
    assert "walk_kernel" in trace and "refine_kernel" in trace


def test_cli_fit_checkpoint_and_resume_on_the_card(dev, tmp_path,
                                                   monkeypatch, capsys):
    """`fit` at its defaults for 60 steps with a checkpoint: snapshots at
    steps 50 and 60, the step-50 one holding the live params (neither the
    start nor the end); `--resume` for 5 more goes on to step 65, Adam's
    count with it; every loss finite."""
    from raytracing_tpu_torch import app
    from raytracing_tpu_torch.utils import checkpoint as ckpt

    ck = str(tmp_path / "fit.npz")
    saved = []
    real_save = ckpt.save

    def spy(path, params, opt_state=None, step=0, metadata=None):
        saved.append((step, {k: v.clone() for k, v in params.items()}))
        real_save(path, params, opt_state, step, metadata)

    monkeypatch.setattr(ckpt, "save", spy)
    app.main(["fit", "--steps", "60", "--checkpoint", ck])
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [st for st, _ in saved] == [50, 60]
    start = build_default_scene(device=dev).mesh.colors * 0.5
    mid, end = saved[0][1]["colors"], saved[1][1]["colors"]
    assert not torch.equal(mid, start) and not torch.equal(mid, end)
    app.main(["fit", "--steps", "5", "--checkpoint", ck, "--resume"])
    out = capsys.readouterr().out
    last = json.loads(out.strip().splitlines()[-1])
    assert f"resumed from {ck} @ step 60" in out
    _, opt_state, step, _ = ckpt.load(ck, {"colors": start})
    assert step == 65 and float(opt_state["state"][0]["step"]) == 65
    assert all(np.isfinite([v for rec in (first, last)
                            for v in rec.values()]))


def test_cli_animate_on_the_card(dev, tmp_path, capsys):
    """`animate --frames 3 --out-pattern` at the reference frame's
    settings writes 3 full-size PNGs and an fps line."""
    from raytracing_tpu_torch import app
    from raytracing_tpu_torch.utils.image import read_png

    pattern = str(tmp_path / "anim_{frame:03d}.png")
    app.main(["animate", "--cluster-size", "16", "--gi-cluster-size", "128",
              "--chunk-size", "65536", "--frames", "3", "--out-pattern",
              pattern])
    out = capsys.readouterr().out
    frames = [pattern.format(frame=i) for i in range(3)]
    assert all(os.path.exists(f) for f in frames)
    assert "rendered 3 frames in" in out and "fps avg" in out
    assert read_png(frames[2]).shape == (800, 800, 4)


def test_sharded_reference_frame_on_the_card_has_render_s_mean(dev):
    """`render_sharded` at the reference config (the diffuse fan on, CS 16
    and the auto-built CS 128 bounce accel) over 4 virtual shards of the
    card launches the walks, the refinement and the list builds; the frame
    is finite, its u8 mean within CLI_MEAN_ATOL of `render()`'s (the
    shards draw other samples)."""
    from raytracing_tpu_torch.ops.color import to_rgba_frame
    from raytracing_tpu_torch.parallel.shard import (make_device_mesh,
                                                     render_sharded)

    scene, acc16, _ = _reference_accels(dev)
    ref = RenderConfig()
    T.reset_launches()
    img = render_sharded(scene, ref, make_device_mesh(
        4, devices=["cuda:0"] * 4), accel=acc16, seed=0)
    torch.cuda.synchronize()
    assert all(T.LAUNCHES[k] > 0 for k in ("walk", "walk_dma",
                                           "refine_extents", "lists",
                                           "lists_ext")), dict(T.LAUNCHES)
    full = render(scene, ref, accel=acc16, generator=_seeded(dev, 0))
    assert bool(torch.isfinite(img).all())
    a, b = (to_rgba_frame(x)[..., :3].astype(np.float64) for x in (img, full))
    assert abs(a.mean() - b.mean()) <= CLI_MEAN_ATOL


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_two_processes_sharing_the_card_render_the_two_shard_frame(
        dev, tmp_path):
    """`render --num-processes 2 --assemble` of the reference frame in 2
    new processes of one gloo group sharing the card (NCCL refuses two
    ranks on one card): the stitched shards within MULTI_ATOL of the
    one-process 2-shard `render_sharded` frame."""
    import subprocess
    import sys

    from raytracing_tpu_torch.parallel import distributed as D
    from raytracing_tpu_torch.parallel import shard as S

    port = _free_port()
    png = str(tmp_path / "two.png")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "raytracing_tpu_torch", "render",
         "--cluster-size", "16", "--gi-cluster-size", "128", "--chunk-size",
         "65536", "--seed", "0", "--assemble", "--out", png,
         "--num-processes", "2", "--process-id", str(i), "--coordinator",
         f"localhost:{port}", "--dist-backend", "gloo"], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), outs
    assert f"wrote {png}" in outs[0] and os.path.exists(png)
    ref = RenderConfig()
    got = D.assemble_shards(png + ".shards", ref)
    scene, acc16, _ = _reference_accels(dev)
    two = S.render_sharded(scene, ref, S.make_device_mesh(
        2, devices=["cuda:0"] * 2), accel=acc16, seed=0).cpu().numpy()
    assert float(np.abs(got - two).max()) <= MULTI_ATOL


def test_one_rank_nccl_train_step_is_the_step_without_a_group(dev):
    """In a one-rank NCCL group on the card, `make_train_step` runs its
    all_reduce, and its step equals the step without a group bit for bit
    (both under deterministic algorithms)."""
    import functools

    from raytracing_tpu_torch.parallel import shard as S

    scene, acc16, _ = _reference_accels(dev)
    cfg = RenderConfig(width=64, height=64, samples_per_pixel=1)
    o, d = camera_rays_for_ids(block_ray_ids(0, 4096, cfg, device=dev), cfg)
    target = torch.rand((4096, 3), generator=_seeded(dev, 5), device=dev)
    step = S.make_train_step(cfg, functools.partial(torch.optim.Adam,
                                                    lr=1e-2),
                             S.make_device_mesh(1))
    params = {"colors": scene.mesh.colors * 0.5}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        alone = step(params, None, scene.mesh, acc16, scene.sun, o, d,
                     target)
        torch.distributed.init_process_group(
            "nccl", init_method=f"tcp://localhost:{_free_port()}",
            world_size=1, rank=0)
        try:
            S.COLLECTIVES["all_reduce"] = 0
            grouped = step(params, None, scene.mesh, acc16, scene.sun, o, d,
                           target)
            torch.cuda.synchronize()
            backend = torch.distributed.get_backend()
        finally:
            torch.distributed.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(was)
    assert S.COLLECTIVES["all_reduce"] == 1 and backend == "nccl"
    assert torch.equal(alone[0]["colors"], grouped[0]["colors"])
    assert bool(alone[2] == grouped[2])


def test_sharded_train_step_on_the_card_is_a_fitter_step(dev):
    """The train step at the backward cell's size (262,144 rays of blocks
    90-105, CS 16, the reference config) over 2 virtual shards of the card
    against one unsharded `Fitter` step on the same rays and draws, both
    under deterministic algorithms: the loss within GRAD_PARITY_RTOL, the
    gradients within TRAIN_STEP_RTOL of each table's largest magnitude."""
    import functools

    from raytracing_tpu_torch.models import inverse
    from raytracing_tpu_torch.parallel import shard as S

    scene, acc16, _ = _reference_accels(dev)
    ref = RenderConfig()
    idx = torch.cat([block_ray_ids(i, 16384, ref, 16, 16, device=dev)
                     for i in range(90, 106)])
    n = idx.shape[0]
    u1 = torch.rand((ref.diffuse_scatter, n, 2), generator=_seeded(dev, 7),
                    device=dev)

    def draw(tag, shape, lo=0):
        assert tag == 1 and shape == (ref.diffuse_scatter, shape[1], 2)
        return u1[:, lo:lo + shape[1]].contiguous()

    tgt_img = torch.rand((800, 800, 3), generator=_seeded(dev, 8),
                         device=dev)
    tables = {k: getattr(scene.mesh, k) for k in ("verts", "colors",
                                                  "materials")}
    step2 = S.make_train_step(ref, functools.partial(torch.optim.Adam,
                                                     lr=1e-2),
                              S.make_device_mesh(2, devices=["cuda:0"] * 2))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        fitter = inverse.Fitter(scene, tgt_img, tables, ref, accel=acc16)
        loss_1 = fitter.step(idx, draw)
        grads_1 = {k: v.grad for k, v in fitter.params.items()}
        grads_2 = {}
        _, _, loss_2 = step2(
            tables, None, scene.mesh, acc16, scene.sun, fitter.o[idx],
            fitter.d[idx], fitter.target[idx % (800 * 800)],
            uniforms=lambda g, tag, shape: draw(tag, shape, g * (n // 2)),
            grads_out=grads_2)
    finally:
        torch.use_deterministic_algorithms(was)
    assert abs(float(loss_2) - loss_1) <= GRAD_PARITY_RTOL * abs(loss_1)
    for k in tables:
        scale = float(grads_1[k].abs().max())
        err = float((grads_2[k] - grads_1[k]).abs().max())
        assert scale > 0 and err <= TRAIN_STEP_RTOL * scale, (k, err, scale)


@pytest.mark.parametrize("n,device", [(1, None), (2, "cuda:0")],
                         ids=["card", "two_shards"])
def test_dryrun_multichip_on_the_card(dev, n, device):
    """`dryrun_multichip(1)` on the card and `(2)` over 2 virtual shards
    of it: one sharded Adam step with a finite loss."""
    from raytracing_tpu_torch.parallel.dryrun import dryrun_multichip

    assert np.isfinite(dryrun_multichip(n, device=device))


# The tables `refit_geometry` recomputes; the others come back as they were.
REFIT_TABLES = ("cluster_min", "cluster_max", "pmt_blocks", "grad_blocks",
                "rest_blocks", "rest_grad", "tri_blocks", "pmt_t_blocks")


def _moved_default_mesh():
    """The default scene on the CPU and its mesh with object 0 posed and
    every vertex jittered."""
    from raytracing_tpu_torch.geometry.transform import apply_pose

    scene = build_default_scene(device="cpu")
    g = torch.Generator().manual_seed(4)
    mesh = apply_pose(scene.mesh, torch.tensor(
        [0.02, -0.05, 0.03, 0.08, -0.04, 0.06]), 0)
    jitter = (torch.rand(mesh.verts.shape, generator=g) - 0.5) * 0.01
    return scene, mesh._replace(verts=mesh.verts + jitter)


@pytest.mark.parametrize("cs", [16, 128])
def test_refit_on_the_card_is_the_cpu_refit_and_the_build(dev, cs):
    """`refit_geometry` on the card, bit for bit: at the build's vertices
    every table it recomputes is the uploaded build's; after a pose and a
    jitter it is the CPU's refit of the same vertices; and the refit
    accel's nearest hits on the card are a fresh build's at the moved
    vertices up to ties (a ray whose triangle differs hits both within
    1e-5 of one t)."""
    scene, moved = _moved_default_mesh()
    acc = build_cluster_accel(scene.mesh, cluster_size=cs)
    card = acc.to(dev)
    same = packets.refit_geometry(card, scene.mesh.to(dev))
    cpu = packets.refit_geometry(acc, moved)
    got = packets.refit_geometry(card, moved.to(dev))
    assert same.woop_blocks is None and got.woop_blocks is None
    for name in REFIT_TABLES:
        want = getattr(card, name)
        if want is None:
            continue
        assert torch.equal(getattr(same, name), want), name
        assert torch.equal(getattr(got, name).cpu(), getattr(cpu, name)), name
    fresh = build_cluster_accel(moved.to(dev), cluster_size=cs)
    cfg = RenderConfig(width=128, height=128, samples_per_pixel=1)
    o, d = camera_rays_for_ids(torch.arange(128 * 128, device=dev), cfg)
    rays8 = T.rays_to_soa(o, d)
    t1, tri1 = T.nearest_hit_soa(got, rays8)
    t2, tri2 = T.nearest_hit_soa(fresh, rays8)
    assert torch.equal(torch.isfinite(t1), torch.isfinite(t2))
    hit = torch.isfinite(t1)
    assert int((hit & (tri1 != tri2)).sum()) <= 4
    assert bool(((t1 - t2).abs()[hit] <= 1e-5 * t2[hit].abs()).all())
    t0, tri0 = T.nearest_hit_soa(card, rays8)   # the stale accel
    assert int((hit & (tri0 != tri2)).sum()) > 100


def _fit_cell_entry(dev, **traffic):
    """The cell `two_teapots.fit`'s entry on the card, set up."""
    from rtbench import spec

    cell = spec.load_cell("two_teapots.fit", spec.load_benchmark())
    e = spec.entry(cell.traffic).Entry(cell.config,
                                       dict(cell.traffic, **traffic),
                                       2 ** 33 + 11, dev)
    e.setup()
    return cell, e


def test_fit_step_with_the_refit_on_the_card_matches_the_cpu(dev):
    """One `Fitter.step` of the fit cell's kind (the two-teapot scene, the
    green teapot's pose and every vertex, the accel refit) at 2,048 rays of
    a 64x64 2-spp frame, from the start pose (so the refit moves the
    geometry at once), on the card against the CPU with the same rays,
    uniforms and target: the loss within GRAD_PARITY_RTOL of the CPU's,
    each gradient within GRAD_PARITY_RTOL of its largest magnitude (the
    card's scatter-adds are atomics, in another order; the sampler's
    sin/cos differ by ulps)."""
    import copy

    from raytracing_tpu_torch.geometry.mesh import Scene
    from raytracing_tpu_torch.models import inverse
    from rtbench import program, spec

    cell = spec.load_cell("two_teapots.fit", spec.load_benchmark())
    cfg_r = dict(copy.deepcopy(cell.config["render"]), width=64, height=64,
                 samples_per_pixel=2, chunk_size=2048)
    cfg = program.render_config(cfg_r)
    mesh = program.build_mesh(cell.config["scene"], "cpu")
    acc = build_cluster_accel(mesh, cluster_size=16,
                              variants=("pmt", "mt", "pmtt"))
    sun = torch.tensor([3e4, 2.5e4, 9e4])
    target = render(Scene(mesh, sun), cfg, accel=acc,
                    generator=torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(5)
    idx = torch.randint(0, 2 * 64 * 64, (2048,), generator=g)
    fan = torch.rand((10, 2048, 2), generator=g)
    pose = torch.tensor(cell.config["fit"]["start_pose"])
    out = {}
    for where in ("cpu", dev):
        m = mesh.to(where)
        f = inverse.Fitter(Scene(m, sun.to(where)), target.to(where),
                           {"pose": pose.to(where), "verts": m.verts}, cfg,
                           accel=acc.to(where))
        loss = f.step(idx.to(where), lambda tag, shape: fan.to(where))
        out[str(where)] = (loss, {k: p.grad.cpu()
                                  for k, p in f.params.items()})
    (l_cpu, g_cpu), (l_dev, g_dev) = out["cpu"], out[str(dev)]
    assert abs(l_dev - l_cpu) <= GRAD_PARITY_RTOL * abs(l_cpu), (l_dev, l_cpu)
    for k in g_cpu:
        scale = float(g_cpu[k].abs().max())
        err = float((g_dev[k] - g_cpu[k]).abs().max())
        assert scale > 0 and err <= GRAD_PARITY_RTOL * scale, (k, err, scale)


def test_fit_cell_step_262k_is_the_reference(dev):
    """Two steps of the fit cell at its size (262,144 rays a step over the
    800x800x4 frame, the accel refit every step) checked as the benchmark
    checks them: each against `rtbench/reference/fit.py` on the card under
    the cell's limits (`rtbench/limits/two_teapots.fit.json`, set from the
    program's and the bfloat16 reference's readings, PERF.md); the
    refit's tables were recomputed on the card each step."""
    from raytracing_tpu_torch.utils import profiling as P
    from rtbench.harness import judge

    cell, e = _fit_cell_entry(dev)
    P.COUNTERS.reset()
    kept = [e.keep(k, e.step(k)) for k in range(2)]
    assert P.COUNTERS.host["fit.steps"] == 2
    assert P.COUNTERS.host["refit.slots"] == 2 * (
        e.accel.order.shape[0] + e.accel.rest_ids.shape[0])
    assert P.COUNTERS.host["grad.rays"] >= 2 * 11 * 262144
    e.release(kept)
    numbers = [e.check(item) for item in kept]
    correct, failed, _ = judge(numbers, cell.limits)
    assert correct, numbers


def test_fit_step_spans_and_counting_off_add_no_launch(dev):
    """The fit cell's step at its size with the spans off and on, each
    from the start (a fresh `Fitter` on the same mesh, accel and target):
    the same loss, the port's launches (`LAUNCHES`) equal, the device
    operations within the 0-3 the profiler drops at a session's start, and
    no counting sum among them (the device counts run only under
    `counting(True)`, which adds its own)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from raytracing_tpu_torch.models import inverse
    from raytracing_tpu_torch.utils import profiling as P

    _, e = _fit_cell_entry(dev)
    f0 = e.fitter
    start = {k: v.detach().clone() for k, v in f0.params.items()}

    def fresh():
        return inverse.Fitter(f0.scene, e.target, start, e.cfg,
                              accel=e.accel)

    f = fresh()
    f.step(e.rays(0), e.uniforms(0))            # warm
    runs = []
    for on, count in ((False, False), (True, False), (False, True)):
        f = fresh()
        torch.cuda.synchronize()
        T.reset_launches()
        was, was_c = P.tracing(on), P.counting(count)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                loss = f.step(e.rays(0), e.uniforms(0))
                torch.cuda.synchronize()
        finally:
            P.tracing(was)
            P.counting(was_c)
        ops = [x for x in prof.events() if x.device_type == DeviceType.CUDA
               and not x.name.startswith("rt.")]
        spans = {x.name for x in prof.events() if x.name.startswith("rt.")}
        runs.append((loss, dict(T.LAUNCHES), len(ops), spans))
    (l0, n0, ops0, s0), (l1, n1, ops1, s1), (_, _, ops2, _) = runs
    assert l0 == l1 and n0 == n1
    assert abs(ops0 - ops1) <= 3 and ops2 > ops0
    assert not s0 and {"rt.fit", "rt.backward", "rt.grad", "rt.optim",
                       "rt.refit"} <= s1
