"""Camera-mode primaries and the origin-folded intersector of the port on
the CPU (plain versions of `walk_camera` / `walk`), against the JAX
package's Pallas path in interpret mode and against the port's own pack
path.

Against JAX: hit masks and slots equal, t at rtol 1e-5 (the bar of
tests/test_kernels.py's camera tests: XLA on the CPU contracts a*b+c into
FMAs, the port does not). Inside the port — camera mode against the pack
path under `shared_origin=0`, chunked against whole-frame, pooled against
unpooled lists, combined-table against separate-table entry — everything
is bit-equal: the same directions, the same table, the same op order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raytracing_tpu.kernels.traverse as JT
from raytracing_tpu.accel.packets import build_cluster_accel as jax_build
from raytracing_tpu.config import RenderConfig as JaxConfig
from raytracing_tpu.geometry.scene import build_default_scene as jax_scene
from raytracing_tpu.geometry.scene import teapot_only_mesh as jax_teapot
from raytracing_tpu.models.whitted import render as jax_render
from raytracing_tpu.ops.sampling import stratified_offsets as jax_offsets

import raytracing_tpu_torch.kernels.traverse as T
from raytracing_tpu_torch import RenderConfig, build_cluster_accel
from raytracing_tpu_torch.accel.packets import accel_from_numpy
from raytracing_tpu_torch.geometry.mesh import scene_from_numpy
from raytracing_tpu_torch.geometry.scene import build_default_scene
from raytracing_tpu_torch.models import whitted
from raytracing_tpu_torch.models.camera import (block_ray_ids,
                                                camera_rays_for_ids)
from raytracing_tpu_torch.ops.sampling import stratified_offsets

torch.set_num_threads(2)

W = H = 48
SPP = 4
RT = SPP * 16 * 16
N_TILES = (W // 16) * (H // 16)


def _to_torch(j_acc):
    return accel_from_numpy({k: (None if v is None else np.asarray(v))
                             for k, v in j_acc._asdict().items()},
                            device="cpu")


@pytest.fixture(scope="module")
def accels():
    scene = jax_scene(t=0.0)
    out = {}
    for cs in (16, 128):
        j = jax_build(scene.mesh, cluster_size=cs)
        out[cs] = (j, _to_torch(j))
    return out


@pytest.fixture(scope="module")
def full_frame(accels):
    """The port's whole-frame camera query at 48x48x4, CS 16, attrs."""
    return T.nearest_hit_camera_soa(accels[16][1], stratified_offsets(SPP),
                                    width=W, height=H, spp=SPP,
                                    with_attrs=True)


def _pack(w, h, spp, bh=16, bw=16):
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp)
    o, d = camera_rays_for_ids(block_ray_ids(0, spp * h * w, cfg, bh, bw,
                                             device="cpu"), cfg)
    return T.rays_to_soa(o, d)


def test_camera_matches_jax_camera(accels, full_frame):
    j_acc, _ = accels[16]
    jt, js, ja = JT.nearest_hit_camera_soa(
        j_acc, jax_offsets(SPP), width=W, height=H, spp=SPP, interpret=True,
        with_attrs=True)
    tt, ts, ta = (x.numpy() for x in full_frame)
    jt, js, ja = np.asarray(jt), np.asarray(js), np.asarray(ja)
    hit = np.isfinite(jt)
    assert 0.2 < hit.mean() < 0.9
    np.testing.assert_array_equal(np.isfinite(tt), hit)
    np.testing.assert_array_equal(ts[hit], js[hit])
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-6, atol=1e-6)
    assert (ta[:, ~hit] == 0.0).all()


def test_camera_equals_pack_path_under_shared_origin(accels, full_frame):
    _, acc = accels[16]
    pt, ps, pa = T.nearest_hit_attrs_soa(acc, _pack(W, H, SPP),
                                         shared_origin=torch.zeros(3))
    for got, want in zip(full_frame, (pt, ps, pa)):
        assert torch.equal(got, want)


def test_camera_chunk_equals_full_slice(accels, full_frame):
    _, acc = accels[16]
    t, s, a = T.nearest_hit_camera_soa(
        acc, stratified_offsets(SPP), width=W, height=H, spp=SPP,
        with_attrs=True, tile_base=3, tiles=4)
    sl = slice(3 * RT, 7 * RT)
    assert torch.equal(t, full_frame[0][sl])
    assert torch.equal(s, full_frame[1][sl])
    assert torch.equal(a, full_frame[2][:, sl])


def test_camera_chunk_overrun_repeats_last_block(accels, full_frame):
    """2 real + 2 overrun tiles: the in-frame rows are the whole-frame
    call's, the overrun rows repeat the last BLOCK lane by lane."""
    _, acc = accels[16]
    t, s = T.nearest_hit_camera_soa(
        acc, stratified_offsets(SPP), width=W, height=H, spp=SPP,
        tile_base=N_TILES - 2, tiles=4)
    assert torch.equal(t[:2 * RT], full_frame[0][-2 * RT:])
    assert torch.equal(s[:2 * RT], full_frame[1][-2 * RT:])
    for k in (2, 3):
        assert torch.equal(t[k * RT:(k + 1) * RT], full_frame[0][-RT:])
        assert torch.equal(s[k * RT:(k + 1) * RT], full_frame[1][-RT:])


@pytest.mark.parametrize("block", [16, 8], ids=["bh16", "bh8"])
def test_pooled_lists_equal_unpooled(accels, monkeypatch, block):
    """48x32: an odd block grid, so the supertile grid is phase-shifted and
    padded; bh = bw = 8 pools 4x4 blocks."""
    _, acc = accels[16]
    kw = dict(width=48, height=32, spp=SPP, bh=block, bw=block,
              with_attrs=True)
    offs = stratified_offsets(SPP)
    monkeypatch.setattr(T, "_SUPERTILE_MIN_C", 10 ** 9)
    plain = T.nearest_hit_camera_soa(acc, offs, **kw)
    monkeypatch.setattr(T, "_SUPERTILE_MIN_C", 0)
    pooled = T.nearest_hit_camera_soa(acc, offs, **kw)
    assert torch.isfinite(plain[0]).any()
    for a, b in zip(pooled, plain):
        assert torch.equal(a, b)


def test_pooled_lists_are_the_unpooled_sets(accels):
    _, acc = accels[16]
    cam = T.Camera(48, 32, SPP, 1.0, 16, 16)
    ext = T._camera_tile_extents(6, stratified_offsets(SPP), cam)
    ids, tnear, cnt = T.lists_from_extents(*ext, acc.cluster_min,
                                           acc.cluster_max)
    pids, ptnear, pcnt = T._pooled_camera_lists(acc, ext, cam)
    assert torch.equal(cnt, pcnt)
    for k, c in enumerate(cnt.tolist()):
        assert set(pids[k, :c].tolist()) == set(ids[k, :c].tolist())
        assert c < 2 or bool((ptnear[k, 1:c] >= ptnear[k, :c - 1]).all())


def test_cs128_combined_entry_equals_separate_entry(accels):
    """CS 128 takes the combined-table entry (K2 camera); the same lists
    over the separate tables (K1 camera's layout) give the same bits."""
    _, acc = accels[128]
    w, h, spp = 64, 48, 2
    offs = stratified_offsets(spp)
    cam = T.Camera(w, h, spp, 1.0, 16, 16)
    na = acc.attr_blocks.shape[1]
    args, kw = T._camera_walk_args(acc, offs, cam, 0, 12, na, 1e-8)
    assert kw["entry"] == "walk_camera_dma"
    assert args[6].shape[1] == 12 + na  # one combined table
    t1, s1, a1 = T.walk_camera(*args, **kw)
    sep = args[:6] + (T._fold_origin(acc.pmt_blocks, torch.zeros(3)),
                      acc.attr_blocks) + args[8:]
    t0, s0, a0 = T.walk_camera(*sep, **{**kw, "entry": "walk_camera"})
    assert torch.isfinite(t1).any()
    assert torch.equal(t0, t1) and torch.equal(s0, s1) and torch.equal(a0, a1)
    # ... and JAX's camera query over the same accel agrees.
    jt, js = JT.nearest_hit_camera_soa(accels[128][0], jax_offsets(spp),
                                       width=w, height=h, spp=spp,
                                       interpret=True)
    tt, ts = T.nearest_hit_camera_soa(acc, offs, width=w, height=h, spp=spp)
    hit = np.isfinite(np.asarray(jt))
    np.testing.assert_array_equal(torch.isfinite(tt).numpy(), hit)
    np.testing.assert_array_equal(ts.numpy()[hit], np.asarray(js)[hit])
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit],
                               rtol=1e-5)


@pytest.mark.parametrize("shape", [(48, 48, 4, 16), (48, 32, 3, 16),
                                   (32, 32, 1, 8)],
                         ids=["48x48x4", "48x32x3", "32x32x1-bh8"])
def test_camera_extents_and_dirs_bit_equal_to_the_pack(shape):
    """The closed-form extents are the masked min/max of the materialised
    pack, and the derived direction rows are the pack's, bit for bit."""
    w, h, spp, b = shape
    cam = T.Camera(w, h, spp, 1.0, b, b)
    offs = stratified_offsets(spp)
    n_tiles = cam.grid[0] * cam.grid[1]
    pack = _pack(w, h, spp, b, b)
    dx, dy, dz = T._camera_dir_rows(n_tiles * cam.ray_tile, offs, cam)
    assert torch.equal(torch.cat([dx, dy, dz]), pack[4:7])
    r = pack.reshape(8, n_tiles, cam.ray_tile)
    o_lo, o_hi, d_lo, d_hi = T._camera_tile_extents(n_tiles, offs, cam)
    assert torch.equal(d_lo, r[4:7].amin(dim=2).T)
    assert torch.equal(d_hi, r[4:7].amax(dim=2).T)
    assert not o_lo.any() and not o_hi.any()
    if cam.ray_tile == T.RAY_TILE:
        lo, hi = T.tile_extents_plain(pack)
        assert torch.equal(d_lo, lo[:, 4:7]) and torch.equal(d_hi, hi[:, 4:7])
    # JAX's closed form gives the same numbers.
    jext = JT._camera_tile_extents(n_tiles, jnp.asarray(offs.numpy()), w, h,
                                   spp, 1.0, float(w) / float(h), b, b)
    np.testing.assert_array_equal(d_lo.numpy(), np.asarray(jext[2]))
    np.testing.assert_array_equal(d_hi.numpy(), np.asarray(jext[3]))


def test_pmto_agrees_with_pmt(rng):
    """tests/test_kernels.py:test_shared_origin_variant_parity in the port,
    and against JAX's pmto at a general origin (the folded table's 3-term
    sums meet XLA's FMA: rtol 1e-5)."""
    j_acc = jax_build(jax_teapot(), cluster_size=16)
    acc = _to_torch(j_acc)
    n = 256
    o = np.broadcast_to(np.array([0.2, -0.1, -0.5], np.float32), (n, 3))
    tgt = np.array([0.0, 0.0, 3.0]) + rng.normal(size=(n, 3))
    d = (tgt - o).astype(np.float32)
    rays8 = T.rays_to_soa(torch.from_numpy(o.copy()), torch.from_numpy(d))
    t_a, id_a = T.nearest_hit_soa(acc, rays8)
    t_b, id_b = T.nearest_hit_soa(acc, rays8,
                                  shared_origin=torch.from_numpy(o[0].copy()))
    hit = torch.isfinite(t_a)
    assert hit.any() and not hit.all()
    assert torch.equal(torch.isfinite(t_b), hit)
    np.testing.assert_allclose(t_a[hit].numpy(), t_b[hit].numpy(), rtol=1e-5)
    assert torch.equal(id_a, id_b)
    jt, jid = JT.nearest_hit_soa(j_acc, jnp.asarray(rays8.numpy()),
                                 interpret=True,
                                 shared_origin=jnp.asarray(o[0]))
    np.testing.assert_array_equal(np.isfinite(np.asarray(jt)), hit.numpy())
    np.testing.assert_array_equal(np.asarray(jid), id_b.numpy())
    np.testing.assert_allclose(np.asarray(jt)[hit.numpy()],
                               t_b[hit].numpy(), rtol=1e-5)
    folded = T._fold_origin(acc.pmt_blocks, torch.from_numpy(o[0].copy()))
    np.testing.assert_allclose(
        folded.numpy(),
        np.asarray(JT._fold_origin(j_acc.pmt_blocks, jnp.asarray(o[0]))),
        rtol=1e-5, atol=1e-6)
    assert torch.equal(T._fold_origin(acc.pmt_blocks, torch.zeros(3)) + 0.0,
                       acc.pmt_blocks + 0.0)  # origin 0: the table itself


FRAME = dict(width=32, height=32, samples_per_pixel=1, chunk_size=32 * 32,
             reflect_depth=1, diffuse_depth=2, diffuse_scatter=2,
             primary_shared_origin=True)


def _jax_uniforms(seed, n_chunks):
    keys = jax.random.split(jax.random.PRNGKey(seed), n_chunks)

    def draw(i, depth, shape):
        u = jax.random.uniform(jax.random.fold_in(keys[i], depth), shape,
                               dtype=jnp.float32)
        return torch.from_numpy(np.array(u))

    return draw


@pytest.fixture(scope="module")
def camera_frame():
    scene = build_default_scene(t=0.0, device="cpu")
    acc = build_cluster_accel(scene.mesh, cluster_size=16)
    T.reset_launches()
    img = whitted.render(scene, RenderConfig(**FRAME), accel=acc,
                         uniforms=_jax_uniforms(5, 1))
    return scene, acc, img


def test_frame_with_camera_primaries_matches_jax(camera_frame):
    js = jax_scene(t=0.0)
    ref = np.asarray(jax_render(js, JaxConfig(backend="pallas", **FRAME),
                                accel=jax_build(js.mesh, cluster_size=16),
                                key=jax.random.PRNGKey(5)))
    img = camera_frame[2].numpy()
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img, ref, atol=1e-5)


def test_frame_camera_primaries_equal_pack_path(camera_frame, monkeypatch):
    """tests/test_render.py:test_render_camera_mode_matches_pack_path: the
    pack path with the same folded intersector gives the same image (here
    bit for bit), and camera mode is what the frame ran."""
    scene, acc, img = camera_frame
    calls = []
    real = whitted.nearest_hit_shaded_camera
    monkeypatch.setattr(whitted, "nearest_hit_shaded_camera",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    again = whitted.render(scene, RenderConfig(**FRAME), accel=acc,
                           uniforms=_jax_uniforms(5, 1))
    assert calls and torch.equal(again, img)
    monkeypatch.setattr(whitted, "camera_mode_supported", lambda a: False)
    calls.clear()
    pack = whitted.render(scene, RenderConfig(**FRAME), accel=acc,
                          uniforms=_jax_uniforms(5, 1))
    assert not calls and torch.equal(pack, img)
    # A chunk that holds no whole number of blocks takes the pack path too.
    cfg = RenderConfig(**{**FRAME, "chunk_size": 500})
    whitted.render(scene, cfg, accel=acc, uniforms=_jax_uniforms(5, 3))
    assert not calls


def test_camera_chunk_must_hold_whole_blocks(camera_frame):
    scene, acc, _ = camera_frame
    cfg = RenderConfig(**FRAME)
    o = torch.zeros((100, 3))
    with pytest.raises(ValueError, match="whole 16x16x1spp blocks"):
        whitted.render_rays(scene.mesh, acc, scene.sun, o, o + 1.0, cfg,
                            lambda depth, shape: torch.rand(shape),
                            camera_chunk=(0, stratified_offsets(1), 16, 16))


@pytest.mark.parametrize("kw,match", [
    (dict(width=50, height=48, spp=1), "bw | width"),
    (dict(width=48, height=48, spp=1, tile_base=2), "given together"),
], ids=["odd-frame", "half-chunk"])
def test_camera_query_refuses_bad_arguments(accels, kw, match):
    with pytest.raises(ValueError, match=match):
        T.nearest_hit_camera_soa(accels[16][1], stratified_offsets(1), **kw)
    assert T.camera_mode_supported(accels[16][1])
    assert not T.camera_mode_supported(None)


@pytest.mark.parametrize("loader", ["scene", "scene_from_numpy",
                                    "accel_from_numpy", "teapot", "subdivided"])
def test_loaders_default_to_the_card(loader, monkeypatch):
    """With no `device=` every loader asks for "cuda" — and so raises on a
    machine without a card instead of falling back to the CPU."""
    from raytracing_tpu_torch.geometry import scene as S

    asked = []

    def to(self, device):
        asked.append(str(device))
        return self

    from raytracing_tpu_torch.accel.packets import ClusterAccel
    from raytracing_tpu_torch.geometry.mesh import Mesh, Scene

    for cls in (Mesh, Scene, ClusterAccel):
        monkeypatch.setattr(cls, "to", to)
    monkeypatch.setattr(torch.Tensor, "to",
                        lambda self, *a, **k: asked.append(str(a[0])) or self)
    js = jax_scene(t=0.0)
    if loader == "scene":
        build_default_scene()
    elif loader == "scene_from_numpy":
        scene_from_numpy({**{k: np.asarray(v)
                             for k, v in js.mesh._asdict().items()},
                          "sun": np.asarray(js.sun)})
    elif loader == "accel_from_numpy":
        accel_from_numpy({"order": np.zeros(16, np.int32)})
    elif loader == "teapot":
        S.teapot_only_mesh()
    else:
        S.subdivided_teapot_mesh(levels=1)
    assert asked and set(asked) == {"cuda"}
