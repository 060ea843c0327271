"""The port's traversal against the JAX package's Pallas path (interpret
mode) on the default two-teapot scene: K6 extents and K5 entered bits
exactly, visit lists as sets, nearest (t, slot, attrs) and occlusion on
alive lanes. t and attrs are held at rtol 1e-6: XLA on the CPU contracts
the intersector's a*b+c into FMAs, the port's plain version (like its CUDA
kernels, built -fmad=false) does not. Camera ids and bin keys are
bit-equal. The CUDA kernels against their plain versions are
tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracing_tpu.kernels.traverse as JT
from raytracing_tpu.accel.packets import build_cluster_accel as jax_build
from raytracing_tpu.config import RenderConfig as JaxConfig
from raytracing_tpu.geometry.scene import build_default_scene as jax_scene
from raytracing_tpu.kernels import binning as JB
from raytracing_tpu.models import camera as JC

import raytracing_tpu_torch.kernels.traverse as T
from raytracing_tpu_torch.accel.packets import accel_from_numpy
from raytracing_tpu_torch.config import RenderConfig
from raytracing_tpu_torch.geometry.mesh import Mesh
from raytracing_tpu_torch.kernels import binning as TB
from raytracing_tpu_torch.models import camera as TC

torch.set_num_threads(2)

N_RAYS = 2048


@pytest.fixture(scope="module")
def accels():
    scene = jax_scene(t=0.0)
    out = {}
    for cs in (16, 128):
        j = jax_build(scene.mesh, cluster_size=cs)
        out[cs] = (j, accel_from_numpy(
            {k: (None if v is None else np.asarray(v))
             for k, v in j._asdict().items()}, device="cpu"))
    return out


def _packs(seed):
    """Two [8, N] packs from a numpy seed: camera-like rays toward the
    teapots and ground, and incoherent bounce-like rays leaving points near
    the teapot surfaces. One lane in ten is dead."""
    rng = np.random.default_rng(seed)
    n = N_RAYS
    o1 = rng.normal(scale=0.2, size=(n, 3))
    tgt = np.array([1.0, -1.2, 7.5]) + rng.normal(scale=[2.5, 1.5, 2.0],
                                                  size=(n, 3))
    d1 = tgt - o1
    o2 = np.array([1.0, -1.2, 7.5]) + rng.normal(scale=[2.0, 0.6, 1.5],
                                                 size=(n, 3))
    d2 = rng.normal(size=(n, 3))
    packs = []
    for o, d in ((o1, d1), (o2, d2)):
        alive = (rng.uniform(size=n) > 0.1).astype(np.float32)
        p = np.concatenate([o.T, np.ones((1, n)), d.T, alive[None]])
        packs.append(np.ascontiguousarray(p, dtype=np.float32))
    return packs


@pytest.fixture(scope="module")
def packs():
    return _packs(7)


def _both(p):
    return jnp.asarray(p), torch.from_numpy(p)


@pytest.mark.parametrize("which", [0, 1], ids=["camera", "bounce"])
def test_extents_bit_equal(packs, which):
    jp, tp = _both(packs[which])
    jlo, jhi = JT._tile_extents_pallas(jp, 1024, interpret=True)
    tlo, thi = T.tile_extents(tp)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))


def test_refine_dense_equal(packs, accels):
    """Tile 1 is flagged dead; tile 2 repeats tile 1's rays but keeps one
    alive lane, which points away from the scene — its dead lanes, aimed
    through the teapots, must not set any bit."""
    j_acc, t_acc = accels[128]
    extra = packs[1][:, 1024:].copy()
    extra[7] = 0.0
    extra[:, 0] = [0.0, 100.0, 0.0, 1.0, 0.0, 1.0, 0.0, 1.0]
    p = np.ascontiguousarray(np.concatenate([packs[1], extra], axis=1))
    jp, tp = _both(p)
    alive = np.array([True, False, True])
    je = JT._refine_dense(jp, j_acc.cluster_min, j_acc.cluster_max, 1024,
                          interpret=True, tile_alive=jnp.asarray(alive))
    te = T.refine_dense(tp, t_acc.cluster_min, t_acc.cluster_max,
                        tile_alive=torch.from_numpy(alive))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert te[0].any() and not te[1].any() and not te[2].any()


@pytest.mark.parametrize("cs", [16, 128])
def test_visit_lists_match(packs, accels, cs):
    j_acc, t_acc = accels[cs]
    jp, tp = _both(packs[1 if cs == 128 else 0])
    jids, _, jcnt = JT._tile_visit_lists_soa(
        jp, j_acc.cluster_min, j_acc.cluster_max, 1024, interpret=True)
    tids, ttn, tcnt = T._tile_visit_lists_soa(tp, t_acc.cluster_min,
                                              t_acc.cluster_max)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    jids = np.asarray(jids)
    for k, c in enumerate(tcnt.tolist()):
        assert c > 0
        assert set(tids[k, :c].tolist()) == set(jids[k, :c].tolist())
        assert bool((ttn[k, 1:c] >= ttn[k, :c - 1]).all())


def _alive(p):
    return p[7] != 0


@pytest.mark.parametrize("cs,wq", [(16, False), (128, True)],
                         ids=["cs16", "cs128-wq"])
def test_nearest_attrs_match_jax(packs, accels, cs, wq):
    """CS 16 runs the `_walk_groups` entry (K1), CS 128 with wq the
    refined `_walk_dma` entry (K2), with early exit on both sides.

    t also gets atol 1e-5: the intersector's t = (d0 - n·o) / den cancels
    when a ray leaves a point near a triangle's plane, so XLA's FMA in n·o
    moves t by about ulp(d0) / |den| whatever t is. Measured on the bounce
    pack: 73 of 1500 hits differ by more than rtol 1e-6, at most 3.1e-6
    absolute; every slot and hit flag is equal."""
    j_acc, t_acc = accels[cs]
    p = packs[1 if wq else 0]
    jp, tp = _both(p)
    jt, js, ja = JT.nearest_hit_attrs_soa(j_acc, jp, interpret=True,
                                          early_exit=True, wq=wq)
    tt, ts, ta = T.nearest_hit_attrs_soa(t_acc, tp, early_exit=True, wq=wq)
    m = _alive(p)
    jt, js, ja = np.asarray(jt)[m], np.asarray(js)[m], np.asarray(ja)[:, m]
    tt, ts, ta = tt.numpy()[m], ts.numpy()[m], ta.numpy()[:, m]
    hit = np.isfinite(jt)
    assert hit.sum() > 100 and (~hit).sum() > 100
    np.testing.assert_array_equal(np.isfinite(tt), hit)
    np.testing.assert_array_equal(ts[hit], js[hit])
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cs,wq", [(16, False), (128, True)],
                         ids=["cs16", "cs128-wq"])
def test_any_hit_matches_jax(packs, accels, cs, wq):
    j_acc, t_acc = accels[cs]
    p = packs[1]
    jp, tp = _both(p)
    jo = np.asarray(JT.any_hit_soa(j_acc, jp, t_max=30.0, interpret=True,
                                   wq=wq))
    to = T.any_hit_soa(t_acc, tp, t_max=30.0, wq=wq).numpy()
    m = _alive(p)
    assert jo[m].any() and not jo[m].all()
    np.testing.assert_array_equal(to[m], jo[m])


def test_shaded_query_expands_objid(packs, accels):
    j_acc, t_acc = accels[16]
    p = packs[0]
    o = torch.from_numpy(p[0:3].T.copy())
    d = torch.from_numpy(p[4:7].T.copy())
    jm = jax_scene(t=0.0).mesh
    mesh = Mesh(*(torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
                  for v in jm))
    h, attrs = T.nearest_hit_shaded(mesh, t_acc, o, d)
    jh, jattrs = JT.nearest_hit_shaded(
        jm, j_acc, jnp.asarray(p[0:3].T),
        jnp.asarray(p[4:7].T), interpret=True)
    np.testing.assert_array_equal(h.hit.numpy(), np.asarray(jh.hit))
    np.testing.assert_array_equal(h.tri.numpy(), np.asarray(jh.tri))
    np.testing.assert_allclose(attrs.numpy(), np.asarray(jattrs), rtol=1e-6,
                               atol=1e-6)


def test_camera_ids_rays_and_image_bit_equal(rng):
    kw = dict(width=64, height=48, samples_per_pixel=4)
    jc, tc = JaxConfig(**kw), RenderConfig(**kw)
    r = 64 * 48 * 4
    for i in range(3):  # the last chunk overruns the frame and clamps
        jids = np.asarray(JC.block_ray_ids(i, 5000, jc))
        tids = TC.block_ray_ids(i, 5000, tc, device="cpu")
        np.testing.assert_array_equal(tids.numpy(), jids)
        jo, jd = JC.camera_rays_for_ids(jnp.asarray(jids), jc)
        to, td = TC.camera_rays_for_ids(tids, tc)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    packed = rng.standard_normal((r, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TC.blocks_to_image(torch.from_numpy(packed), tc, 16, 16).numpy(),
        np.asarray(JC.blocks_to_image(jnp.asarray(packed), jc, 16, 16)))
    jp, jinv = JC.block_permutation(4, 40, 24, 16, 16)
    tp, tinv = TC.block_permutation(4, 40, 24, 16, 16)
    np.testing.assert_array_equal(tp, np.asarray(jp))
    np.testing.assert_array_equal(tinv, np.asarray(jinv))


def test_bin_keys_and_sort_bit_equal(packs):
    p = packs[1]
    o, d = p[0:3].T.copy(), p[4:7].T.copy()
    alive = p[7] != 0
    to, td, ta = map(torch.from_numpy, (o, d, alive))
    jlo, jhi = JB.batch_bounds(jnp.asarray(o), jnp.asarray(alive))
    tlo, thi = TB.batch_bounds(to, ta)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    jk = JB.bounce_bin_key(jnp.asarray(o), jnp.asarray(d), jlo, jhi,
                           jnp.asarray(alive))
    tk = TB.bounce_bin_key(to, td, tlo, thi, ta)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(
        TB.bin_key(to, td, tlo, thi, ta).numpy(),
        np.asarray(JB.bin_key(jnp.asarray(o), jnp.asarray(d), jlo, jhi,
                              jnp.asarray(alive))))
    jsidx, (jo_s,) = JB.bin_sort(jk, jnp.asarray(o))
    tsidx, (to_s,) = TB.bin_sort(tk, to)
    np.testing.assert_array_equal(tsidx.numpy(), np.asarray(jsidx))
    np.testing.assert_array_equal(to_s.numpy(), np.asarray(jo_s))
    (back,) = TB.unsort(tsidx, to_s)
    assert torch.equal(back, to)


@pytest.mark.parametrize("with_alive", [True, False], ids=["alive", "all"])
def test_ray_bin_order_and_scene_bounds_bit_equal(packs, accels, with_alive):
    """The public binning helpers: `ray_bin_order`'s permutation and its
    inverse (dead rays last; keys tie, so the order is the stable one) and
    `scene_bounds` of the CS 16 accel, bit-equal to JAX's; the renderer's
    two-phase cap is reckoned from those bounds."""
    p = packs[1]
    o, d = p[0:3].T.copy(), p[4:7].T.copy()
    alive = (p[7] != 0) if with_alive else None
    j_acc, t_acc = accels[16]
    jlo, jhi = JB.scene_bounds(j_acc)
    tlo, thi = TB.scene_bounds(t_acc)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    jorder, jinv = JB.ray_bin_order(
        jnp.asarray(o), jnp.asarray(d), jlo, jhi,
        None if alive is None else jnp.asarray(alive))
    torder, tinv = TB.ray_bin_order(
        torch.from_numpy(o), torch.from_numpy(d), tlo, thi,
        None if alive is None else torch.from_numpy(alive))
    assert torder.dtype == tinv.dtype == torch.int32
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    assert torch.equal(torder[tinv.long()], torch.arange(o.shape[0],
                                                         dtype=torch.int32))
    if alive is not None:  # dead rays compacted to the end
        n_alive = int(alive.sum())
        assert bool(torch.from_numpy(alive)[torder[:n_alive].long()].all())
    cfg = RenderConfig(gi_cap_frac=0.1)
    from raytracing_tpu_torch.models.whitted import bounce_cap
    assert bounce_cap(t_acc, cfg) == 0.1 * float(torch.linalg.norm(thi - tlo))
