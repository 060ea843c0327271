"""The bounce levels' culling tile (`RenderConfig.gi_ray_tile`, and
`ray_tile=` of every query and kernel wrapper) on the CPU, through the
kernels' plain versions.

- The port of tests/test_render.py:236 (`test_gi_ray_tile_knob`, its very
  config and JAX's draws): frames at tiles of 128, 256 and 512 rays
  bit-equal to the default frame (1,024); a path-traced and an area-light
  frame at 256 bit-equal to theirs. (JAX's Pallas frame at 256 is held at
  atol 1e-5 in tests/test_torch_render.py.)
- The plain versions at 256 against the JAX package's functions at
  `ray_tile=256` in interpret mode: K6's extents, K5's dense bits and its
  gathered lists (`_lane_refine_lists`), the frustum lists, all bit for
  bit (lists as sets, in order of entry); the walks through
  `nearest_hit_attrs_soa` / `any_hit_soa(ray_tile=256)`: slots and flags
  equal, t at the tolerances of tests/test_torch_traverse.py (XLA
  contracts a*b+c, the port does not). K3 and K4 at 256 equal K1's.
- The gradient of a differentiated render with bounce levels at 256:
  bit-equal to the default tile's, and JAX's `jax.grad` at 256 at rtol
  2e-4 + atol 1e-7 (tests/test_torch_grad.py's bar).
- The refusal of a tile outside `traverse.RAY_TILES` (above 1,024 a
  departure from the JAX package, which pads to any tile).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raytracing_tpu.kernels.traverse as JT
from raytracing_tpu.accel.packets import build_cluster_accel as jax_build
from raytracing_tpu.config import RenderConfig as JaxConfig
from raytracing_tpu.geometry.mesh import concat_objects as jax_concat
from raytracing_tpu.geometry.scene import build_default_scene as jax_scene
from raytracing_tpu.models import whitted as JW

import raytracing_tpu_torch.kernels.traverse as T
from raytracing_tpu_torch import (PathTracerConfig, RenderConfig,
                                  SphereLight, render_path_traced)
from raytracing_tpu_torch.accel import packets
from raytracing_tpu_torch.accel.packets import (accel_from_numpy,
                                                build_cluster_accel)
from raytracing_tpu_torch.geometry.mesh import Scene, scene_from_numpy
from raytracing_tpu_torch.geometry.scene import build_default_scene
from raytracing_tpu_torch.models import whitted as TW

torch.set_num_threads(2)

TILE = 256
# tests/test_render.py:236's config (small_cfg with the pallas backend).
KNOB = dict(width=16, height=16, samples_per_pixel=1, chunk_size=16 * 16,
            reflect_depth=2, diffuse_depth=2, diffuse_scatter=2)


def jax_uniforms(seed: int, n_chunks: int):
    """uniforms(i, depth, shape): what JAX's renderer draws for chunk i's
    diffuse fan (tests/test_torch_render.py)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_chunks)

    def draw(i, depth, shape):
        u = jax.random.uniform(jax.random.fold_in(keys[i], depth), shape,
                               dtype=jnp.float32)
        return torch.from_numpy(np.array(u))

    return draw


@pytest.fixture(scope="module")
def scene():
    return build_default_scene(t=0.0, device="cpu")


@pytest.fixture(scope="module")
def accel16(scene):
    return build_cluster_accel(scene.mesh, cluster_size=16)


@pytest.fixture(scope="module")
def knob_frame(scene, accel16):
    return TW.render(scene, RenderConfig(**KNOB), accel=accel16,
                     uniforms=jax_uniforms(5, 1))


@pytest.mark.parametrize("ray_tile", [128, 256, 512])
def test_gi_ray_tile_knob(scene, accel16, knob_frame, ray_tile):
    """The bounce levels (trace, sun shadow) walk tiles of `ray_tile`
    rays: a pure performance knob, the image equal to the default bit for
    bit (same entered sets, same intersection math, same draws)."""
    img = TW.render(scene, RenderConfig(**KNOB, gi_ray_tile=ray_tile),
                    accel=accel16, uniforms=jax_uniforms(5, 1))
    assert bool(torch.isfinite(img).all())
    assert torch.equal(img, knob_frame)


def test_gi_ray_tile_reaches_every_bounce_query(scene, accel16,
                                                monkeypatch):
    """Every depth > 1 query of the frame (nearest, sun shadow, area-light
    shadow) takes the tile, and no primary query does."""
    seen = []
    walk_groups = T._walk_groups

    def spy(accel, rp, *args, **kw):
        seen.append((kw.get("ray_tile"), bool(args[1])))
        return walk_groups(accel, rp, *args, **kw)

    monkeypatch.setattr(T, "_walk_groups", spy)
    light = SphereLight(torch.tensor([[1.0, 8.0, 7.0]]), torch.tensor([1.5]),
                        torch.tensor([[1.5, 1.5, 1.5]]))
    TW.render(Scene(scene.mesh, scene.sun, light),
              RenderConfig(**KNOB, gi_ray_tile=TILE, light_samples=1),
              accel=accel16, generator=torch.Generator().manual_seed(5))
    # depth 1: nearest, sun shadow, light shadow (None: the default tile);
    # depth 2 the same.
    assert [T.check_ray_tile(t) for t, _ in seen] == [1024] * 3 + [TILE] * 3
    assert [nearest for _, nearest in seen] == [True, False, False] * 2


def test_path_traced_and_area_light_frames(scene, accel16):
    """A path-traced frame (segments after the first at 256) and an
    area-light frame (bounce levels' light shadows at 256), each
    bit-equal to its frame at the default tile."""
    light = SphereLight(torch.tensor([[1.0, 8.0, 7.0]]), torch.tensor([1.5]),
                        torch.tensor([[1.5, 1.5, 1.5]]))
    lit = Scene(scene.mesh, scene.sun, light)
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=1,
                       chunk_size=256, reflect_depth=2, diffuse_depth=2,
                       diffuse_scatter=2, light_samples=2)
    pt = PathTracerConfig(max_bounces=3, samples_per_pixel=2)
    frames = {}
    for t in (0, TILE):
        c = cfg.replace(gi_ray_tile=t)
        frames[t] = (
            render_path_traced(scene, c, pt, accel=accel16,
                               generator=torch.Generator().manual_seed(3)),
            TW.render(lit, c, accel=accel16,
                      generator=torch.Generator().manual_seed(3)))
    for a, b in zip(frames[0], frames[TILE]):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, b)
    assert float((frames[0][1] - TW.render(
        scene, cfg, accel=accel16,
        generator=torch.Generator().manual_seed(3))).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# The plain versions at 256 against JAX's functions at ray_tile=256
# ---------------------------------------------------------------------------


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
    """8 tiles of 256: bounce-like rays among the teapots (one lane in ten
    dead), tile 2 with 3 alive lanes, tile 5 with none."""
    rng = np.random.default_rng(11)
    n = 8 * TILE
    o = np.array([1.0, -1.2, 7.5]) + rng.normal(scale=[2.0, 0.6, 1.5],
                                                size=(n, 3))
    d = rng.normal(size=(n, 3))
    alive = (rng.uniform(size=n) > 0.1).astype(np.float64)
    alive[2 * TILE:3 * TILE] = 0.0
    alive[2 * TILE + np.array([7, 100, 200])] = 1.0
    alive[5 * TILE:6 * TILE] = 0.0
    p = np.concatenate([o.T, np.ones((1, n)), d.T, alive[None]])
    return np.ascontiguousarray(p, dtype=np.float32)


def test_extents_and_dense_bits_equal_jax(pack, accels):
    j_acc, t_acc = accels[128]
    jp, tp = jnp.asarray(pack), torch.from_numpy(pack)
    jlo, jhi = JT._tile_extents_pallas(jp, TILE, interpret=True)
    lo, hi = T.tile_extents(tp, TILE)
    assert lo.shape == (8, 8)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert not bool(hi[5, 7] > 0) and bool((hi[[0, 2], 7] > 0).all())
    je = JT._refine_dense(jp, j_acc.cluster_min, j_acc.cluster_max, TILE,
                          interpret=True, tile_alive=jhi[:, 7] > 0.0)
    flo, fhi, fent = T.refine_dense_extents(tp, t_acc.cluster_min,
                                            t_acc.cluster_max, ray_tile=TILE)
    np.testing.assert_array_equal(flo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(fhi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(fent.numpy(), np.asarray(je))
    assert fent[2].any() and not fent[5].any()
    assert int(fent[2].sum()) < int(fent[0].sum())
    # The same bits with the flags given.
    ent = T.refine_dense(tp, t_acc.cluster_min, t_acc.cluster_max,
                         fhi[:, 7] > 0.0, ray_tile=TILE)
    assert torch.equal(ent, fent)


def test_lists_equal_jax(pack, accels):
    """The frustum lists (CS 16, 790 clusters): counts equal, each tile's
    listed clusters JAX's as sets, front to back. The gathered refinement
    of them (K5's gathered form, above 512 clusters) keeps, of each tile's
    listed clusters, those JAX's `_lane_refine_lists` keeps. (JAX's also
    keeps every position past a short list's count: its "inverted" boxes
    there, min +3e38 and max -3e38, pass a slab test that takes the min
    and max of the two slab distances, so its count is the tile's kept
    clusters plus the unlisted positions, 588 = 10 + 578 for tile 2; the
    walk stays exact, it visits more. The port keeps listed positions
    only.)"""
    j_acc, t_acc = accels[16]
    jp, tp = jnp.asarray(pack), torch.from_numpy(pack)
    jl = JT._tile_visit_lists_soa(jp, j_acc.cluster_min, j_acc.cluster_max,
                                  TILE, interpret=True)
    ids, tnear, cnt = T._tile_visit_lists_soa(
        tp, t_acc.cluster_min, t_acc.cluster_max, ray_tile=TILE)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jl[2]))
    jrids, _, jrcnt = JT._lane_refine_lists(
        jp, *jl, j_acc.cluster_min, j_acc.cluster_max, TILE,
        j_acc.num_clusters, True)
    rids, rtnear, rcnt = T._refined_lists(t_acc, tp, ray_tile=TILE)
    assert 0 < int(rcnt.sum()) < int(cnt.sum()) and int(rcnt[5]) == 0
    jrids, jrcnt = np.asarray(jrids), np.asarray(jrcnt)
    for k in range(8):
        c, rc = int(cnt[k]), int(rcnt[k])
        listed = set(ids[k, :c].tolist())
        assert listed == set(np.asarray(jl[0])[k, :c].tolist())
        kept = set(rids[k, :rc].tolist())
        assert kept == listed & set(jrids[k, :jrcnt[k]].tolist())
        assert jrcnt[k] == rc + (ids.shape[1] - c if c else 0)
        assert bool((tnear[k, 1:c] >= tnear[k, :max(c - 1, 0)]).all())
        assert bool((rtnear[k, 1:rc] >= rtnear[k, :max(rc - 1, 0)]).all())
    # K5's gathered form alone keeps those sets.
    nids, _, ncnt = T._narrow_lists(ids, tnear, cnt)
    keep = T.refine_lists(tp, nids, ncnt, t_acc.cluster_min,
                          t_acc.cluster_max, ray_tile=TILE)
    for k in range(8):
        assert set(nids[k][keep[k]].tolist()) == set(
            rids[k, :int(rcnt[k])].tolist())


@pytest.mark.parametrize("cs,wq", [(16, False), (128, True)],
                         ids=["cs16", "cs128-wq"])
def test_walks_equal_jax(pack, accels, cs, wq):
    """K1 (CS 16) and K2 over refined lists (CS 128, wq), early exit on;
    and occlusion under a scalar t_max."""
    j_acc, t_acc = accels[cs]
    jp, tp = jnp.asarray(pack), torch.from_numpy(pack)
    m = pack[7] != 0
    jt, js, ja = JT.nearest_hit_attrs_soa(j_acc, jp, interpret=True,
                                          early_exit=True, wq=wq,
                                          ray_tile=TILE)
    tt, ts, ta = T.nearest_hit_attrs_soa(t_acc, tp, early_exit=True, wq=wq,
                                         ray_tile=TILE)
    jt, js, ja = np.asarray(jt)[m], np.asarray(js)[m], np.asarray(ja)[:, m]
    tt, ts, ta = tt.numpy()[m], ts.numpy()[m], ta.numpy()[:, m]
    hit = np.isfinite(jt)
    assert hit.sum() > 100 and (~hit).sum() > 100
    np.testing.assert_array_equal(np.isfinite(tt), hit)
    np.testing.assert_array_equal(ts[hit], js[hit])
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-6, atol=1e-6)
    jo = np.asarray(JT.any_hit_soa(j_acc, jp, t_max=30.0, interpret=True,
                                   wq=wq, ray_tile=TILE))
    to = T.any_hit_soa(t_acc, tp, t_max=30.0, wq=wq, ray_tile=TILE).numpy()
    assert jo[m].any() and not jo[m].all()
    np.testing.assert_array_equal(to[m], jo[m])


def test_grouped_and_work_queue_walks_at_the_tile(pack, accels,
                                                  monkeypatch):
    """K3 (the CS 16 table in 4 groups) and K4 (`_WQ_IMPL = "grid"`) at
    256: t, slots and attributes equal K1's at 256 on alive lanes, and
    the default tile's."""
    _, acc = accels[16]
    tp = torch.from_numpy(pack)
    m = torch.from_numpy(pack[7] != 0)
    want = T.nearest_hit_attrs_soa(acc, tp, ray_tile=TILE)
    assert all(torch.equal(a[..., m], b[..., m]) for a, b in
               zip(want, T.nearest_hit_attrs_soa(acc, tp)))
    monkeypatch.setattr(T, "_WQ_IMPL", "grid")
    k4 = T.nearest_hit_attrs_soa(acc, tp, wq=True, ray_tile=TILE)
    monkeypatch.setattr(packets, "_GROUP_BLOCK_BUDGET_BYTES", 1)
    args, kw = T._gstream_walk_args(acc, tp, 1e-8, True, T.INF, 4,
                                    ray_tile=TILE)
    assert args[1].shape[:2] == (4, 8) and kw["ray_tile"] == TILE
    k3 = T.nearest_hit_attrs_soa(acc, tp, ray_tile=TILE)
    for got in (k3, k4):
        assert all(torch.equal(a[..., m], b[..., m])
                   for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# Gradients at the tile
# ---------------------------------------------------------------------------


DEEP = dict(width=8, height=8, samples_per_pixel=1, reflect_depth=2,
            diffuse_depth=2, diffuse_scatter=2, normals="geometric")
TABLES = ("verts", "colors", "materials")
WEIGHTS = np.array([0.3, 0.5, 0.2], np.float32)


def _grad_draws(key):
    def draw(tag, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, tag), shape, dtype=jnp.float32)))

    return draw


def test_gradient_at_the_tile_equals_default_and_jax():
    """tests/test_grad.py's triangle with a reflective material (a
    reflection and a diffuse fan: level 2 walks at 256),
    gradients of sum(rgb * w) for verts, colors and materials."""
    verts = np.array([[-2.0, -2.0, 5.0], [3.0, -2.0, 5.0], [-2.0, 3.0, 5.0]],
                     np.float32)
    jm = jax_concat([{"verts": verts, "tri_v": np.array([[0, 2, 1]],
                                                        np.int32),
                      "colors": np.array([0.8, 0.6, 0.4], np.float32),
                      "material": (1.0, 0.0, 0.5)}])
    jm = jm._replace(materials=jnp.asarray(
        np.array([[1.0 / np.pi, 0.5, 0.5]], np.float32)))
    sun = jnp.array([200.0, 300.0, -1000.0])
    ja = jax_build(jm, cluster_size=8)
    arrays = {k: np.asarray(v) for k, v in jm._asdict().items()}
    arrays["sun"] = np.asarray(sun)
    ts = scene_from_numpy(arrays, device="cpu")
    ta = accel_from_numpy({k: (None if v is None else np.asarray(v))
                           for k, v in ja._asdict().items()}, device="cpu")
    xs = np.linspace(-0.1, 0.15, 8).astype(np.float32)
    o = np.zeros((8, 3), np.float32)
    d = np.stack([xs, xs * 0.5 + 0.02, np.ones(8, np.float32)], axis=-1)

    def port(ray_tile):
        tables = {k: getattr(ts.mesh, k).clone().requires_grad_()
                  for k in TABLES}
        rgb = TW.render_rays(ts.mesh._replace(**tables), ta, ts.sun,
                             torch.from_numpy(o), torch.from_numpy(d),
                             RenderConfig(**DEEP, gi_ray_tile=ray_tile),
                             _grad_draws(jax.random.PRNGKey(0)))
        (rgb * torch.from_numpy(WEIGHTS)).sum().backward()
        return {k: v.grad.numpy() for k, v in tables.items()}

    got, default = port(TILE), port(0)
    jcfg = JaxConfig(backend="pallas", gi_ray_tile=TILE, **DEEP)

    def loss(*vals):
        mesh = jm._replace(**dict(zip(TABLES, vals)))
        rgb = JW.render_rays(mesh, ja, sun, jnp.asarray(o), jnp.asarray(d),
                             jax.random.PRNGKey(0), jcfg)
        return jnp.sum(rgb * WEIGHTS)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(getattr(jm, k) for k in TABLES))
    for k, w in zip(TABLES, want):
        assert np.abs(got[k]).max() > 0, k
        np.testing.assert_array_equal(got[k], default[k], err_msg=k)
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=2e-4,
                                   atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# What is refused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", [2048, 384, 64, 1000])
def test_tiles_outside_the_accepted_set_are_refused(scene, accel16, pack,
                                                    bad):
    """The port takes tiles of 128, 256, 512 and 1,024 rays. Above 1,024
    it departs from the JAX package (which pads to any tile): 2,048 is
    refused, by the query, the wrappers and the frame alike."""
    with pytest.raises(ValueError, match="128, 256, 512, 1024"):
        T.check_ray_tile(bad)
    tp = torch.from_numpy(pack)
    with pytest.raises(ValueError, match="128, 256, 512, 1024"):
        T.nearest_hit_attrs_soa(accel16, tp, ray_tile=bad)
    with pytest.raises(ValueError, match="128, 256, 512, 1024"):
        T.tile_extents(tp, bad)
    with pytest.raises(ValueError, match="128, 256, 512, 1024"):
        TW.render(scene, RenderConfig(**KNOB, gi_ray_tile=bad),
                  accel=accel16)


def test_accepted_tiles_and_their_grids():
    """Every accepted tile divides the tile a query pads to; a pack of N
    rays makes N / T tiles and a walk launch 4x the blocks at 256."""
    assert T.RAY_TILES == (128, 256, 512, 1024) and T.RAY_TILE == 1024
    assert all(T.RAY_TILE % t == 0 and t % 128 == 0 for t in T.RAY_TILES)
    assert T.check_ray_tile(None) == T.RAY_TILE
    rp = torch.zeros((8, 4096))
    assert [T._check_pack(rp, t) for t in T.RAY_TILES] == [32, 16, 8, 4]
    seg = T._walk_segment(128)  # a 720,896-ray wavefront's K2 launch
    assert T._walk_grid("walk", 704, 100, seg, T._MAX_TILE_BLOCKS) == 50
    assert T._walk_grid("walk", 2816, 100, seg, T._MAX_TILE_BLOCKS) == 50
    assert T._count_key("walk_dma", ray_tile=256) == "walk_dma_rt256"
    assert T._count_key("walk_dma") == "walk_dma"
    with pytest.raises(ValueError, match="whole tiles of 256"):
        T.tile_extents_plain(torch.zeros((8, 300)), 256)
