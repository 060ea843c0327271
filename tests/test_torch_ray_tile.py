"""The bounce levels' culling tile (`RenderConfig.gi_ray_tile`, and
`ray_tile=` of every query and kernel wrapper) on the CPU, through the
kernels' plain versions.

- The port of tests/test_render.py:236 (`test_gi_ray_tile_knob`, its very
  config and JAX's draws): frames at tiles of 128, 256, 512, 384 and 2,048
  rays bit-equal to the default frame (1,024); a path-traced and an
  area-light frame at 256 bit-equal to theirs. (JAX's Pallas frame at 256
  is held at atol 1e-5 in tests/test_torch_render.py.)
- The plain versions at 256, 384, 768, 1,536 and 2,048 against the JAX
  package's functions at the same `ray_tile` in interpret mode: K6's
  extents, K5's dense bits and its gathered lists (`_lane_refine_lists`),
  the frustum lists, all bit for bit (lists as sets, in order of entry);
  the walks through `nearest_hit_attrs_soa` / `any_hit_soa(ray_tile=)`:
  slots and flags equal, t at the tolerances of
  tests/test_torch_traverse.py (XLA contracts a*b+c, the port does not).
  K3 and K4 at 256 equal K1's.
- The card's composition of a tile outside `traverse.RAY_TILES` (384 =
  3 x 128, 2,048 = 2 x 1,024), each wrapper's own code with its launches
  at s replaced by their plain versions, against the plain version at
  the tile, bit for bit.
- The gradient of a differentiated render with bounce levels at 256 and
  384: bit-equal to the default tile's, and JAX's `jax.grad` at rtol
  2e-4 + atol 1e-7 (tests/test_torch_grad.py's bar).
- What is refused: a tile that is not a positive multiple of 128 (64,
  1,000), by the query, the wrappers and the frame; a kernel launch's
  tile outside `traverse.RAY_TILES` (384, 2,048), which the queries build
  from launches at a tile of RAY_TILES.
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


@pytest.mark.parametrize("ray_tile", [128, 256, 512, 384, 2048])
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
# The plain versions against JAX's functions at the same ray_tile
# ---------------------------------------------------------------------------

# The tiles outside RAY_TILES the JAX package takes, held here beside 256.
NEW_TILES = (384, 768, 1536, 2048)


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


def _bounce_pack(n, sparse, dead):
    """n bounce-like rays among the teapots (one lane in ten dead): the
    run `sparse` with 3 alive lanes, the runs `dead` with none."""
    rng = np.random.default_rng(11)
    o = np.array([1.0, -1.2, 7.5]) + rng.normal(scale=[2.0, 0.6, 1.5],
                                                size=(n, 3))
    d = rng.normal(size=(n, 3))
    alive = (rng.uniform(size=n) > 0.1).astype(np.float64)
    alive[sparse[0]:sparse[1]] = 0.0
    alive[sparse[0] + np.array([7, 100, 200])] = 1.0
    for a, b in dead:
        alive[a:b] = 0.0
    p = np.concatenate([o.T, np.ones((1, n)), d.T, alive[None]])
    return np.ascontiguousarray(p, dtype=np.float32)


@pytest.fixture(scope="module")
def pack():
    """8 tiles of 256: tile 2 with 3 alive lanes, tile 5 with none."""
    return _bounce_pack(8 * TILE, (2 * TILE, 3 * TILE),
                        [(5 * TILE, 6 * TILE)])


@pytest.fixture(scope="module")
def wide():
    """6,144 rays, whole tiles of every one of NEW_TILES: rays 512-767
    with 3 alive lanes, 1,280-1,535 and 4,096-5,119 with none, so that
    at each tile some tile is alive with a dead launch tile (1,024 at
    2,048; 512 at 1,536; 256 at 768; 128 at 384), and at 384 and 768
    some tile is dead."""
    return _bounce_pack(6144, (512, 768), [(1280, 1536), (4096, 5120)])


def _pack_at(ray_tile, pack, wide):
    return pack if ray_tile == TILE else wide


def _dead_tiles(p, ray_tile):
    return ~(p[7].reshape(-1, ray_tile) != 0).any(axis=1)


@pytest.mark.parametrize("ray_tile", (TILE,) + NEW_TILES)
def test_extents_and_dense_bits_equal_jax(pack, wide, accels, ray_tile):
    j_acc, t_acc = accels[128]
    p = _pack_at(ray_tile, pack, wide)
    nt = p.shape[1] // ray_tile
    dead = _dead_tiles(p, ray_tile)
    jp, tp = jnp.asarray(p), torch.from_numpy(p)
    jlo, jhi = JT._tile_extents_pallas(jp, ray_tile, interpret=True)
    lo, hi = T.tile_extents(tp, ray_tile)
    assert lo.shape == (nt, 8)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal((hi[:, 7] > 0).numpy(), ~dead)
    je = JT._refine_dense(jp, j_acc.cluster_min, j_acc.cluster_max,
                          ray_tile, interpret=True,
                          tile_alive=jhi[:, 7] > 0.0)
    flo, fhi, fent = T.refine_dense_extents(tp, t_acc.cluster_min,
                                            t_acc.cluster_max,
                                            ray_tile=ray_tile)
    np.testing.assert_array_equal(flo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(fhi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(fent.numpy(), np.asarray(je))
    assert not fent[torch.from_numpy(dead)].any()
    if ray_tile == TILE:
        assert fent[2].any() and int(fent[2].sum()) < int(fent[0].sum())
    # The same bits with the flags given.
    ent = T.refine_dense(tp, t_acc.cluster_min, t_acc.cluster_max,
                         fhi[:, 7] > 0.0, ray_tile=ray_tile)
    assert torch.equal(ent, fent)


@pytest.mark.parametrize("ray_tile", (TILE,) + NEW_TILES)
def test_lists_equal_jax(pack, wide, accels, ray_tile):
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
    p = _pack_at(ray_tile, pack, wide)
    nt = p.shape[1] // ray_tile
    jp, tp = jnp.asarray(p), torch.from_numpy(p)
    jl = JT._tile_visit_lists_soa(jp, j_acc.cluster_min, j_acc.cluster_max,
                                  ray_tile, interpret=True)
    ids, tnear, cnt = T._tile_visit_lists_soa(
        tp, t_acc.cluster_min, t_acc.cluster_max, ray_tile=ray_tile)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jl[2]))
    jrids, _, jrcnt = JT._lane_refine_lists(
        jp, *jl, j_acc.cluster_min, j_acc.cluster_max, ray_tile,
        j_acc.num_clusters, True)
    rids, rtnear, rcnt = T._refined_lists(t_acc, tp, ray_tile=ray_tile)
    assert 0 < int(rcnt.sum()) < int(cnt.sum())
    assert not rcnt[torch.from_numpy(_dead_tiles(p, ray_tile))].any()
    jrids, jrcnt = np.asarray(jrids), np.asarray(jrcnt)
    for k in range(nt):
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
                          t_acc.cluster_max, ray_tile=ray_tile)
    for k in range(nt):
        assert set(nids[k][keep[k]].tolist()) == set(
            rids[k, :int(rcnt[k])].tolist())


@pytest.fixture(scope="module")
def jax_walks(pack, accels):
    """JAX's walks on `pack` at 256 ((cs, wq) -> (t, slots, attrs,
    occlusion under t_max 30)), each computed once: no result of the
    JAX package depends on the tile (its tests/test_render.py:236 holds
    its frames equal across tiles), and its interpret mode takes 10-20 s
    a walk."""
    held = {}

    def walks(cs, wq):
        if (cs, wq) not in held:
            j_acc = accels[cs][0]
            jp = jnp.asarray(pack)
            near = JT.nearest_hit_attrs_soa(j_acc, jp, interpret=True,
                                            early_exit=True, wq=wq,
                                            ray_tile=TILE)
            occ = JT.any_hit_soa(j_acc, jp, t_max=30.0, interpret=True,
                                 wq=wq, ray_tile=TILE)
            held[(cs, wq)] = tuple(map(np.asarray, near + (occ,)))
        return held[(cs, wq)]

    return walks


@pytest.mark.parametrize(
    "cs,wq,ray_tile",
    [(16, False, TILE), (128, True, TILE), (16, False, 384),
     (128, True, 768), (16, False, 1536), (128, True, 2048)],
    ids=["cs16", "cs128-wq", "cs16-rt384", "cs128-wq-rt768",
         "cs16-rt1536", "cs128-wq-rt2048"])
def test_walks_equal_jax(pack, accels, jax_walks, cs, wq, ray_tile):
    """K1 (CS 16) and K2 over refined lists (CS 128, wq), early exit on;
    and occlusion under a scalar t_max; the port at `ray_tile` (the pack
    padded to whole tiles of it) against JAX's walks at 256."""
    t_acc = accels[cs][1]
    tp = torch.from_numpy(pack)
    m = pack[7] != 0
    jt, js, ja, jo = jax_walks(cs, wq)
    tt, ts, ta = T.nearest_hit_attrs_soa(t_acc, tp, early_exit=True, wq=wq,
                                         ray_tile=ray_tile)
    jt, js, ja = jt[m], js[m], ja[:, m]
    tt, ts, ta = tt.numpy()[m], ts.numpy()[m], ta.numpy()[:, m]
    hit = np.isfinite(jt)
    assert hit.sum() > 100 and (~hit).sum() > 100
    np.testing.assert_array_equal(np.isfinite(tt), hit)
    np.testing.assert_array_equal(ts[hit], js[hit])
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-6, atol=1e-6)
    to = T.any_hit_soa(t_acc, tp, t_max=30.0, wq=wq,
                       ray_tile=ray_tile).numpy()
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


@pytest.fixture(scope="module")
def grad_case():
    """tests/test_grad.py's triangle with a reflective material (a
    reflection and a diffuse fan: level 2 walks at the bounce tile),
    gradients of sum(rgb * w) for verts, colors and materials: (the
    port's at a gi_ray_tile, the port's at the default tile, JAX's
    `jax.grad` at 256 — computed once: JAX's walks do not depend on the
    tile, and its interpret mode takes ~15 s)."""
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

    jcfg = JaxConfig(backend="pallas", gi_ray_tile=TILE, **DEEP)

    def loss(*vals):
        mesh = jm._replace(**dict(zip(TABLES, vals)))
        rgb = JW.render_rays(mesh, ja, sun, jnp.asarray(o), jnp.asarray(d),
                             jax.random.PRNGKey(0), jcfg)
        return jnp.sum(rgb * WEIGHTS)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(getattr(jm, k) for k in TABLES))
    return port, port(0), dict(zip(TABLES, map(np.asarray, want)))


@pytest.mark.parametrize("ray_tile", [TILE, 384])
def test_gradient_at_the_tile_equals_default_and_jax(grad_case, ray_tile):
    """The gradients with the bounce level at `ray_tile`: bit-equal to
    the default tile's, and JAX's at rtol 2e-4 + atol 1e-7."""
    port, default, want = grad_case
    got = port(ray_tile)
    for k in TABLES:
        assert np.abs(got[k]).max() > 0, k
        np.testing.assert_array_equal(got[k], default[k], err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-7,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# The card's composition of a tile outside RAY_TILES
# ---------------------------------------------------------------------------


@pytest.fixture
def as_card(monkeypatch):
    """as_card(wrapper, *args, **kw): the wrapper's own card path on CPU
    tensors, down to its launches at a tile of RAY_TILES, which then run
    their plain versions (`_on_cpu` answers False once, to the wrapper
    called; its calls at s see the CPU)."""
    real, card = T._on_cpu, [0]

    def on_cpu(*tensors):
        if card[0]:
            card[0] = 0
            return False
        return real(*tensors)

    monkeypatch.setattr(T, "_on_cpu", on_cpu)

    def run(wrapper, *args, **kw):
        card[0] = 1
        out = wrapper(*args, **kw)
        assert card[0] == 0
        return out

    return run


def _equal_on(alive, got, want):
    return all(torch.equal(a[..., alive], b[..., alive])
               for a, b in zip(got, want) if a is not None)


@pytest.mark.parametrize("ray_tile", [384, 2048])
def test_composed_wrappers_equal_their_plain_versions(pack, wide, accels,
                                                      as_card, monkeypatch,
                                                      ray_tile):
    """A tile outside RAY_TILES, as the card builds it (`_split_tile`: 384
    from 3 launch tiles of 128, 2,048 from 2 of 1,024): K6, K5 dense
    (flags given, and with K6) and gathered on `wide`, where some tile
    holds a dead launch tile; K1 with the lane cull, K2 with the early
    exit, K3 (the CS 16 table in 4 groups) and K4 on `pack` padded to
    whole tiles; each equal to its plain version at the tile, bit for
    bit (the walks on alive lanes)."""
    s, k = T._split_tile(ray_tile)
    assert s in T.RAY_TILES and k > 1 and T.check_query_tile(ray_tile) \
        == ray_tile
    tp = torch.from_numpy(wide)
    _, a16 = accels[16]
    _, a128 = accels[128]
    boxes = (a128.cluster_min, a128.cluster_max)
    lo, hi = as_card(T.tile_extents, tp, ray_tile)
    want = T.tile_extents_plain(tp, ray_tile)
    assert torch.equal(lo, want[0]) and torch.equal(hi, want[1])
    sub = (T.tile_extents_plain(tp, s)[1][:, 7] > 0).reshape(-1, k)
    assert bool((sub.any(dim=1) & ~sub.all(dim=1)).any())
    flags = want[1][:, 7] > 0
    assert torch.equal(
        as_card(T.refine_dense, tp, *boxes, flags, ray_tile=ray_tile),
        T.refine_dense_plain(tp, *boxes, flags, ray_tile=ray_tile))
    got = as_card(T.refine_dense_extents, tp, *boxes, ray_tile=ray_tile)
    assert all(torch.equal(a, b) for a, b in zip(
        got, T.refine_dense_extents_plain(tp, *boxes, ray_tile=ray_tile)))
    ids, _, cnt = T._narrow_lists(*T._tile_visit_lists_soa(
        tp, a16.cluster_min, a16.cluster_max, ray_tile=ray_tile))
    lists = (tp, ids, cnt, a16.cluster_min, a16.cluster_max)
    keep = as_card(T.refine_lists, *lists, ray_tile=ray_tile)
    assert keep.any() and torch.equal(
        keep, T.refine_lists_plain(*lists, ray_tile=ray_tile))

    rp, _ = T._pad_rays_soa(torch.from_numpy(pack), ray_tile)
    alive = rp[7] != 0
    na = a16.attr_blocks.shape[1]
    args, kw = T._groups_walk_args(a16, rp, 1e-8, True, T.INF, na,
                                   early_exit=True, lane_cull=True,
                                   ray_tile=ray_tile)
    assert _equal_on(alive, as_card(T.walk, *args, **kw), T.walk_plain(
        *args, ray_tile=ray_tile, lane_bounds=kw["lane_bounds"]))
    args, kw = T._dma_walk_args(a128, rp, 1e-8, True, T.INF, na,
                                early_exit=True, ray_tile=ray_tile)
    assert _equal_on(alive, as_card(T.walk, *args, **kw),
                     T.walk_plain(*args, ray_tile=ray_tile))
    args, kw = T._wq_walk_args(a128, rp, 1e-8, False, 30.0, 0,
                               ray_tile=ray_tile)
    assert _equal_on(alive, as_card(T.walk_wq, *args, **kw),
                     T.walk_wq_plain(*args, **kw))
    monkeypatch.setattr(packets, "_GROUP_BLOCK_BUDGET_BYTES", 1)
    args, kw = T._gstream_walk_args(a16, rp, 1e-8, True, T.INF, na,
                                    early_exit=True, ray_tile=ray_tile)
    assert args[1].shape[0] == 4
    assert _equal_on(alive, as_card(T.walk_gstream, *args, **kw),
                     T.walk_gstream_plain(*args, ray_tile=ray_tile))


# ---------------------------------------------------------------------------
# What is refused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", [2048, 384, 64, 1000])
def test_tiles_outside_the_accepted_set_are_refused(scene, accel16, pack,
                                                    bad):
    """A kernel launch takes tiles of 128, 256, 512 and 1,024 rays
    (`check_ray_tile`). A query takes any positive multiple of 128, as
    the JAX package does: 384 and 2,048 are taken by the query, the
    wrappers and the frame, which build them from launches at 128 and
    1,024; 64 and 1,000 are refused by all of them."""
    with pytest.raises(ValueError, match="128, 256, 512, 1024"):
        T.check_ray_tile(bad)
    tp = torch.from_numpy(pack)
    small = RenderConfig(**dict(KNOB, width=8, height=8, chunk_size=64),
                         gi_ray_tile=bad)
    if bad % 128 == 0:
        assert T.check_query_tile(bad) == bad
        rp, _ = T._pad_rays_soa(tp, bad)
        t, slot, _ = T.nearest_hit_attrs_soa(accel16, tp, ray_tile=bad)
        assert t.shape == (tp.shape[1],) and torch.isfinite(t).any()
        assert T.tile_extents(rp, bad)[0].shape == (rp.shape[1] // bad, 8)
        assert bool(torch.isfinite(TW.render(scene, small,
                                             accel=accel16)).all())
        return
    why = "a positive multiple of 128 rays"
    with pytest.raises(ValueError, match=why):
        T.check_query_tile(bad)
    with pytest.raises(ValueError, match=why):
        T.nearest_hit_attrs_soa(accel16, tp, ray_tile=bad)
    with pytest.raises(ValueError, match=why):
        T.tile_extents(tp, bad)
    with pytest.raises(ValueError, match=why):
        TW.render(scene, small, accel=accel16)


def test_accepted_tiles_and_their_grids():
    """Every launch tile divides the tile a query pads to; a query's tile
    is any multiple of 128, padded to whole tiles of it and of RAY_TILE
    and split into launches at the largest launch tile dividing it; a
    pack of N rays makes N / T tiles and a walk launch 4x the blocks at
    256; the plain versions' temporaries stay bounded at 4,096."""
    assert T.RAY_TILES == (128, 256, 512, 1024) and T.RAY_TILE == 1024
    assert all(T.RAY_TILE % t == 0 and t % 128 == 0 for t in T.RAY_TILES)
    assert T.check_ray_tile(None) == T.RAY_TILE
    assert T.check_query_tile(None) == T.RAY_TILE
    tiles = (128, 384, 768, 1024, 1536, 2048, 4096)
    assert [T.check_query_tile(t) for t in tiles] == list(tiles)
    assert [T._split_tile(t) for t in tiles] == [
        (128, 1), (128, 3), (256, 3), (1024, 1), (512, 3), (1024, 2),
        (1024, 4)]
    rp = torch.zeros((8, 4096))
    assert [T._check_pack(rp, t) for t in T.RAY_TILES] == [32, 16, 8, 4]
    assert T._check_pack(torch.zeros((8, 6144)), 384) == 16
    assert [T._pad_rays_soa(torch.zeros((8, 2048)), t)[0].shape[1]
            for t in (256, 384, 768, 1536, 2048)] == [2048, 3072, 3072,
                                                      3072, 2048]
    assert T._pad_rays_soa(torch.zeros((8, 100)), None)[0].shape[1] == 1024
    seg = T._walk_segment(128)  # a 720,896-ray wavefront's K2 launch
    assert T._walk_grid("walk", 704, 100, seg, T._MAX_TILE_BLOCKS) == 50
    assert T._walk_grid("walk", 2816, 100, seg, T._MAX_TILE_BLOCKS) == 50
    assert T._count_key("walk_dma", ray_tile=256) == "walk_dma_rt256"
    assert T._count_key("walk_dma") == "walk_dma"
    for width in (16, 128, 790, 3160):  # [g, width, 4096] per step
        g = T._plain_groups(64, width, 4096)[0][1]
        assert g == 1 or g * width * 4096 <= T._PLAIN_TEMP_ELEMS
    with pytest.raises(ValueError, match="whole tiles of 256"):
        T.tile_extents_plain(torch.zeros((8, 300)), 256)
    with pytest.raises(ValueError, match="whole tiles of 384"):
        T.tile_extents_plain(torch.zeros((8, 1024)), 384)
