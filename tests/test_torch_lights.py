"""The port's area lights against the JAX package's, on the CPU (plain
versions of the kernels; JAX's Pallas kernels in interpret mode), with the
same numpy-seeded inputs and the very uniforms JAX draws.

Bars: `slab_test` flags equal and `ray_sphere`, `sample_cone` at rtol 1e-6
(+ atol 1e-6: XLA contracts a*b+c, the port does not); per-ray t_max
any-hit flags equal; `area_light_term` and an area-light frame at atol 1e-5
(the bar of tests/test_torch_render.py). The port's binned levels hand each
ray its light draw by the ray's row (`models/whitted.py`, "Random
numbers"), where the JAX package's binned levels take their draws in
sorted order: the port's frame is held to JAX's frame with
`bin_secondary=False`, in which every ray has its row's draw on both
sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raytracing_tpu.kernels.traverse as JT
from raytracing_tpu.accel.packets import build_cluster_accel as jax_build
from raytracing_tpu.config import RenderConfig as JaxConfig
from raytracing_tpu.geometry.mesh import Scene as JaxScene
from raytracing_tpu.geometry.mesh import SphereLight as JaxSphereLight
from raytracing_tpu.geometry.scene import build_default_scene as jax_scene
from raytracing_tpu.models import whitted as JW
from raytracing_tpu.ops import intersect as JI
from raytracing_tpu.ops import sampling as JS

import raytracing_tpu_torch.kernels.traverse as T
from raytracing_tpu_torch import RenderConfig, SphereLight
from raytracing_tpu_torch.accel.packets import accel_from_numpy
from raytracing_tpu_torch.geometry.mesh import Scene, scene_from_numpy
from raytracing_tpu_torch.models import whitted as TW
from raytracing_tpu_torch.ops import intersect as TI
from raytracing_tpu_torch.ops import sampling as TS

torch.set_num_threads(2)

LIGHT = dict(center=np.array([[1.0, 8.0, 7.0]], np.float32),
             radius=np.array([1.5], np.float32),
             emission=np.array([[1.5, 1.5, 1.5]], np.float32))
FRAME = dict(width=32, height=32, samples_per_pixel=1, chunk_size=32 * 32,
             reflect_depth=2, diffuse_depth=2, diffuse_scatter=2,
             light_samples=2, gi_cluster_size=128)


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def scenes():
    """The default scene with one spherical light, in both packages, from
    one set of numpy arrays."""
    js = jax_scene(t=0.0)
    jl = JaxSphereLight(**{k: jnp.asarray(v) for k, v in LIGHT.items()})
    arrays = {k: _np(v) for k, v in js.mesh._asdict().items()}
    arrays["sun"] = _np(js.sun)
    arrays["lights"] = LIGHT
    return (JaxScene(mesh=js.mesh, sun=js.sun, lights=jl),
            scene_from_numpy(arrays, device="cpu"))


@pytest.fixture(scope="module")
def accels(scenes):
    out = {}
    for cs in (16, 128):
        j = jax_build(scenes[0].mesh, cluster_size=cs)
        out[cs] = (j, accel_from_numpy(
            {k: (None if v is None else _np(v))
             for k, v in j._asdict().items()}, device="cpu"))
    return out


def test_scene_from_numpy_carries_lights(scenes):
    _, ts = scenes
    assert isinstance(ts.lights, SphereLight)
    for name, want in LIGHT.items():
        got = getattr(ts.lights, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    moved = ts.to("cpu")
    assert isinstance(moved, Scene) and moved.lights is not None


def test_slab_test_matches_jax():
    rng = np.random.default_rng(3)
    o = rng.normal(size=(500, 1, 3)).astype(np.float32)
    d = rng.normal(size=(500, 1, 3)).astype(np.float32)
    inv = (1.0 / d).astype(np.float32)
    lo = rng.uniform(-2, 0, size=(20, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 2, size=(20, 3)).astype(np.float32)
    for t_max in (np.inf, 1.5):
        want = _np(JI.slab_test(jnp.asarray(o), jnp.asarray(inv),
                                jnp.asarray(lo), jnp.asarray(hi), t_max))
        got = TI.slab_test(*map(torch.from_numpy, (o, inv, lo, hi)), t_max)
        assert want.any() and not want.all()
        # Flags: a slab bound within an ulp of the other could flip one;
        # none does on these inputs.
        np.testing.assert_array_equal(got.numpy(), want)


def test_ray_sphere_matches_jax():
    rng = np.random.default_rng(4)
    o = rng.normal(scale=3.0, size=(2000, 3)).astype(np.float32)
    d = rng.normal(size=(2000, 3)).astype(np.float32)
    c = np.array([0.5, -0.25, 1.0], np.float32)
    jt, jv = JI.ray_sphere(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c),
                           jnp.float32(2.0), jnp.inf)
    tt, tv = TI.ray_sphere(torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(c), torch.tensor(2.0),
                           float("inf"))
    jv = _np(jv)
    assert jv.sum() > 100 and (~jv).sum() > 100
    # A discriminant within rounding of 0 could flip `valid`; none does.
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_allclose(tt.numpy()[jv], _np(jt)[jv], rtol=1e-6,
                               atol=1e-6)
    assert np.isinf(tt.numpy()[~jv]).all()


def test_sample_cone_matches_jax():
    rng = np.random.default_rng(5)
    axis = rng.normal(size=(1000, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    axis[:10] = [0.0, 1.0, 0.0]  # |z| < eps: the other tangent frame
    cos_max = rng.uniform(0.2, 1.0, size=1000).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = _np(JS.sample_cone(key, jnp.asarray(axis), jnp.asarray(cos_max)))
    u = np.array(jax.random.uniform(key, (1000, 2), dtype=jnp.float32))
    got = TS.sample_cone(torch.from_numpy(u), torch.from_numpy(axis),
                         torch.from_numpy(cos_max)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # Inside the cone, and unit length.
    assert ((got * axis).sum(axis=1) >= cos_max - 1e-5).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    # Extra leading sample dimensions broadcast.
    u3 = torch.rand((3, 1000, 2), generator=torch.Generator().manual_seed(0))
    assert TS.sample_cone(u3, torch.from_numpy(axis),
                          torch.from_numpy(cos_max)).shape == (3, 1000, 3)


def _bounce_pack(seed, n=2048):
    rng = np.random.default_rng(seed)
    o = np.array([1.0, -1.2, 7.5]) + rng.normal(scale=[2.0, 0.6, 1.5],
                                                size=(n, 3))
    d = rng.normal(size=(n, 3))
    alive = (rng.uniform(size=n) > 0.1).astype(np.float32)
    p = np.concatenate([o.T, np.ones((1, n)), d.T, alive[None]])
    return np.ascontiguousarray(p, dtype=np.float32)


@pytest.mark.parametrize("cs,wq", [(16, False), (128, True)],
                         ids=["cs16-K1", "cs128-wq-K2"])
def test_per_ray_tmax_any_hit_matches_jax(accels, cs, wq):
    """Flags equal JAX's `any_hit_soa(t_max=array, interpret=True)`; +inf
    entries are no limit, and the ray count is no multiple of 1024, so the
    padded lanes get their zero limit."""
    j_acc, t_acc = accels[cs]
    p = _bounce_pack(21)[:, :1500]
    tm = np.linspace(0.5, 30.0, p.shape[1]).astype(np.float32)
    tm[::9] = np.inf
    want = _np(JT.any_hit_soa(j_acc, jnp.asarray(p), t_max=jnp.asarray(tm),
                              interpret=True, wq=wq))
    got = T.any_hit_soa(t_acc, torch.from_numpy(p.copy()),
                        t_max=torch.from_numpy(tm), wq=wq).numpy()
    m = p[7] != 0
    assert want[m].any() and not want[m].all()
    np.testing.assert_array_equal(got[m], want[m])
    # The limit matters: an unlimited query hides more.
    free = T.any_hit_soa(t_acc, torch.from_numpy(p.copy()), wq=wq).numpy()
    assert free[m].sum() > got[m].sum()
    # A 0-dim tensor is a scalar bound.
    sc = T.any_hit_soa(t_acc, torch.from_numpy(p.copy()),
                       t_max=torch.tensor(3.0), wq=wq).numpy()
    np.testing.assert_array_equal(
        sc, T.any_hit_soa(t_acc, torch.from_numpy(p.copy()), t_max=3.0,
                          wq=wq).numpy())


def _shaded(seed, n=1024):
    """Shading state at points just above the ground and around the
    teapots, normals mostly up; one lane in eight is no hit."""
    rng = np.random.default_rng(seed)
    pos = np.array([1.0, -2.9, 7.5]) + rng.normal(scale=[3.0, 0.05, 2.0],
                                                  size=(n, 3))
    nrm = np.array([0.0, 1.0, 0.0]) + rng.normal(scale=0.3, size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    f = dict(direct=np.zeros((n, 3)), n=nrm, pos=pos,
             color=rng.uniform(0.2, 1.0, size=(n, 3)),
             refl=np.zeros(n), rough=np.ones(n),
             albedo_pi=np.full(n, 1.0 / np.pi))
    f = {k: v.astype(np.float32) for k, v in f.items()}
    return f, rng.uniform(size=n) > 0.125


def test_area_light_term_matches_jax(scenes, accels):
    js, ts = scenes
    j_acc, t_acc = accels[16]
    f, hit = _shaded(31)
    key = jax.random.PRNGKey(77)
    jcfg = JaxConfig(backend="pallas", light_samples=3)
    want = _np(JW.area_light_term(
        js.mesh, j_acc, js.lights,
        JW.Shaded(**{k: jnp.asarray(v) for k, v in f.items()}),
        jnp.asarray(hit), key, jcfg))

    def uniforms(ls, shape):
        li, s = ls
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, li * 131 + s), shape,
            dtype=jnp.float32)))

    got = TW.area_light_term(
        t_acc, ts.lights,
        TW.Shaded(**{k: torch.from_numpy(v) for k, v in f.items()}),
        torch.from_numpy(hit), uniforms,
        RenderConfig(light_samples=3)).numpy()
    assert (want[hit].sum(axis=1) > 0).sum() > 100  # lit points
    assert (want[hit].sum(axis=1) == 0).sum() > 10   # shadowed ones
    np.testing.assert_allclose(got, want, atol=1e-5)


def jax_frame_uniforms(seed, n_chunks):
    """uniforms(i, tag, shape) = what JAX's `render` draws in chunk i: the
    fan at `depth` from fold_in(key_i, depth), a light's shadow sample from
    fold_in(fold_in(key_i, 7777 + depth), light * 131 + sample)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_chunks)

    def draw(i, tag, shape):
        if isinstance(tag, tuple):
            _, depth, li, s = tag
            k = jax.random.fold_in(jax.random.fold_in(keys[i], 7777 + depth),
                                   li * 131 + s)
        else:
            k = jax.random.fold_in(keys[i], tag)
        return torch.from_numpy(np.array(
            jax.random.uniform(k, shape, dtype=jnp.float32)))

    return draw


@pytest.fixture(scope="module")
def light_frame(scenes, accels):
    return TW.render(scenes[1], RenderConfig(**FRAME), accel=accels[16][1],
                     uniforms=jax_frame_uniforms(3, 1)).numpy()


def test_area_light_frame_matches_jax(scenes, accels, light_frame):
    """32x32, reflect and diffuse depth 2, 2 light samples, CS 16 plus the
    auto-built CS 128 bounce accel (so bounce-level light queries run the
    `_walk_dma` entry with a per-ray t_max on both sides). JAX's frame
    unbinned: there every ray takes its row's light draw, as every ray of
    the port's frame does (module docstring)."""
    ref = _np(JW.render(scenes[0], JaxConfig(backend="pallas",
                                             bin_secondary=False, **FRAME),
                        accel=accels[16][0], key=jax.random.PRNGKey(3)))
    assert np.isfinite(light_frame).all()
    np.testing.assert_allclose(light_frame, ref, atol=1e-5)


def test_light_adds_radiance(scenes, accels, light_frame):
    _, ts = scenes
    dark = TW.render(Scene(ts.mesh, ts.sun), RenderConfig(**FRAME),
                     accel=accels[16][1],
                     uniforms=jax_frame_uniforms(3, 1)).numpy()
    assert (light_frame >= dark - 1e-6).all()
    assert (light_frame > dark + 1e-3).sum() > 100


@pytest.mark.parametrize("knob", [dict(gi_wq=False), dict(wq_impl="grid"),
                                  dict(gi_early_exit=False),
                                  dict(gi_cluster_size=0),
                                  dict(bin_secondary=False)],
                         ids=lambda k: next(iter(k)))
def test_light_frame_knobs_are_exact(scenes, accels, light_frame,
                                     monkeypatch, knob):
    """How the bounce queries are walked (K1, K2 or the work-queue walk
    K4; early exit; which accel; whether a level is binned) does not
    change a bit of the area-light frame: a binned level hands each ray
    the light draw of its row."""
    knob = dict(knob)
    if knob.pop("wq_impl", None):
        monkeypatch.setattr(T, "_WQ_IMPL", "grid")
    img = TW.render(scenes[1], RenderConfig(**{**FRAME, **knob}),
                    accel=accels[16][1],
                    uniforms=jax_frame_uniforms(3, 1)).numpy()
    np.testing.assert_array_equal(img, light_frame)


def test_generator_frame_with_lights_is_seeded(scenes, accels):
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=1,
                       reflect_depth=1, diffuse_depth=0, light_samples=2)

    def run(seed):
        return TW.render(scenes[1], cfg, accel=accels[16][1],
                         generator=torch.Generator().manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
