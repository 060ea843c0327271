"""The port's path tracer on the CPU (plain versions of the kernels)
against its own Whitted integrator and against the JAX package's path
tracer (Pallas kernels in interpret mode) fed through `uniforms=` the very
arrays JAX draws.

Bars: a pure-mirror scene has no stochastic branch, so `trace_paths`
equals `render_rays` at atol 1e-5 (tests/test_models.py:51); on a diffuse
floor the mean of 512 paths agrees with the 512-ray fan at rtol 0.06 /
atol 0.02 (Monte-Carlo noise, tests/test_models.py:68); a 16x16, 2-spp,
2-bounce frame equals JAX's at atol 1e-5 (the bar of
tests/test_torch_render.py), with the per-bounce re-binning on both sides
or off both sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_tpu.accel.packets import build_cluster_accel as jax_build
from raytracing_tpu.config import RenderConfig as JaxConfig
from raytracing_tpu.geometry.scene import build_default_scene as jax_scene
from raytracing_tpu.models import path_tracer as JP

from raytracing_tpu_torch import (PathTracerConfig, RenderConfig,
                                  build_cluster_accel, render_path_traced)
from raytracing_tpu_torch.geometry.mesh import Scene, concat_objects
from raytracing_tpu_torch.geometry.scene import build_default_scene
from raytracing_tpu_torch.models import path_tracer as TP
from raytracing_tpu_torch.models.whitted import render_rays
from raytracing_tpu_torch.ops.color import gamma_correct

torch.set_num_threads(2)

CFG = RenderConfig(width=8, height=8, samples_per_pixel=1, chunk_size=64)
FRAME = dict(width=16, height=16, samples_per_pixel=1, chunk_size=100,
             gi_cluster_size=128)
PT = dict(max_bounces=2, samples_per_pixel=2)


def _floor_scene(half, colors, material, sun_y):
    floor = {
        "verts": np.array([[-half, 0, -half], [-half, 0, half],
                           [half, 0, half], [half, 0, -half]], np.float32),
        "tri_v": np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        "normals": np.array([[0, 1, 0], [0, 1, 0]], np.float32),
        "colors": np.array(colors, np.float32),
        "material": material,
    }
    scene = Scene(mesh=concat_objects([floor]),
                  sun=torch.tensor([0.0, sun_y, 0.0]))
    # The floor's two triangles as one cluster of two.
    return scene, build_cluster_accel(scene.mesh, cluster_size=2)


def _rand(seed):
    g = torch.Generator().manual_seed(seed)
    return lambda tag, shape: torch.rand(shape, generator=g)


def test_path_tracer_matches_whitted_on_deterministic_paths():
    """Pure-mirror floor: both integrators follow the same reflection
    chain, so the radiance is the same."""
    scene, accel = _floor_scene(10, [0.0, 0.0, 0.0], (0.0, 0.8, 0.0),
                                -1000.0)
    o = torch.tensor([[0.0, 1.0, 0.0], [0.5, 2.0, 0.0]])
    d = torch.tensor([[0.1, -1.0, 0.0], [-0.2, -1.0, 0.3]])
    cfg = CFG.replace(diffuse_depth=1, reflect_depth=4)
    whitted = render_rays(scene.mesh, accel, scene.sun, o, d, cfg, _rand(1))
    pt = TP.trace_paths(scene.mesh, accel, scene.sun, o, d, _rand(1), cfg,
                        PathTracerConfig(max_bounces=4))
    np.testing.assert_allclose(gamma_correct(pt, cfg.gamma).numpy(),
                               whitted.numpy(), atol=1e-5)


def test_path_tracer_expectation_matches_whitted_diffuse():
    """Diffuse floor: the mean of 512 one-ray paths agrees with the
    Whitted 512-ray fan (the same BRDF convention) within Monte-Carlo
    noise."""
    scene, accel = _floor_scene(50, [0.6, 0.7, 0.8], (1.0, 0.0, 0.9), 1000.0)
    o = torch.tensor([[0.0, 1.0, 0.0]])
    d = torch.tensor([[0.05, -1.0, 0.02]])
    cfg = CFG.replace(diffuse_scatter=512, reflect_depth=2, diffuse_depth=2)
    whitted = render_rays(scene.mesh, accel, scene.sun, o, d, cfg,
                          _rand(0)).numpy()[0]
    samples = TP.trace_paths(scene.mesh, accel, scene.sun, o.expand(512, 3),
                             d.expand(512, 3), _rand(7), cfg,
                             PathTracerConfig(max_bounces=2))
    pt_mean = gamma_correct(samples.mean(dim=0), cfg.gamma).numpy()
    np.testing.assert_allclose(pt_mean, whitted, rtol=0.06, atol=0.02)


def jax_path_uniforms(seed, n_chunks, spp):
    """uniforms(i, s, tag, shape) = what JAX's path tracer draws for sample
    s of chunk i: key_s = split(split(key, nc)[i], spp)[s]; the branch
    choice of bounce b from fold_in(key_s, 2b), its hemisphere sample from
    fold_in(key_s, 2b + 1)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_chunks)

    def draw(i, s, tag, shape):
        kind, b = tag
        key_s = jax.random.split(keys[i], spp)[s]
        k = jax.random.fold_in(key_s, 2 * b + (kind == "scatter"))
        return torch.from_numpy(np.array(
            jax.random.uniform(k, shape, dtype=jnp.float32)))

    return draw


@pytest.fixture(scope="module")
def scene():
    return build_default_scene(t=0.0, device="cpu")


@pytest.fixture(scope="module")
def accel16(scene):
    return build_cluster_accel(scene.mesh, cluster_size=16)


@pytest.mark.parametrize("binned", [True, False], ids=["binned", "unbinned"])
def test_frame_matches_jax(scene, accel16, binned):
    """16x16, 2 spp, 2 bounces, three chunks of 100 pixels (the last one
    padded), CS 16 plus the auto-built CS 128 bounce accel. A re-binned
    bounce hands each path the draw of its sorted position, so the image
    depends on `bin_secondary`; with the same setting on both sides the
    two packages agree."""
    js = jax_scene(t=0.0)
    kw = dict(FRAME, bin_secondary=binned)
    ref = np.asarray(JP.render(
        js, JaxConfig(backend="pallas", **kw), JP.PathTracerConfig(**PT),
        accel=jax_build(js.mesh, cluster_size=16),
        key=jax.random.PRNGKey(11)))
    img = render_path_traced(
        scene, RenderConfig(**kw), PathTracerConfig(**PT), accel=accel16,
        uniforms=jax_path_uniforms(11, 3, PT["samples_per_pixel"])).numpy()
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img, ref, atol=1e-5)


@pytest.fixture(scope="module")
def frame(scene, accel16):
    return render_path_traced(
        scene, RenderConfig(**FRAME), PathTracerConfig(**PT), accel=accel16,
        uniforms=jax_path_uniforms(5, 3, PT["samples_per_pixel"])).numpy()


@pytest.mark.parametrize("knob", [dict(gi_wq=False), dict(wq_impl="grid"),
                                  dict(gi_early_exit=False),
                                  dict(gi_cluster_size=0),
                                  dict(bin_shadow=False)],
                         ids=lambda k: next(iter(k)))
def test_walk_knobs_are_exact(scene, accel16, frame, monkeypatch, knob):
    """Knobs that change only how a query is walked (entry, early exit,
    bounce accel, shadow binning) give a bit-identical frame."""
    import raytracing_tpu_torch.kernels.traverse as T

    knob = dict(knob)
    if knob.pop("wq_impl", None):
        monkeypatch.setattr(T, "_WQ_IMPL", "grid")
    img = render_path_traced(
        scene, RenderConfig(**{**FRAME, **knob}), PathTracerConfig(**PT),
        accel=accel16,
        uniforms=jax_path_uniforms(5, 3, PT["samples_per_pixel"])).numpy()
    np.testing.assert_array_equal(img, frame)


def test_generator_frame_is_seeded_and_bin_every_runs(scene, accel16):
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=1)

    def run(seed, **pt):
        return render_path_traced(
            scene, cfg, PathTracerConfig(max_bounces=4, samples_per_pixel=2,
                                         **pt), accel=accel16,
            generator=torch.Generator().manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    assert a.shape == (16, 16, 3) and bool(torch.isfinite(a).all())
    assert torch.equal(a, b) and not torch.equal(a, c)
    sky = (np.array([0x87, 0xCE, 0xEB]) / 255.0) ** (1 / 2.2)
    np.testing.assert_allclose(a[0, 0].numpy(), sky, atol=1e-3)
    # bin_every=2 leaves bounce 2 in bounce 1's order, so its draws reach
    # other paths: another image of the same estimator.
    e = run(1, bin_every=2)
    assert bool(torch.isfinite(e).all()) and not torch.equal(e, a)
    assert abs(float(e.mean()) - float(a.mean())) < 0.05


def test_shared_origin_primaries(scene, accel16):
    """`primary_shared_origin` sends bounce 0 through the origin-folded
    intersector: the same frame up to hits on an acceptance boundary
    (within one rounding), none of which shows at 16x16."""
    cfg = RenderConfig(**FRAME)
    pt = PathTracerConfig(**PT)
    u = jax_path_uniforms(5, 3, PT["samples_per_pixel"])
    a = render_path_traced(scene, cfg, pt, accel=accel16, uniforms=u)
    b = render_path_traced(scene, cfg.replace(primary_shared_origin=True),
                           pt, accel=accel16, uniforms=u)
    assert float((a - b).abs().max()) < 1e-4
