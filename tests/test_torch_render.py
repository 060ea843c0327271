"""The port's Whitted frame end to end on the CPU (plain versions of the
kernels), fed the exact uniforms the JAX package draws: the committed
golden image at the JAX package's own bar (atol 2e-5,
tests/test_render.py:70), and JAX's Pallas path (interpret mode, running
K1, K2, K5 and K6) at `test_gi_wq_knob`'s config at atol 1e-5, also with
geometric normals and 3 samples per pixel. Measured max abs difference:
6e-8 on the golden image, the knob config and geometric normals, 1.2e-7
at 3 samples per pixel (no acceptance-boundary flip)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_tpu.accel.packets import build_cluster_accel as jax_build
from raytracing_tpu.config import RenderConfig as JaxConfig
from raytracing_tpu.geometry.scene import build_default_scene as jax_scene
from raytracing_tpu.models.whitted import render as jax_render

from raytracing_tpu_torch import (RenderConfig, SphereLight,
                                  build_cluster_accel)
from raytracing_tpu_torch.geometry.scene import build_default_scene
from raytracing_tpu_torch.models.whitted import render, render_rays

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "teapot32.npy")
SKY = (np.array([0x87, 0xCE, 0xEB]) / 255.0) ** (1 / 2.2)
KNOB = dict(width=16, height=16, samples_per_pixel=1, chunk_size=16 * 16,
            reflect_depth=2, diffuse_depth=2, diffuse_scatter=2,
            gi_cluster_size=128)


def jax_uniforms(seed: int, n_chunks: int):
    """uniforms(i, depth, shape) = exactly what JAX's renderer draws for
    chunk i's diffuse fan: uniform(fold_in(split(key, nc)[i], depth))."""
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


def test_golden_image(scene, accel16):
    """32x32, 1 spp, full depth, CS 16 plus the auto-built CS 128 bounce
    accel, PRNGKey(0)'s uniforms."""
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=1,
                       chunk_size=32 * 32)
    img = render(scene, cfg, accel=accel16,
                 uniforms=jax_uniforms(0, 1)).numpy()
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img[0, 0], SKY, atol=1e-3)
    np.testing.assert_allclose(img, np.load(GOLDEN), atol=2e-5)


@pytest.fixture(scope="module")
def knob_image(scene, accel16):
    return render(scene, RenderConfig(**KNOB), accel=accel16,
                  uniforms=jax_uniforms(5, 1)).numpy()


def test_matches_jax_pallas_render(knob_image):
    js = jax_scene(t=0.0)
    ref = np.asarray(jax_render(js, JaxConfig(backend="pallas", **KNOB),
                                accel=jax_build(js.mesh, cluster_size=16),
                                key=jax.random.PRNGKey(5)))
    assert np.isfinite(knob_image).all()
    np.testing.assert_allclose(knob_image, ref, atol=1e-5)


def test_gi_cap_frac_frame_matches_default_and_jax(scene, accel16,
                                                   knob_image):
    """The two-phase capped bounce queries (`gi_cap_frac=0.1`) give the
    default frame bit for bit, and JAX's Pallas frame with the same cap at
    atol 1e-5."""
    cfg = dict(KNOB, gi_cap_frac=0.1)
    img = render(scene, RenderConfig(**cfg), accel=accel16,
                 uniforms=jax_uniforms(5, 1)).numpy()
    np.testing.assert_array_equal(img, knob_image)
    js = jax_scene(t=0.0)
    ref = np.asarray(jax_render(js, JaxConfig(backend="pallas", **cfg),
                                accel=jax_build(js.mesh, cluster_size=16),
                                key=jax.random.PRNGKey(5)))
    np.testing.assert_allclose(img, ref, atol=1e-5)


@pytest.mark.parametrize("change", [dict(normals="geometric"),
                                    dict(samples_per_pixel=3),
                                    dict(gi_ray_tile=256)],
                         ids=lambda c: next(iter(c)))
def test_matches_jax_pallas_render_other_config(scene, accel16, knob_image,
                                                change):
    """Other configs against JAX's Pallas path with JAX's draws: shading
    normals recomputed from the vertices (the forward the gradient tests
    use) and a sample count that is not a square (a 3 x 1 stratification
    grid; 768 rays, so 3 chunks of JAX's keys), each of which moves the
    image far beyond the tolerance, so a port that ignored it would fail;
    and the bounce levels' culling tile at 256 rays (both sides walk
    their depth-2 queries in tiles of 256; the image is the default's bit
    for bit)."""
    cfg = {**KNOB, **change}
    n_chunks = -(-cfg["width"] * cfg["height"] * cfg["samples_per_pixel"]
                 // cfg["chunk_size"])
    img = render(scene, RenderConfig(**cfg), accel=accel16,
                 uniforms=jax_uniforms(5, n_chunks)).numpy()
    js = jax_scene(t=0.0)
    ref = np.asarray(jax_render(js, JaxConfig(backend="pallas", **cfg),
                                accel=jax_build(js.mesh, cluster_size=16),
                                key=jax.random.PRNGKey(5)))
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img, ref, atol=1e-5)
    if "gi_ray_tile" in change:
        np.testing.assert_array_equal(img, knob_image)
    else:
        assert np.abs(img - knob_image).max() > 0.05


@pytest.mark.parametrize("knob", [
    dict(gi_wq=False),
    dict(bin_reflect_levels=False),
    dict(bin_secondary=False),
    dict(gi_early_exit=False),
    dict(bin_shadow=True),
    dict(gi_cluster_size=0),
], ids=lambda k: next(iter(k)))
def test_performance_knobs_are_exact(scene, accel16, knob_image, knob):
    """Knobs that change only how the walk runs (entry, binning, early
    exit, bounce accel) give a bit-identical image."""
    img = render(scene, RenderConfig(**{**KNOB, **knob}), accel=accel16,
                 uniforms=jax_uniforms(5, 1)).numpy()
    np.testing.assert_array_equal(img, knob_image)


def test_generator_draws_are_seeded(scene, accel16):
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=1,
                       reflect_depth=1, diffuse_depth=2, diffuse_scatter=2)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return render(scene, cfg, accel=accel16, generator=g)

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_odd_frame_size_and_padded_chunks(scene, accel16):
    """A frame that is not whole 16x16 blocks goes through the explicit
    block permutation; chunks that overrun the frame are padded and cut."""
    cfg = RenderConfig(width=20, height=12, samples_per_pixel=2,
                       chunk_size=100, reflect_depth=1, diffuse_depth=0)
    img = render(scene, cfg, accel=accel16)
    assert img.shape == (12, 20, 3) and bool(torch.isfinite(img).all())
    np.testing.assert_allclose(img[0, 0].numpy(), SKY, atol=1e-3)


@pytest.mark.parametrize("change", [
    dict(primary_shared_origin=True),
    dict(gi_cap_frac=0.1),
    dict(lights=True),
], ids=lambda c: next(iter(c)))
def test_unported_paths_raise(scene, accel16, change):
    """Unported options were refused by name. `primary_shared_origin`,
    `lights` and `gi_cap_frac` have since been ported: every case now
    checks that the option is taken (the four rays down +z hit the ground
    far away or the sky: finite)."""
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=1,
                       **{k: v for k, v in change.items() if k != "lights"})
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3)

    def run():
        return render_rays(scene.mesh, accel16, scene.sun, o, d, cfg,
                           lambda depth, shape: torch.rand(shape),
                           lights=light if "lights" in change else None)

    light = SphereLight(torch.tensor([[1.0, 8.0, 7.0]]), torch.tensor([1.5]),
                        torch.tensor([[1.5, 1.5, 1.5]]))
    assert torch.isfinite(run()).all()
