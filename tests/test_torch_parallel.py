"""The port's multi-device layer (`parallel/shard.py`) on 8 virtual CPU
shards: the 6 tests of tests/test_parallel.py ported, the sharded train
step against JAX's unsharded `value_and_grad` + `optax.adam` step on the
whole batch (equal shards make the mean of shard means the batch's mean),
and `render_sharded` against JAX's `render_sharded` over its 8-device
virtual mesh.

Bars: images at atol 1e-5 (tests/test_parallel.py's); the train step's
loss, gradients and parameters at rtol 1e-4 + atol 1e-6, as
tests/test_torch_inverse.py holds one fit step (the renderer's gradients
meet JAX's at rtol 2e-4, and one Adam step of lr 1e-2 moves a parameter by
at most about 1e-2)."""

import dataclasses
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_tpu.config import RenderConfig as JaxConfig
from raytracing_tpu.geometry.mesh import Scene as JaxScene
from raytracing_tpu.geometry.mesh import concat_objects as jax_concat
from raytracing_tpu.models.whitted import render_rays as jax_render_rays
from raytracing_tpu.parallel import shard as JS

from raytracing_tpu_torch import RenderConfig, build_cluster_accel
from raytracing_tpu_torch.geometry.mesh import (Scene, SphereLight,
                                                concat_objects)
from raytracing_tpu_torch.geometry.scene import build_default_scene
from raytracing_tpu_torch.models.whitted import render, render_rays
from raytracing_tpu_torch.parallel.shard import (make_device_mesh,
                                                 make_train_step,
                                                 render_sharded,
                                                 shard_generator,
                                                 shard_layout)

torch.set_num_threads(2)

CFG = dict(width=16, height=16, samples_per_pixel=1, backend="bruteforce",
           chunk_size=32, reflect_depth=2, diffuse_depth=1)


def _objects():
    """tests/test_parallel.py's two triangles."""
    return [{
        "verts": np.array(
            [[-2.0, -2.0, 5.0], [3.0, -2.0, 5.0], [-2.0, 3.0, 5.0],
             [2.5, 2.5, 6.0], [4.0, 2.5, 6.0], [2.5, 4.0, 6.0]],
            dtype=np.float32),
        "tri_v": np.array([[0, 2, 1], [3, 5, 4]], dtype=np.int32),
        "colors": np.array([0.8, 0.6, 0.4], dtype=np.float32),
        "material": (1.0, 0.2, 0.5),
    }]


SUN = [200.0, 300.0, -1000.0]


def _small_scene():
    return Scene(mesh=concat_objects(_objects()), sun=torch.tensor(SUN))


def _mesh8():
    return make_device_mesh(8, devices=["cpu"] * 8)


def _batch(n=64):
    """tests/test_parallel.py:76's rays."""
    xs = np.linspace(-0.15, 0.15, n).astype(np.float32)
    o = np.zeros((n, 3), np.float32)
    d = np.stack([xs, xs * 0.3 + 0.02, np.ones(n, np.float32)], axis=-1)
    return o, d.astype(np.float32)


def test_mesh_has_8_devices():
    """tests/test_parallel.py:37: the virtual mesh has 8 shards (of one
    device); more than there are, or a card where there is none, raises."""
    m = _mesh8()
    assert m.size == m.n_shards == 8 and m.first_shard == 0
    assert m.devices == (torch.device("cpu"),) * 8
    assert make_device_mesh(3, devices=["cpu"] * 8).size == 3
    with pytest.raises(ValueError, match="9 devices"):
        make_device_mesh(9, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make_device_mesh()
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make_device_mesh(devices=["cuda:0"])


def test_shard_layout():
    """Whole chunks per shard, at most the shard's share, covering the
    frame; the seeds depend on (seed, shard) alone."""
    for r, n, c in ((256, 8, 32), (256, 8, 65536), (1000, 3, 64),
                    (7, 4, 16)):
        per, chunk = shard_layout(r, n, c)
        assert per % chunk == 0 and chunk <= c and per * n >= r
        assert per - chunk < -(-r // n)
    a = torch.rand(4, generator=shard_generator(3, 1, "cpu"))
    b = torch.rand(4, generator=shard_generator(3, 1, "cpu"))
    c = torch.rand(4, generator=shard_generator(3, 2, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_sharded_render_matches_single_device():
    """tests/test_parallel.py:45: no draws at diffuse depth 1."""
    scene = _small_scene()
    cfg = RenderConfig(**CFG)
    img_s = render_sharded(scene, cfg, _mesh8(), seed=5).numpy()
    img_1 = render(scene, cfg).numpy()
    assert img_s.shape == (16, 16, 3) and img_s.std() > 0.05
    np.testing.assert_allclose(img_s, img_1, atol=1e-5)


def test_train_step_runs_and_reduces_loss():
    """tests/test_parallel.py:58: 6 Adam steps from vertices moved by
    0.05 cut the loss by 30%."""
    scene = _small_scene()
    cfg = RenderConfig(**{**CFG, "normals": "geometric",
                          "reflect_depth": 1})
    step = make_train_step(cfg, functools.partial(torch.optim.Adam, lr=1e-2),
                           _mesh8())
    o, d = map(torch.from_numpy, _batch())
    with torch.no_grad():
        target = render_rays(scene.mesh, None, scene.sun, o, d, cfg,
                             lambda tag, shape: torch.rand(shape))
    params = {"verts": scene.mesh.verts + 0.05}
    opt_state, losses = None, []
    for _ in range(6):
        params, opt_state, loss = step(params, opt_state, scene.mesh, None,
                                       scene.sun, o, d, target)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, losses


def test_gradients_replicated_across_devices():
    """tests/test_parallel.py:94: with SGD at lr 0 the params come back
    unchanged, and the gradient every shard is stepped with is the mean of
    the shards' own gradients, each shard rendered alone."""
    scene = _small_scene()
    cfg = RenderConfig(**CFG)
    step = make_train_step(cfg, functools.partial(torch.optim.SGD, lr=0.0),
                           _mesh8())
    n = 64
    o = torch.zeros((n, 3))
    d = torch.stack([torch.linspace(-0.1, 0.1, n), torch.zeros(n) + 0.02,
                     torch.ones(n)], dim=-1)
    target = torch.zeros((n, 3))
    params = {"colors": scene.mesh.colors}
    grads = {}
    new, _, loss = step(params, None, scene.mesh, None, scene.sun, o, d,
                        target, grads_out=grads)
    assert np.isfinite(float(loss))
    assert torch.equal(new["colors"], params["colors"])
    want = torch.zeros_like(params["colors"])
    want_loss = 0.0
    for s in range(8):
        c = params["colors"].clone().requires_grad_()
        rgb = render_rays(scene.mesh._replace(colors=c), None, scene.sun,
                          o[s * 8:(s + 1) * 8], d[s * 8:(s + 1) * 8], cfg,
                          lambda tag, shape: torch.rand(shape))
        sl = ((rgb - target[s * 8:(s + 1) * 8]) ** 2).mean()
        sl.backward()
        want += c.grad
        want_loss += float(sl.detach())
    assert float(grads["colors"].abs().max()) > 0
    torch.testing.assert_close(grads["colors"], want / 8, rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(float(loss), want_loss / 8, rtol=1e-6)


def test_sharded_render_kernel_path():
    """tests/test_parallel.py:115: the kernel path (plain versions here:
    visit lists, the walk and the rest merge per shard) against the
    brute force, both sharded, on the default scene."""
    scene = build_default_scene(t=0.0, device="cpu")
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    cfg = RenderConfig(**{**CFG, "backend": "cuda", "chunk_size": 64,
                          "diffuse_depth": 0, "reflect_depth": 1})
    img_k = render_sharded(scene, cfg, _mesh8(), accel=accel,
                           seed=5).numpy()
    img_b = render_sharded(scene, cfg.replace(backend="bruteforce"),
                           _mesh8(), seed=5).numpy()
    assert img_k.std() > 0.05
    np.testing.assert_allclose(img_k, img_b, atol=1e-5)


def test_sharded_render_carries_area_lights():
    """tests/test_parallel.py:138: the sharded frame carries the scene's
    area lights; the light's added radiance matches the one-device
    render's in aggregate (the shards draw other uniforms)."""
    base = _small_scene()
    lights = SphereLight(center=torch.tensor([[0.0, 2.0, 4.0]]),
                         radius=torch.tensor([0.5]),
                         emission=torch.tensor([[5.0, 4.0, 3.0]]))
    lit = Scene(mesh=base.mesh, sun=base.sun, lights=lights)
    cfg = RenderConfig(**CFG)
    img_dark = render_sharded(base, cfg, _mesh8(), seed=5).numpy()
    img_lit_s = render_sharded(lit, cfg, _mesh8(), seed=5).numpy()
    assert np.abs(img_lit_s - img_dark).max() > 1e-3
    img_lit_1 = render(lit, cfg).numpy()
    add_s = (img_lit_s - img_dark).mean()
    add_1 = (img_lit_1 - render(base, cfg).numpy()).mean()
    assert add_1 > 1e-4
    np.testing.assert_allclose(add_s, add_1, rtol=0.15)


def test_train_step_matches_jax_unsharded():
    """One sharded step (8 shards of 8 rays) against JAX's whole-batch
    step: `value_and_grad` of mean((render_rays - target)^2) under the
    brute force and one optax.adam(1e-2) update. Vertices, colors and
    materials are fitted; geometric normals, so the vertex gradient has
    its normal and t terms."""
    cfg = {**CFG, "normals": "geometric", "reflect_depth": 2}
    jm = jax_concat(_objects())
    sun = jnp.asarray(SUN)
    o, d = _batch()
    rng = np.random.default_rng(8)
    target = rng.uniform(size=(64, 3)).astype(np.float32)
    p0 = {"verts": np.asarray(jm.verts) + 0.05,
          "colors": np.asarray(jm.colors) * 0.7,
          "materials": np.asarray(jm.materials)}

    def loss_fn(p):
        rgb = jax_render_rays(jm._replace(**p), None, sun, jnp.asarray(o),
                              jnp.asarray(d), jax.random.PRNGKey(0),
                              JaxConfig(**cfg))
        return jnp.mean((rgb - jnp.asarray(target)) ** 2)

    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    loss, grads = jax.value_and_grad(loss_fn)(jp)
    jopt = optax.adam(1e-2)
    updates, _ = jopt.update(grads, jopt.init(jp), jp)
    want = optax.apply_updates(jp, updates)

    scene = _small_scene()
    step = make_train_step(RenderConfig(**cfg),
                           functools.partial(torch.optim.Adam, lr=1e-2),
                           _mesh8())
    got_grads = {}
    params, opt_state, got_loss = step(
        {k: torch.from_numpy(v.copy()) for k, v in p0.items()}, None,
        scene.mesh, None, scene.sun, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(target), grads_out=got_grads)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-4,
                               atol=1e-6)
    moved = 0
    for k in p0:
        g = np.asarray(grads[k])
        assert np.abs(g).max() > 0, k
        np.testing.assert_allclose(got_grads[k].numpy(), g, rtol=1e-4,
                                   atol=1e-6 * np.abs(g).max(), err_msg=k)
        w = np.asarray(want[k])
        np.testing.assert_allclose(params[k].numpy(), w, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        moved += int((w != p0[k]).sum())
    assert moved > 10
    assert float(opt_state["state"][0]["step"]) == 1


def test_render_sharded_matches_jax_render_sharded():
    """The port's sharded frame against JAX's `render_sharded` over its 8
    virtual devices, brute force, no draws."""
    scene = _small_scene()
    jscene = JaxScene(mesh=jax_concat(_objects()), sun=jnp.asarray(SUN))
    want = np.asarray(JS.render_sharded(
        jscene, JaxConfig(**CFG), JS.make_device_mesh(8),
        key=jax.random.PRNGKey(5)))
    got = render_sharded(scene, RenderConfig(**CFG), _mesh8(),
                         seed=5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # The same frame over 3 shards (another split, padding included).
    three = render_sharded(scene, RenderConfig(**CFG),
                           make_device_mesh(3, devices=["cpu"] * 3)).numpy()
    np.testing.assert_array_equal(three, got)


def test_config_dict_builds_both():
    """A JAX config dict of any backend builds a port config."""
    for backend in ("pallas", "bruteforce", "cluster", "auto"):
        kw = dataclasses.asdict(JaxConfig(backend=backend, width=8))
        assert RenderConfig(**kw).backend == backend
