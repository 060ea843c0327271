"""The port's brute-force and cluster backends on the CPU against the JAX
package's (`ops/trace.py`, `accel/packets.py`'s XLA cluster walk) on
seeded numpy rays, and the backend dispatch: tests/test_trace.py:27, 38,
55 and 69 and tests/test_kernels.py:28, 39 and 571 ported, the
brute-force t gradient against `jax.grad`, and 16x16 frames under each
backend against JAX's frames with JAX's draws.

Bars: triangle ids and hit flags equal; t at rtol 1e-6 plus 3.1e-6
absolute where t cancels (XLA on the CPU contracts a*b+c into FMAs, the
port does not: ROADMAP "FMA contraction"); the t gradient at rtol 2e-4
(tests/test_torch_grad.py's bar); frames at atol 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_tpu.accel import packets as JP
from raytracing_tpu.config import RenderConfig as JaxConfig
from raytracing_tpu.geometry.mesh import triangle_soa as jax_soa
from raytracing_tpu.geometry.scene import build_default_scene as jax_scene
from raytracing_tpu.models.whitted import render as jax_render
from raytracing_tpu.ops import trace as JT

from raytracing_tpu_torch import RenderConfig, build_cluster_accel
from raytracing_tpu_torch.accel import packets as TP
from raytracing_tpu_torch.geometry.mesh import triangle_soa
from raytracing_tpu_torch.geometry.scene import (build_default_scene,
                                                 teapot_only_mesh)
from raytracing_tpu_torch.kernels import traverse as K
from raytracing_tpu_torch.models.whitted import render
from raytracing_tpu_torch.ops.intersect import TriangleSoA
from raytracing_tpu_torch.ops.trace import any_hit_brute, nearest_hit_brute
from raytracing_tpu_torch import tracer

torch.set_num_threads(2)
T_RTOL, T_ATOL = 1e-6, 3.1e-6


def _random_rays(rng, n, origin_box=2.0, aim=(1.0, -1.0, 7.5)):
    """tests/test_trace.py's rays: origins on z = 0, aimed around the
    teapots."""
    o = rng.uniform(-origin_box, origin_box, size=(n, 3)).astype(np.float32)
    o[:, 2] = 0.0
    target = np.asarray(aim) + rng.normal(size=(n, 3)).astype(np.float32) * 2
    return o, (target - o).astype(np.float32)


@pytest.fixture(scope="module")
def meshes():
    """The default scene's mesh in both packages (the same arrays)."""
    return jax_scene(t=0.0).mesh, build_default_scene(device="cpu").mesh


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_brute_hits_teapot():
    """tests/test_trace.py:27."""
    mesh = teapot_only_mesh(device="cpu")
    tri = triangle_soa(mesh.verts, mesh.tri_v)
    o = torch.zeros((3, 3))
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0]])
    hit = nearest_hit_brute(tri, o, d)
    assert bool(hit.hit[0])  # straight at the teapot (offset (0, 0, 3))
    assert not bool(hit.hit[1])  # straight up: sky
    assert not bool(hit.hit[2])  # behind
    assert 0.0 < float(hit.t[0]) < 10.0


def test_brute_returns_nearest():
    """tests/test_trace.py:38: two parallel quads, the nearer one wins."""
    tri = TriangleSoA(torch.tensor([[-5.0, -5.0, 2.0], [-5.0, -5.0, 4.0]]),
                      torch.tensor([[10.0, 0.0, 0.0], [10.0, 0.0, 0.0]]),
                      torch.tensor([[0.0, 10.0, 0.0], [0.0, 10.0, 0.0]]))
    hit = nearest_hit_brute(tri, torch.zeros((4, 3)),
                            torch.tensor([[0.0, 0.0, 1.0]] * 4))
    assert (hit.tri.numpy() == 0).all()
    np.testing.assert_allclose(hit.t.numpy(), 2.0, rtol=1e-6)


def test_brute_tie_goes_to_the_lowest_id_across_blocks():
    """The same triangle at ids 3 and 700 (another 512-block): the first
    wins, as in the JAX scan, where a later block is bounded by the best t
    so far (t < t_max) and replaces it only when strictly nearer."""
    rng = np.random.default_rng(0)
    v0 = rng.uniform(-1, 1, size=(800, 3)).astype(np.float32) + [0, 0, 50]
    e = np.zeros((800, 3), np.float32)
    v0[3] = v0[700] = [-5.0, -5.0, 2.0]
    e1, e2 = e.copy(), e.copy()
    e1[[3, 700]] = [10.0, 0.0, 0.0]
    e2[[3, 700]] = [0.0, 10.0, 0.0]
    hit = nearest_hit_brute(TriangleSoA(_t(v0), _t(e1), _t(e2)),
                            torch.zeros((2, 3)),
                            torch.tensor([[0.0, 0.0, 1.0]] * 2))
    assert hit.tri.tolist() == [3, 3]


@pytest.mark.parametrize("cs", [16, 128])
def test_cluster_matches_brute_nearest(meshes, cs):
    """tests/test_trace.py:55 (CS 128), and CS 16 with the ground plane in
    the rest set."""
    _, mesh = meshes
    accel = build_cluster_accel(mesh, cluster_size=cs)
    o, d = map(_t, _random_rays(np.random.default_rng(1234), 512))
    hb = nearest_hit_brute(triangle_soa(mesh.verts, mesh.tri_v), o, d)
    hc = TP.nearest_hit_cluster(mesh, accel, o, d)
    np.testing.assert_array_equal(hb.hit.numpy(), hc.hit.numpy())
    m = hb.hit.numpy()
    assert 100 < m.sum() < 500
    np.testing.assert_allclose(hb.t.numpy()[m], hc.t.numpy()[m], rtol=1e-5)
    np.testing.assert_array_equal(hb.tri.numpy()[m], hc.tri.numpy()[m])


@pytest.mark.parametrize("cs", [16, 128])
def test_cluster_matches_brute_anyhit(meshes, cs):
    """tests/test_trace.py:69, with a scalar and a per-ray t_max."""
    _, mesh = meshes
    accel = build_cluster_accel(mesh, cluster_size=cs)
    o, d = map(_t, _random_rays(np.random.default_rng(1234), 512))
    tri = triangle_soa(mesh.verts, mesh.tri_v)
    tm = _t(np.random.default_rng(5).uniform(0.3, 1.5, 512)
            .astype(np.float32))
    for t_max in (float("inf"), 0.9, tm):
        ab = any_hit_brute(tri, o, d, t_max)
        ac = TP.any_hit_cluster(mesh, accel, o, d, t_max)
        np.testing.assert_array_equal(ab.numpy(), ac.numpy())
        assert 0 < int(ab.sum()) < 512


def _hits_equal(got, want_t, want_tri, want_hit):
    want_t, want_tri, want_hit = map(np.asarray, (want_t, want_tri,
                                                  want_hit))
    np.testing.assert_array_equal(got.hit.numpy(), want_hit)
    m = want_hit
    np.testing.assert_array_equal(got.tri.numpy()[m], want_tri[m])
    np.testing.assert_allclose(got.t.numpy()[m], want_t[m], rtol=T_RTOL,
                               atol=T_ATOL)
    assert np.isinf(got.t.numpy()[~m]).all()


def _bounce_rays(rng, n):
    """Incoherent rays leaving points near the teapots (t cancels where a
    ray leaves a point near a triangle's plane)."""
    o = (np.array([1.0, -1.2, 7.5]) + rng.normal(scale=[2.0, 0.6, 1.5],
                                                size=(n, 3)))
    return o.astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("rays", ["camera", "bounce"])
def test_brute_force_matches_jax(meshes, rays):
    jm, tm = meshes
    rng = np.random.default_rng(7)
    o, d = (_random_rays(rng, 1024) if rays == "camera"
            else _bounce_rays(rng, 1024))
    want = JT.nearest_hit_brute(jax_soa(jm.verts, jm.tri_v),
                                jnp.asarray(o), jnp.asarray(d))
    got = nearest_hit_brute(triangle_soa(tm.verts, tm.tri_v), _t(o), _t(d))
    assert 100 < int(got.hit.sum()) < 1000
    _hits_equal(got, want.t, want.tri, want.hit)
    tmax = rng.uniform(0.2, 4.0, 1024).astype(np.float32)
    for t_max in (float("inf"), tmax):
        a_w = JT.any_hit_brute(jax_soa(jm.verts, jm.tri_v), jnp.asarray(o),
                               jnp.asarray(d), jnp.asarray(t_max))
        a_g = any_hit_brute(triangle_soa(tm.verts, tm.tri_v), _t(o), _t(d),
                            _t(np.asarray(t_max, np.float32))
                            if np.ndim(t_max) else t_max)
        np.testing.assert_array_equal(a_g.numpy(), np.asarray(a_w))


@pytest.mark.parametrize("cs", [16, 128])
def test_cluster_matches_jax(meshes, cs):
    """The cluster walk and its rest-set merge (CS 16 puts the ground
    plane in the rest set) against the JAX package's XLA backend, on the
    same accel tables."""
    jm, tm = meshes
    ja = JP.build_cluster_accel(jm, cluster_size=cs)
    ta = build_cluster_accel(tm, cluster_size=cs)
    np.testing.assert_array_equal(ta.order.numpy(), np.asarray(ja.order))
    rng = np.random.default_rng(11)
    o = np.concatenate([_random_rays(rng, 512)[0], _bounce_rays(rng, 512)[0]])
    d = np.concatenate([_random_rays(rng, 512)[1], _bounce_rays(rng, 512)[1]])
    want = JP.nearest_hit_cluster(jm, ja, jnp.asarray(o), jnp.asarray(d))
    got = TP.nearest_hit_cluster(tm, ta, _t(o), _t(d))
    _hits_equal(got, want.t, want.tri, want.hit)
    a_w = JP.any_hit_cluster(jm, ja, jnp.asarray(o), jnp.asarray(d), 3.0)
    a_g = TP.any_hit_cluster(tm, ta, _t(o), _t(d), 3.0)
    np.testing.assert_array_equal(a_g.numpy(), np.asarray(a_w))
    assert 0 < int(a_g.sum()) < 1024


@pytest.fixture(scope="module")
def teapot_setup():
    """tests/test_kernels.py's setup: the teapot alone, CS 128, 128 rays
    around it from a seed."""
    mesh = teapot_only_mesh(device="cpu")
    accel = build_cluster_accel(mesh, cluster_size=128)
    rng = np.random.default_rng(1234)
    o = rng.uniform(-1, 1, size=(128, 3)).astype(np.float32)
    o[:, 2] = 0.0
    tgt = np.array([0.0, 0.0, 3.0]) + rng.normal(size=(128, 3))
    d = (tgt - o).astype(np.float32)
    return mesh, accel, _t(o), _t(d)


def test_kernel_nearest_matches_oracle(teapot_setup):
    """tests/test_kernels.py:28: the kernel path (plain versions here)
    against the port's brute force."""
    mesh, accel, o, d = teapot_setup
    hb = nearest_hit_brute(triangle_soa(mesh.verts, mesh.tri_v), o, d)
    hk = K.nearest_hit(mesh, accel, o, d)
    m = hb.hit.numpy()
    assert m.sum() > 20
    np.testing.assert_array_equal(m, hk.hit.numpy())
    np.testing.assert_array_equal(hb.tri.numpy()[m], hk.tri.numpy()[m])
    np.testing.assert_allclose(hb.t.numpy()[m], hk.t.detach().numpy()[m],
                               rtol=1e-5)


def test_kernel_anyhit_matches_oracle(teapot_setup):
    """tests/test_kernels.py:39."""
    mesh, accel, o, d = teapot_setup
    ab = any_hit_brute(triangle_soa(mesh.verts, mesh.tri_v), o, d)
    np.testing.assert_array_equal(ab.numpy(), K.any_hit(accel, o, d).numpy())


def test_resolve_backend_auto():
    """tests/test_kernels.py:571, with the port's one difference: "auto"
    is the kernel path on the CPU too (JAX resolves it to "cluster" off
    the TPU, since its Pallas interpret mode is no production path; the
    port's plain versions are)."""
    from raytracing_tpu.tracer import resolve_backend as jax_resolve

    assert jax_resolve("auto") == "cluster"
    assert tracer.resolve_backend("auto") == "cuda"
    for b in ("bruteforce", "cluster", "pallas", "cuda"):
        assert tracer.resolve_backend(b) == b
    with pytest.raises(ValueError, match="unknown backend"):
        RenderConfig(backend="xla")


def test_dispatch_follows_the_backend(meshes, monkeypatch):
    """bruteforce: brute force; cluster: the cluster walk; the kernel
    names: the kernels. A backend that walks an accel and is given none
    raises (the JAX package brute-forces there): no query brute-forces in
    place of a kernel or of the cluster walk."""
    _, mesh = meshes
    accel = build_cluster_accel(mesh, cluster_size=128)
    calls = []
    for mod, name in ((tracer, "nearest_hit_brute"),
                      (tracer, "nearest_hit_cluster")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real, name=name, **k:
                            calls.append(name) or real(*a, **k))
    real_k = K.nearest_hit_shaded
    monkeypatch.setattr(K, "nearest_hit_shaded", lambda *a, **k:
                        calls.append("kernels") or real_k(*a, **k))
    o, d = map(_t, _random_rays(np.random.default_rng(3), 64))
    for backend, acc, want, attrs in (
            ("bruteforce", accel, "nearest_hit_brute", False),
            ("bruteforce", None, "nearest_hit_brute", False),
            ("cluster", accel, "nearest_hit_cluster", False),
            ("auto", accel, "kernels", True),
            ("pallas", accel, "kernels", True)):
        calls.clear()
        h, a = tracer.nearest_hit_shaded(mesh, acc, o, d,
                                         RenderConfig(backend=backend))
        assert calls == [want], backend
        assert (a is not None) == attrs
    calls.clear()
    for backend in ("auto", "cuda", "pallas", "cluster"):
        cfg = RenderConfig(backend=backend)
        with pytest.raises(ValueError, match="given none"):
            tracer.nearest_hit_shaded(mesh, None, o, d, cfg)
        with pytest.raises(ValueError, match="given none"):
            tracer.nearest_hit(mesh, None, o, d, cfg)
        with pytest.raises(ValueError, match="given none"):
            tracer.any_hit(mesh, None, o, d, cfg)
    assert calls == []


def test_brute_force_t_gradient_matches_jax(meshes):
    """d(sum w t)/d verts through the brute force: autograd against
    `jax.grad` of the JAX package's brute force, at rtol 2e-4 of the
    largest entry."""
    jm, tm = meshes
    rng = np.random.default_rng(21)
    o, d = _random_rays(rng, 256)
    w = rng.uniform(0.5, 1.5, 256).astype(np.float32)

    def jax_loss(v):
        h = JT.nearest_hit_brute(jax_soa(v, jm.tri_v), jnp.asarray(o),
                                 jnp.asarray(d))
        return jnp.sum(jnp.where(h.hit, h.t, 0.0) * w)

    want = np.asarray(jax.grad(jax_loss)(jm.verts))
    verts = tm.verts.clone().requires_grad_()
    h = nearest_hit_brute(triangle_soa(verts, tm.tri_v), _t(o), _t(d))
    (torch.where(h.hit, h.t, 0.0) * _t(w)).sum().backward()
    got = verts.grad.numpy()
    assert np.abs(want).max() > 0 and (np.abs(want) > 0).sum() > 100
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())


FRAME = dict(width=16, height=16, samples_per_pixel=1, chunk_size=16 * 16,
             reflect_depth=2, diffuse_depth=2, diffuse_scatter=2)


def _jax_uniforms(seed, n_chunks):
    """What JAX's renderer draws in chunk i for the diffuse fan at depth:
    uniform(fold_in(split(key, nc)[i], depth))."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_chunks)

    def draw(i, depth, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(keys[i], depth), shape, dtype=jnp.float32)))

    return draw


@pytest.mark.parametrize("backend", ["bruteforce", "cluster"])
def test_frame_matches_jax(backend):
    """A 16x16 frame (reflect depth 2, a 2-ray fan) under each plain
    backend against JAX's under the same backend with JAX's draws; the
    cluster backend on CS 16 (the ground in the rest set), brute force
    with no accel. Equal to the port's kernel-path frame too."""
    js = jax_scene(t=0.0)
    ts = build_default_scene(device="cpu")
    jacc = (JP.build_cluster_accel(js.mesh, cluster_size=16)
            if backend == "cluster" else None)
    tacc = (build_cluster_accel(ts.mesh, cluster_size=16)
            if backend == "cluster" else None)
    want = np.asarray(jax_render(js, JaxConfig(backend=backend, **FRAME),
                                 accel=jacc, key=jax.random.PRNGKey(5)))
    got = render(ts, RenderConfig(backend=backend, **FRAME), accel=tacc,
                 uniforms=_jax_uniforms(5, 1)).numpy()
    assert np.isfinite(got).all() and got.std() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-5)
    kern = render(ts, RenderConfig(**FRAME),
                  accel=build_cluster_accel(ts.mesh, cluster_size=16),
                  uniforms=_jax_uniforms(5, 1)).numpy()
    np.testing.assert_allclose(got, kern, atol=1e-5)
