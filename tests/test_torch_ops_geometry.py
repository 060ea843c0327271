"""The port's ops, scene and accel build against the JAX package on the
same inputs. Ops agree to rtol 1e-6 (XLA on the CPU fuses a*b+c into one
FMA and its sin/cos differ by an ulp, so bit-equality is not the bar;
atol 1e-6 covers results that cancel to near 0). Scene arrays and accel
tables are bit-equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raytracing_tpu.accel.packets as JP
import raytracing_tpu.geometry.native as JN
from raytracing_tpu.geometry.scene import build_default_scene as jax_scene
from raytracing_tpu.geometry.scene import sun_position as jax_sun
from raytracing_tpu.ops import color as jcolor
from raytracing_tpu.ops import intersect as jisect
from raytracing_tpu.ops import linalg as jlin
from raytracing_tpu.ops import sampling as jsamp

import raytracing_tpu_torch.accel.packets as TP
import raytracing_tpu_torch.geometry.native as TN
from raytracing_tpu_torch.geometry.mesh import Mesh, scene_from_numpy
from raytracing_tpu_torch.geometry.scene import build_default_scene
from raytracing_tpu_torch.geometry.scene import sun_position
from raytracing_tpu_torch.ops import color as tcolor
from raytracing_tpu_torch.ops import intersect as tisect
from raytracing_tpu_torch.ops import linalg as tlin
from raytracing_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)


def _vecs(rng, *shape):
    return rng.standard_normal(shape + (3,)).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("op", ["dot", "cross", "normalize", "reflect",
                                "triangle_normal", "gamma"])
def test_small_ops_match_jax(op, rng):
    a, b, c = _vecs(rng, 512), _vecs(rng, 512), _vecs(rng, 512)
    ta, tb, tc = map(torch.from_numpy, (a, b, c))
    if op == "dot":
        _close(tlin.dot(ta, tb), jlin.dot(a, b))
    elif op == "cross":
        _close(tlin.cross(ta, tb), jlin.cross(a, b))
    elif op == "normalize":
        _close(tlin.normalize(ta, eps=1e-20), jlin.normalize(a, eps=1e-20))
    elif op == "reflect":
        n = a / np.linalg.norm(a, axis=-1, keepdims=True)
        _close(tisect.reflect(tb, torch.from_numpy(n)), jisect.reflect(b, n))
    elif op == "triangle_normal":
        _close(tisect.triangle_normal(ta, tb, tc),
               jisect.triangle_normal(a, b, c))
    else:
        x = np.abs(a) * 2.0
        x[:8] = 0.0
        _close(tcolor.gamma_correct(torch.from_numpy(x)),
               jcolor.gamma_correct(x))


def test_moller_trumbore_matches_jax(rng):
    o = _vecs(rng, 256, 1)
    d = _vecs(rng, 256, 1)
    v0, e1, e2 = (_vecs(rng, 64) for _ in range(3))
    t_t, v_t = tisect.moller_trumbore(
        torch.from_numpy(o), torch.from_numpy(d),
        tisect.TriangleSoA(*map(torch.from_numpy, (v0, e1, e2))), float("inf"))
    t_j, v_j = jisect.moller_trumbore(o, d, jisect.TriangleSoA(v0, e1, e2),
                                      jnp.inf)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    m = v_t.numpy()
    assert m.any()
    np.testing.assert_allclose(t_t.numpy()[m], np.asarray(t_j)[m], rtol=1e-5)


def test_sampling_matches_jax(rng):
    """The port's sampler, fed the uniforms jax draws, gives JAX's
    directions; tangent frames and stratified offsets match too."""
    n = _vecs(rng, 300)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[:4] = [[0, 0, 1], [0, 0, -1], [0, 1, 0], [1, 0, 0]]
    key = jax.random.PRNGKey(3)
    j = jsamp.cosine_hemisphere(key, jnp.asarray(n), shape=(5,))
    u = np.array(jax.random.uniform(key, (5, 300, 2), dtype=jnp.float32))
    t = tsamp.cosine_hemisphere(torch.from_numpy(u), torch.from_numpy(n))
    _close(t, j)
    for a, b in zip(tsamp.tangent_frame(torch.from_numpy(n)),
                    jsamp.tangent_frame(jnp.asarray(n))):
        _close(a, b)
    for spp in (1, 4, 6):
        np.testing.assert_array_equal(tsamp.stratified_offsets(spp).numpy(),
                                      np.asarray(jsamp.stratified_offsets(spp)))


def test_default_scene_bit_equal():
    js = jax_scene(t=0.0)
    ts = build_default_scene(t=0.0, device="cpu")
    for name in Mesh._fields:
        np.testing.assert_array_equal(getattr(ts.mesh, name).numpy(),
                                      np.asarray(getattr(js.mesh, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(ts.sun.numpy(), np.asarray(js.sun))
    np.testing.assert_allclose(sun_position(7.0).numpy(),
                               np.asarray(jax_sun(7.0)), rtol=1e-6)
    s2 = scene_from_numpy({**{k: np.asarray(v)
                              for k, v in js.mesh._asdict().items()},
                           "sun": np.asarray(js.sun)}, device="cpu")
    for a, b in zip(s2.mesh, ts.mesh):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def scenes():
    return jax_scene(t=0.0), build_default_scene(t=0.0, device="cpu")


def _assert_accel_equal(t_acc, j_acc):
    for name in TP.ClusterAccel._fields:
        tv, jv = getattr(t_acc, name), getattr(j_acc, name)
        assert (tv is None) == (jv is None), name
        if tv is not None:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                          err_msg=name)
            assert tv.numpy().dtype == np.asarray(jv).dtype, name
            assert tv.is_contiguous(), name  # the kernels read raw strides


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("cs", [16, 128])
def test_accel_build_bit_equal(scenes, monkeypatch, cs, native):
    """Every field the port keeps equals the JAX build's, through the
    native host library (where it is built) and its numpy fallbacks."""
    if not native:
        monkeypatch.setattr(JN, "available", lambda: False)
        monkeypatch.setattr(TN, "available", lambda: False)
    js, ts = scenes
    j_acc = JP.build_cluster_accel(js.mesh, cluster_size=cs)
    t_acc = TP.build_cluster_accel(ts.mesh, cluster_size=cs)
    assert t_acc.num_clusters == j_acc.num_clusters
    assert t_acc.cluster_size == cs
    _assert_accel_equal(t_acc, j_acc)
    np.testing.assert_array_equal(t_acc.order_ext.numpy(),
                                  np.asarray(j_acc.order_ext))


def test_accel_from_numpy_round_trip(scenes):
    js, ts = scenes
    j_acc = JP.build_cluster_accel(js.mesh, cluster_size=16)
    t_acc = TP.accel_from_numpy(
        {k: (None if v is None else np.asarray(v))
         for k, v in j_acc._asdict().items()}, device="cpu")
    _assert_accel_equal(t_acc, j_acc)
    own = TP.build_cluster_accel(ts.mesh, cluster_size=16)
    for a, b in zip(own, t_acc):
        assert (a is None and b is None) or torch.equal(a, b)


def test_unported_accel_variants_raise(scenes):
    """Every build method and intersector family is ported now: what is
    refused is an unknown method (the JAX package would take it for
    "morton"), an unknown family, and a query of a family whose table was
    not built."""
    import raytracing_tpu_torch.kernels.traverse as T

    _, ts = scenes
    with pytest.raises(ValueError, match="accel method 'mortom'"):
        TP.build_cluster_accel(ts.mesh, method="mortom")
    with pytest.raises(ValueError, match="block variants"):
        TP.build_cluster_accel(ts.mesh, variants=("pmt", "wop"))
    acc = TP.build_cluster_accel(ts.mesh, cluster_size=16,
                                 variants=("pmt", "mt"))
    rays8 = T.rays_to_soa(torch.zeros((2, 3)),
                          torch.tensor([[0.0, 0.0, 1.0]] * 2))
    with pytest.raises(ValueError, match="'woop' blocks were not built"):
        T.nearest_hit_soa(acc, rays8, variant="woop")
    with pytest.raises(ValueError, match="variant 'wop'"):
        T.any_hit_soa(acc, rays8, variant="wop")


def test_norm_and_safe_reciprocal_match_jax():
    """The public linalg helpers: `norm` at rtol 1e-6 (XLA's reduction
    may fuse), `safe_reciprocal` equal, its infinities (+/-0 components)
    signed as JAX's."""
    rng = np.random.default_rng(4)
    a = _vecs(rng, 64)
    a[0] = 0.0
    a[1, 1] = -0.0
    a[2, 2] = 1e-30
    np.testing.assert_allclose(tlin.norm(torch.from_numpy(a)).numpy(),
                               np.asarray(jlin.norm(jnp.asarray(a))), **TOL)
    got = tlin.safe_reciprocal(torch.from_numpy(a)).numpy()
    want = np.asarray(jlin.safe_reciprocal(jnp.asarray(a)))
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[0]).all() and got[1, 1] == -np.inf
    assert got[2, 2] == np.float32(1.0) / np.float32(1e-30)
    assert np.isfinite(got[2:]).all()
