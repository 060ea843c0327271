"""Gradients through the port's renderer on the CPU (plain versions of the
kernels), against finite differences and against the JAX package's
`jax.grad` through its Pallas backend (interpret mode), with the very
uniforms JAX draws.

Scenes: tests/test_grad.py's one triangle (its brute-force cases become a
CS 8 accel here: the port has no brute-force backend), the default scene
for the lights (tests/test_lights.py:59) and the teapot for the lazy t
(tests/test_kernels.py:104). Bars: the finite-difference tolerances of
tests/test_grad.py, and JAX's gradients at rtol 2e-4 + atol 1e-7 (the bar
of tests/test_grad.py:177; XLA contracts a*b+c, the port does not). The
backward's tables are built bit-equal to JAX's, and a walk that carries
them returns the same t, slots and shading planes as one that does not."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raytracing_tpu.kernels.traverse as JT
from raytracing_tpu.accel.packets import build_cluster_accel as jax_build
from raytracing_tpu.config import RenderConfig as JaxConfig
from raytracing_tpu.geometry.mesh import SphereLight as JaxSphereLight
from raytracing_tpu.geometry.mesh import concat_objects as jax_concat
from raytracing_tpu.geometry.scene import build_default_scene as jax_scene
from raytracing_tpu.geometry.scene import teapot_only_mesh as jax_teapot
from raytracing_tpu.kernels import binning as JB
from raytracing_tpu.models import whitted as JW

import raytracing_tpu_torch.kernels.traverse as T
from raytracing_tpu_torch import RenderConfig
from raytracing_tpu_torch.accel import packets
from raytracing_tpu_torch.accel.packets import (accel_from_numpy,
                                                build_cluster_accel)
from raytracing_tpu_torch.geometry.mesh import SphereLight, scene_from_numpy
from raytracing_tpu_torch.kernels import binning as TB
from raytracing_tpu_torch.models import whitted as TW
from raytracing_tpu_torch.ops.scatter import segment_scatter_add

torch.set_num_threads(2)

CFG = dict(width=8, height=8, samples_per_pixel=1, reflect_depth=1,
           diffuse_depth=1, normals="geometric")
DEEP = dict(CFG, reflect_depth=3, diffuse_depth=2, diffuse_scatter=4)
WEIGHTS = np.array([0.3, 0.5, 0.2], np.float32)
TABLES = ("verts", "colors", "materials")
JAX_RTOL, JAX_ATOL = 2e-4, 1e-7


def _np(x):
    return np.asarray(x)


def _tri_object(colors=None, n_tris=1, material=(1.0, 0.0, 0.5)):
    """tests/test_grad.py's triangle facing the camera (its normal toward
    the camera and the sun); with n_tris=2 a second one beside it."""
    verts = [[-2.0, -2.0, 5.0], [3.0, -2.0, 5.0], [-2.0, 3.0, 5.0]]
    tri_v = [[0, 2, 1]]
    if n_tris == 2:
        verts.append([3.0, 3.0, 5.0])
        tri_v.append([1, 2, 3])
    return {"verts": np.array(verts, np.float32),
            "tri_v": np.array(tri_v, np.int32),
            "colors": (np.array([0.8, 0.6, 0.4], np.float32)
                       if colors is None else colors),
            "material": material}


def _both(jax_mesh, sun, cs, lights=None):
    """The JAX scene and accel, and the port's from the same arrays."""
    arrays = {k: _np(v) for k, v in jax_mesh._asdict().items()}
    arrays["sun"] = _np(sun)
    if lights is not None:
        arrays["lights"] = {k: _np(v) for k, v in lights._asdict().items()}
    ja = jax_build(jax_mesh, cluster_size=cs)
    ta = accel_from_numpy({k: (None if v is None else _np(v))
                           for k, v in ja._asdict().items()}, device="cpu")
    return ja, scene_from_numpy(arrays, device="cpu"), ta


@pytest.fixture(scope="module")
def tri():
    jm = jax_concat([_tri_object()])
    sun = jnp.array([200.0, 300.0, -1000.0])
    ja, ts, ta = _both(jm, sun, 8)
    return jm, sun, ja, ts, ta


def _rays(n=16):
    xs = np.linspace(-0.1, 0.15, n).astype(np.float32)
    o = np.zeros((n, 3), np.float32)
    d = np.stack([xs, xs * 0.5 + 0.02, np.ones(n, np.float32)], axis=-1)
    return o, d


def jax_uniforms(key):
    """uniforms(tag, shape) = what JAX's `render_rays(..., key)` draws: the
    fan at `depth` from fold_in(key, depth), a light's shadow sample from
    fold_in(fold_in(key, 7777 + depth), light * 131 + sample)."""

    def draw(tag, shape):
        if isinstance(tag, tuple):
            _, depth, li, s = tag
            k = jax.random.fold_in(jax.random.fold_in(key, 7777 + depth),
                                   li * 131 + s)
        else:
            k = jax.random.fold_in(key, tag)
        return torch.from_numpy(np.array(
            jax.random.uniform(k, shape, dtype=jnp.float32)))

    return draw


def port_loss(scene, accel, o, d, cfg, tables, weights=WEIGHTS, lights=None,
              key=jax.random.PRNGKey(0)):
    """sum(rgb * weights) of the port's render_rays with the mesh's tables
    replaced by `tables` (name -> tensor)."""
    mesh = scene.mesh._replace(**tables)
    rgb = TW.render_rays(mesh, accel, scene.sun, torch.from_numpy(o),
                         torch.from_numpy(d), RenderConfig(**cfg),
                         jax_uniforms(key), lights=lights)
    return (rgb * torch.from_numpy(weights)).sum()


def port_grads(scene, accel, o, d, cfg, names=TABLES, **kw):
    tables = {k: getattr(scene.mesh, k).clone().requires_grad_()
              for k in names}
    port_loss(scene, accel, o, d, cfg, tables, **kw).backward()
    return {k: (torch.zeros_like(v) if v.grad is None else v.grad).numpy()
            for k, v in tables.items()}


def jax_grads(jm, sun, ja, o, d, cfg, names=TABLES):
    """jax.grad of the same loss through JAX's Pallas backend (interpret
    mode), jitted once."""
    jcfg = JaxConfig(backend="pallas", **cfg)

    def loss(*vals):
        mesh = jm._replace(**dict(zip(names, vals)))
        rgb = JW.render_rays(mesh, ja, sun, jnp.asarray(o), jnp.asarray(d),
                             jax.random.PRNGKey(0), jcfg)
        return jnp.sum(rgb * WEIGHTS)

    g = jax.jit(jax.grad(loss, argnums=tuple(range(len(names)))))(
        *(getattr(jm, k) for k in names))
    return {k: _np(v) for k, v in zip(names, g)}


@pytest.fixture(scope="module")
def base(tri):
    jm, sun, ja, ts, ta = tri
    o, d = _rays()
    return (port_grads(ts, ta, o, d, CFG),
            jax_grads(jm, sun, ja, o, d, CFG))


def _assert_jax(port, want, names=TABLES):
    for k in names:
        np.testing.assert_allclose(port[k], want[k], rtol=JAX_RTOL,
                                   atol=JAX_ATOL, err_msg=k)


def test_vertex_gradient_includes_t_term(base):
    """Under geometric normals a vertex moves the shading normal AND the
    hit distance t, which moves the hit point and so the sun direction:
    the port's vertex gradient must hold both terms, as JAX's does. A
    renderer that takes t and the attributes from the walk as constants
    keeps only the normal's term and fails."""
    port, want = base
    assert np.abs(want["verts"]).max() > 1e-6
    np.testing.assert_allclose(port["verts"], want["verts"], rtol=JAX_RTOL,
                               atol=JAX_ATOL)


def test_grad_verts_finite_nonzero(base):
    port, want = base
    assert np.isfinite(port["verts"]).all()
    assert np.abs(port["verts"]).max() > 1e-6
    _assert_jax(port, want, ("verts",))


def _fd(scene, name, index, cfg=CFG, h=1e-3):
    """Central difference of the loss in one entry of a mesh table, each
    side rendered with an accel built from its own mesh (the walk reads
    the tables it was built from)."""
    o, d = _rays()
    sides = []
    for sign in (1.0, -1.0):
        x = getattr(scene.mesh, name).clone()
        x[index] += sign * h
        side = scene._replace(mesh=scene.mesh._replace(**{name: x}))
        acc = build_cluster_accel(side.mesh, cluster_size=8)
        with torch.no_grad():
            sides.append(float(port_loss(side, acc, o, d, cfg, {})))
    return (sides[0] - sides[1]) / (2 * h)


def test_grad_verts_matches_fd(tri, base):
    ts = tri[3]
    port, want = base
    rng = np.random.default_rng(0)
    for _ in range(4):
        i, k = rng.integers(0, 3), rng.integers(0, 3)
        np.testing.assert_allclose(port["verts"][i, k],
                                   _fd(ts, "verts", (i, k)), rtol=5e-2,
                                   atol=1e-5)
    _assert_jax(port, want, ("verts",))


def test_grad_materials_matches_fd(tri, base):
    ts = tri[3]
    port, want = base
    for k in range(2):  # albedo, reflectivity (roughness inert here)
        np.testing.assert_allclose(port["materials"][0, k],
                                   _fd(ts, "materials", (0, k)), rtol=5e-2,
                                   atol=1e-6)
    _assert_jax(port, want, ("materials",))


def test_grad_colors_matches_fd(tri, base):
    ts = tri[3]
    port, want = base
    np.testing.assert_allclose(port["colors"][0, 1],
                               _fd(ts, "colors", (0, 1)), rtol=2e-2)
    _assert_jax(port, want, ("colors",))


def test_grad_through_reflection_and_diffuse(tri):
    """Finite, nonzero and JAX's through the whole wavefront: a
    reflection chain and a stochastic diffuse fan (JAX's exact draws)."""
    jm, sun, ja, ts, ta = tri
    o, d = _rays(8)
    mats = np.array([[1.0 / np.pi, 0.5, 0.5]], np.float32)
    jm = jm._replace(materials=jnp.asarray(mats))
    ts = ts._replace(mesh=ts.mesh._replace(materials=torch.from_numpy(mats)))
    port = port_grads(ts, ta, o, d, DEEP, names=("verts",))
    assert np.isfinite(port["verts"]).all()
    assert np.abs(port["verts"]).max() > 1e-8
    _assert_jax(port, jax_grads(jm, sun, ja, o, d, DEEP, names=("verts",)),
                ("verts",))


def test_grad_coarse_accel_matches_fine(tri, base):
    """tests/test_grad.py's cluster-vs-brute test: the gradient does not
    depend on how the accel clusters the mesh (CS 128 against CS 8)."""
    _, _, _, ts, _ = tri
    o, d = _rays()
    coarse = port_grads(ts, build_cluster_accel(ts.mesh, cluster_size=128),
                        o, d, CFG)
    port, want = base
    for k in TABLES:
        np.testing.assert_allclose(coarse[k], port[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    _assert_jax(coarse, want)


def test_grad_every_table_matches_jax_pallas(base):
    """tests/test_grad.py:177's test: vertex, color and material
    gradients of the fused walk's backward against JAX's `_shaded_walk`
    backward."""
    port, want = base
    for k in TABLES:
        assert np.abs(want[k]).max() > 0, k
    _assert_jax(port, want)


def _summed_atol(want):
    """The absolute bar of a mesh table summed over many rays: an entry
    can be the sum of terms that cancel (a vertex of 1e-3 in a table whose
    largest is 0.7), added in another order than XLA's and without its
    FMAs, so it is held to 4e-6 of the table's largest magnitude (measured
    at most 1.2e-6 on the scenes below)."""
    return 4e-6 * float(np.abs(want).max())


LIGHT = dict(center=np.array([[1.0, 8.0, 7.0]], np.float32),
             radius=np.array([2.0], np.float32),
             emission=np.array([[1.5, 1.5, 1.5]], np.float32))
LIGHT_CFG = dict(width=40, height=40, samples_per_pixel=1, reflect_depth=1,
                 diffuse_depth=0, light_samples=4)
LIGHT_TABLES = ("verts", "normals", "colors", "materials")


def test_light_param_gradients():
    """tests/test_lights.py:59: gradients reach the light's center, radius
    and emission (finite; emission's nonzero) — and, with the mesh's
    tables, equal JAX's through its Pallas backend (64 rays, the default
    scene, CS 128, 4 shadow samples of JAX's draws)."""
    js = jax_scene(t=0.0)
    jl = JaxSphereLight(**{k: jnp.asarray(v) for k, v in LIGHT.items()})
    ja, ts, ta = _both(js.mesh, js.sun, 128, lights=jl)
    n = 64
    xs = np.linspace(-0.4, 0.4, n).astype(np.float32)
    o = np.zeros((n, 3), np.float32)
    d = np.stack([xs, xs * 0.1 - 0.25, np.ones(n, np.float32)], -1)
    key = jax.random.PRNGKey(2)
    ones = np.ones(3, np.float32)

    def jloss(center, radius, emission, *tables):
        light = JaxSphereLight(center=center, radius=radius,
                               emission=emission)
        mesh = js.mesh._replace(**dict(zip(LIGHT_TABLES, tables)))
        rgb = JW.render_rays(mesh, ja, js.sun, jnp.asarray(o),
                             jnp.asarray(d), key,
                             JaxConfig(backend="pallas", **LIGHT_CFG),
                             lights=light)
        return jnp.sum(rgb)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(7))))(
        jl.center, jl.radius, jl.emission,
        *(getattr(js.mesh, k) for k in LIGHT_TABLES))
    light = SphereLight(*(getattr(ts.lights, f).clone().requires_grad_()
                          for f in SphereLight._fields))
    tables = {k: getattr(ts.mesh, k).clone().requires_grad_()
              for k in LIGHT_TABLES}
    port_loss(ts, ta, o, d, LIGHT_CFG, tables, weights=ones, lights=light,
              key=key).backward()
    got = [light.center.grad, light.radius.grad, light.emission.grad] + \
        [tables[k].grad for k in LIGHT_TABLES]
    for g in got[:3]:
        assert torch.isfinite(g).all()
    assert float(got[2].abs().sum()) > 0.0
    names = ("center", "radius", "emission") + LIGHT_TABLES
    for name, g, w in zip(names, got, want):
        w = _np(w)
        atol = (_summed_atol(w) if name in LIGHT_TABLES else JAX_ATOL)
        np.testing.assert_allclose(g.numpy(), w, rtol=JAX_RTOL, atol=atol,
                                   err_msg=name)


def test_grad_through_lazy_t():
    """tests/test_kernels.py:104: vertex gradients flow through the walk's
    t (`nearest_hit`, original triangle ids) — finite, nonzero and equal
    to JAX's `_lazy_t` backward; the rays get theirs too."""
    jm = jax_teapot()
    ja, ts, ta = _both(jm, jnp.zeros(3), 128)
    rng = np.random.default_rng(1234)
    n = 32
    o = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    o[:, 2] = 0.0
    tgt = np.array([0.0, 0.0, 3.0]) + rng.normal(size=(n, 3))
    d = (tgt - o).astype(np.float32)

    def jloss(verts, o_, d_):
        h = JT.nearest_hit_pallas(jm._replace(verts=verts), ja, o_, d_,
                                  interpret=True)
        return jnp.sum(jnp.where(h.hit, h.t, 0.0))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jm.verts, jnp.asarray(o),
                                              jnp.asarray(d))
    args = [ts.mesh.verts.clone().requires_grad_(),
            torch.from_numpy(o).requires_grad_(),
            torch.from_numpy(d).requires_grad_()]
    h = T.nearest_hit(ts.mesh._replace(verts=args[0]), ta, args[1], args[2])
    assert 5 < int(h.hit.sum()) < n
    torch.where(h.hit, h.t, 0.0).sum().backward()
    g = args[0].grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    for got, w, name in zip(args, want, ("verts", "o", "d")):
        w = _np(w)
        np.testing.assert_allclose(
            got.grad.numpy(), w, rtol=JAX_RTOL,
            atol=_summed_atol(w) if name == "verts" else JAX_ATOL,
            err_msg=name)


def test_bin_sort_grad_matches_native_sort_grad():
    """tests/test_dispatch.py:82: bin_sort / unsort move cotangents by the
    inverse permutation (autograd of their plain indexing does it): the
    gradients equal that permutation written out, and JAX's custom VJP on
    the same inputs."""
    rng = np.random.default_rng(7)
    n = 1024
    key = rng.integers(0, 257, n).astype(np.int32)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    alive = rng.integers(0, 2, n).astype(bool)
    w = rng.random((n, 3)).astype(np.float32)

    def jloss(x_):
        sidx, (xs, _) = JB.bin_sort(jnp.asarray(key), x_, jnp.asarray(alive))
        (back,) = JB.unsort(sidx, xs * xs)
        return jnp.sum(back * w)

    want = _np(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    sidx, (xs, _) = TB.bin_sort(torch.from_numpy(key), xt,
                                torch.from_numpy(alive))
    (back,) = TB.unsort(sidx, xs * xs)
    (back * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-7)
    # Each alone, against the inverse permutation written out: a sorted
    # slot j's cotangent lands on row sidx[j], and unsort's cotangent at
    # row sidx[j] comes back to sorted slot j.
    perm = sidx.numpy()
    xt = torch.from_numpy(x).requires_grad_()
    _, (xs,) = TB.bin_sort(torch.from_numpy(key), xt)
    (xs * torch.from_numpy(w)).sum().backward()
    inv = np.empty_like(w)
    inv[perm] = w
    np.testing.assert_array_equal(xt.grad.numpy(), inv)
    yt = torch.from_numpy(x).requires_grad_()
    (back,) = TB.unsort(sidx, yt)
    (back * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(yt.grad.numpy(), w[perm])


def test_segment_scatter_add_drops_the_bucket():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 8, 200)  # 7 is the drop bucket of 7 rows
    vals = rng.standard_normal((200, 3)).astype(np.float32)
    want = np.zeros((8, 3), np.float32)
    np.add.at(want, idx, vals)
    got = segment_scatter_add(7, torch.from_numpy(idx), torch.from_numpy(vals))
    assert got.shape == (7, 3)
    np.testing.assert_allclose(got.numpy(), want[:7], rtol=1e-6, atol=1e-6)


def _full_mode(mesh):
    """The mesh with a color per triangle: the accel's full mode (9
    shading planes) instead of objid mode (4)."""
    tri = np.arange(mesh.colors.shape[0], dtype=np.float32)[:, None]
    return mesh._replace(colors=jnp.asarray(
        np.clip(_np(mesh.colors) * (0.5 + 0.5 * np.cos(tri)), 0, 1)
        .astype(np.float32)))


@pytest.fixture(scope="module")
def default_accels():
    """JAX's and the port's builds of the default scene (objid mode, a
    rest set) and of its per-triangle-colored twin (full mode)."""
    js = jax_scene(t=0.0)
    out = {}
    for mode, mesh in (("objid", js.mesh), ("full", _full_mode(js.mesh))):
        ja, ts, ta = _both(mesh, js.sun, 16)
        out[mode] = (ja, ts, ta)
    return out


@pytest.mark.parametrize("mode", ["objid", "full"])
def test_grad_planes_bit_equal_to_jax_build(default_accels, mode):
    ja, ts, _ = default_accels[mode]
    built = build_cluster_accel(ts.mesh, cluster_size=16)
    assert (built.attr_tables is None) == (mode == "full")
    for name in ("grad_blocks", "rest_grad", "attr_blocks", "rest_attrs"):
        want = _np(getattr(ja, name))
        got = getattr(built, name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert built.grad_blocks.shape[1] == 11


def _fan_pack(n=2048, seed=4):
    rng = np.random.default_rng(seed)
    th = rng.uniform(-0.5, 0.5, n)
    ph = rng.uniform(-0.45, 0.5, n)  # some rays down to the ground (rest)
    d = np.stack([np.sin(th), np.sin(ph), np.ones(n)], -1)
    p = np.concatenate([np.zeros((3, n)), np.ones((1, n)), d.T,
                        (rng.uniform(size=(1, n)) > 0.05)])
    return torch.from_numpy(np.ascontiguousarray(p, dtype=np.float32))


@pytest.mark.parametrize("entry", ["walk", "walk_dma", "walk_gstream",
                                   "walk_wq"])
@pytest.mark.parametrize("mode", ["objid", "full"])
def test_both_walk_equals_shade_walk(default_accels, monkeypatch, mode,
                                     entry):
    """The walk carrying the backward's planes (attr_kind "both", A = 15
    or 20) returns the shading walk's t and slots and its shading planes
    bit for bit, and the backward's planes of `grad_planes_soa` — through
    each entry: K1, K2 (`wq` at CS 128), K3 (a table over the group
    budget) and K4 (`_WQ_IMPL = "grid"`)."""
    _, ts, acc = default_accels[mode]
    wq = entry in ("walk_dma", "walk_wq")
    if wq:
        acc = build_cluster_accel(ts.mesh, cluster_size=128)
    if entry == "walk_gstream":
        monkeypatch.setattr(packets, "_GROUP_BLOCK_BUDGET_BYTES", 1)
    if entry == "walk_wq":
        monkeypatch.setattr(T, "_WQ_IMPL", "grid")
    p = _fan_pack()
    alive = p[7] != 0
    widths = _walked_widths(monkeypatch, entry)
    t, s, a = T.nearest_hit_attrs_soa(acc, p, wq=wq)
    tb, sb, ab = T.nearest_hit_attrs_soa(acc, p, wq=wq, attr_kind="both")
    na = acc.attr_blocks.shape[1]
    assert na == (4 if mode == "objid" else 9)
    assert widths == [na, na + 11] and ab.shape[0] == na + 11
    hits = alive & torch.isfinite(t)
    assert 500 < int(hits.sum()) < int(alive.sum())
    assert bool((hits & (s >= acc.order.shape[0])).any())  # rest-set hits
    assert torch.equal(t[alive], tb[alive])
    assert torch.equal(s[alive], sb[alive])
    assert torch.equal(a[:, alive], ab[:na, alive])
    tg, planes = T.grad_planes_soa(acc, p)
    assert torch.equal(tg[alive], t[alive])
    assert torch.equal(planes[:, alive], ab[na:, alive])
    # The planes name the winner: its original triangle and object.
    tri = acc.order_ext[torch.where(hits, s, 0).long()]
    assert torch.equal(planes[9, hits].long(), tri[hits].long())
    obj = ts.mesh.obj_id[tri.long()]
    assert torch.equal(planes[10, hits].long(), obj[hits].long())


def _walked_widths(monkeypatch, entry=None):
    """Spy on the walk entries (or on one, named as `LAUNCHES` names it):
    the attribute rows of each nearest launch."""
    widths = []
    for name in ("walk", "walk_gstream", "walk_wq"):
        real = getattr(T, name)

        def spy(*a, _real=real, _nearest=9 if name == "walk_gstream" else 8,
                _name=name, **kw):
            launched = kw.get("entry", _name).replace("_both", "")
            if a[_nearest] and entry in (None, launched):
                widths.append(a[5])
            return _real(*a, **kw)

        monkeypatch.setattr(T, name, spy)
    return widths


@pytest.mark.parametrize("mode", ["objid", "full"])
def test_undifferentiated_render_walks_shading_planes_only(monkeypatch,
                                                           mode):
    """Without a tensor that requires grad (or under torch.no_grad) the
    renderer's nearest walks carry the shading planes alone (A = 4 in
    objid mode, 9 in full mode); a differentiated render carries the
    backward's 11 beside them."""
    colors = (None if mode == "objid"
              else np.array([[0.8, 0.6, 0.4], [0.2, 0.9, 0.3]], np.float32))
    jm = jax_concat([_tri_object(colors, n_tris=2,
                                 material=(1.0, 0.5, 0.5))])
    _, ts, ta = _both(jm, jnp.array([200.0, 300.0, -1000.0]), 8)
    na = 4 if mode == "objid" else 9
    assert ta.attr_blocks.shape[1] == na
    o, d = _rays()
    cfg = dict(CFG, reflect_depth=2)
    widths = _walked_widths(monkeypatch)
    port_loss(ts, ta, o, d, cfg, {})
    with torch.no_grad():
        port_loss(ts, ta, o, d, cfg,
                  {"verts": ts.mesh.verts.clone().requires_grad_()})
    assert len(widths) == 4 and set(widths) == {na}  # 2 levels, 2 renders
    widths.clear()
    port_loss(ts, ta, o, d, cfg,
              {"colors": ts.mesh.colors.clone().requires_grad_()}).backward()
    assert len(widths) == 2 and set(widths) == {na + 11}


def test_differentiated_query_refuses_ids_beyond_f32(tri, monkeypatch):
    """Triangle ids ride the backward's planes as f32: a differentiated
    query over more than 2^24 triangles raises instead of misrouting."""
    _, _, _, ts, ta = tri
    o, d = _rays()
    monkeypatch.setattr(T, "_MAX_GRAD_TRIANGLES", 0)
    with pytest.raises(ValueError, match="exact only up to"):
        port_loss(ts, ta, o, d, CFG,
                  {"verts": ts.mesh.verts.clone().requires_grad_()})
    with torch.no_grad():  # nothing differentiated: no limit
        port_loss(ts, ta, o, d, CFG, {})


def test_cone_sampler_gradient_is_finite_where_the_cone_closes():
    """A light 1e4 units away subtends a cone with cos_max = 1 in f32, so
    its samples have a sine of exactly 0, where sqrt's slope is infinite:
    JAX's sampler gives an infinite gradient there (and a frame's light
    gradients turn NaN); the port's `sqrt0` keeps the same values and a
    gradient of 0."""
    from raytracing_tpu_torch.ops.sampling import sample_cone

    u = torch.tensor([[0.3, 0.7], [0.0, 0.2], [0.9, 0.5]])
    axis = torch.tensor([[0.0, 0.6, 0.8]] * 3)
    cos_max = torch.tensor([1.0, 0.5, 1.0], requires_grad=True)
    d = sample_cone(u, axis, cos_max)
    d.sum().backward()
    assert torch.isfinite(cos_max.grad).all()
    want = _np(JS_sample_cone(u.numpy(), axis.numpy(),
                              cos_max.detach().numpy()))
    np.testing.assert_allclose(d.detach().numpy(), want, rtol=1e-6,
                               atol=1e-7)


def JS_sample_cone(u, axis, cos_max):
    """The JAX package's cone sampler on given uniforms (its own draws
    replaced)."""
    from raytracing_tpu.ops import sampling as JS

    real = jax.random.uniform
    try:
        jax.random.uniform = lambda key, shape, dtype=None: jnp.asarray(u)
        return JS.sample_cone(jax.random.PRNGKey(0), jnp.asarray(axis),
                              jnp.asarray(cos_max))
    finally:
        jax.random.uniform = real
