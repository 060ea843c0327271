"""The port's off-main-path variants against the JAX package on the CPU
(plain versions of the kernels): the accel build methods and the
intersector families' tables bit for bit, the mt / pmtt / woop walks
against brute force and against JAX's Pallas path (interpret mode), the
two-phase capped query and the lane-cull pre-test against the plain
query.

Bars. Builds, tables, pmtt against pmt, the capped query against the
uncapped one and the lane cull on against off: bit for bit (on alive
lanes). Brute force: hits and triangles equal, t at rtol 1e-4
(tests/test_kernels.py:92: mt and woop take another rounding path than
the brute-force Möller–Trumbore). JAX's walks: slots equal, t at rtol 1e-6
+ atol 1e-5 (test_torch_traverse.py's parity bar: XLA contracts a*b+c into
FMAs), woop's t at rtol 1e-5: XLA computes the Woop transform as one
matmul, which sums its terms in its own order with FMAs, and t = -oLz /
dLz carries their rounding (measured 2.2e-6 at most on the bounce pack,
where oLz cancels). JAX's two-phase query: rtol 1e-5. The gradient: JAX's
at rtol 2e-4 (test_torch_grad.py's bar)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raytracing_tpu.geometry.native as jax_native
import raytracing_tpu.kernels.traverse as JT
from raytracing_tpu.accel.packets import build_cluster_accel as jax_build
from raytracing_tpu.geometry.scene import build_default_scene as jax_scene
from raytracing_tpu.geometry.scene import teapot_only_mesh as jax_teapot

import raytracing_tpu_torch.kernels.traverse as T
from raytracing_tpu_torch.accel import packets as TP
from raytracing_tpu_torch.accel.packets import accel_from_numpy
from raytracing_tpu_torch.geometry import native
from raytracing_tpu_torch.geometry.mesh import triangle_soa
from raytracing_tpu_torch.geometry.scene import build_default_scene
from raytracing_tpu_torch.geometry.scene import teapot_only_mesh
from raytracing_tpu_torch.ops.trace import any_hit_brute, nearest_hit_brute

torch.set_num_threads(2)

FAMILIES = ("mt", "pmtt", "woop")
JAX_RTOL, JAX_ATOL = 1e-6, 1e-5
WOOP_RTOL = 1e-5


def _np(x):
    return np.asarray(x)


def _port_accel(ja):
    """The port's accel holding the JAX build's arrays."""
    return accel_from_numpy({k: (None if v is None else _np(v))
                             for k, v in ja._asdict().items()}, device="cpu")


def _assert_accels_equal(ta, ja):
    for name in ja._fields:
        want, got = getattr(ja, name), getattr(ta, name)
        assert (got is None) == (want is None), name
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), _np(want),
                                          err_msg=name)


@pytest.fixture
def calls(monkeypatch):
    """The kernel entries a query calls, each under the name its launch
    counts as on the card (`T._count_key`): on the CPU the entries run
    their plain versions and count nothing."""
    seen = []

    def spy(name, key):
        fn = getattr(T, name)

        def wrapped(*args, **kw):
            seen.append(key(*args, **kw))
            return fn(*args, **kw)

        monkeypatch.setattr(T, name, wrapped)

    def pack_walk(entry):
        def key(rp, ids, cnt, geo, attr, n_attrs, cs, eps, nearest,
                t_max=T.INF, family=T.PMT, tmax_row=None, **kw):
            # K4's per-warp cull is part of K4: it counts as "walk_wq".
            return T._count_key(kw.get("entry", entry), family,
                                nearest and t_max < T.INF,
                                kw.get("lane_bounds") is not None
                                and entry != "walk_wq",
                                kw.get("ray_tile", T.RAY_TILE))
        return key

    def gstream(rp, ids, cnt, geo, attr, n_attrs, cs, gsz, eps, nearest,
                t_max=T.INF, family=T.PMT, tmax_row=None, **kw):
        return T._count_key("walk_gstream", family,
                            nearest and t_max < T.INF,
                            ray_tile=kw.get("ray_tile", T.RAY_TILE))

    spy("walk", pack_walk("walk"))
    spy("walk_wq", pack_walk("walk_wq"))
    spy("walk_gstream", gstream)
    spy("walk_camera", lambda *a, entry="walk_camera", lane_bounds=None,
        **kw: T._count_key(entry, lane_cull=lane_bounds is not None))
    spy("refine_dense_extents", lambda rp, cmin, cmax, t_cap=None,
        ray_tile=T.RAY_TILE: T._count_key("refine_extents",
                                          capped=t_cap is not None,
                                          ray_tile=ray_tile))
    spy("refine_lists", lambda rp, ids, cnt, cmin, cmax, t_cap=None,
        ray_tile=T.RAY_TILE: T._count_key("refine_lists",
                                          capped=t_cap is not None,
                                          ray_tile=ray_tile))
    return seen


@pytest.fixture(scope="module")
def scenes():
    return jax_scene(t=0.0), build_default_scene(t=0.0, device="cpu")


@pytest.fixture(scope="module")
def teapots():
    return jax_teapot(), teapot_only_mesh(device="cpu")


@pytest.fixture
def numpy_only(monkeypatch, request):
    """Both packages' host libraries off (request.param False) or as they
    are (True: the port's always builds here)."""
    if request.param:
        assert native.available(), "the port's host library did not build"
    else:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    return request.param


@pytest.mark.parametrize("numpy_only", [True, False], indirect=True,
                         ids=["native", "numpy"])
@pytest.mark.parametrize("method", ["sah", "median", "morton", "index"])
def test_build_methods_bit_equal_to_jax(scenes, method, numpy_only):
    """Every field of the default scene's accel at CS 16 and 64 — order,
    slot_valid, boxes, the Baldwin–Weber, v0 | e1 | e2, transposed, Woop,
    order and attribute tables (variants "auto": all of them)."""
    js, ts = scenes
    for cs in (16, 64):
        _assert_accels_equal(
            TP.build_cluster_accel(ts.mesh, cluster_size=cs, method=method),
            jax_build(js.mesh, cluster_size=cs, method=method))


@pytest.mark.parametrize("numpy_only", [True, False], indirect=True,
                         ids=["native", "numpy"])
def test_sah_recursive_bit_equal_to_jax(teapots, numpy_only):
    """The recursive SAH oracle on the 6,320-triangle teapot."""
    jm, tm = teapots
    _assert_accels_equal(
        TP.build_cluster_accel(tm, cluster_size=64, method="sah-recursive"),
        jax_build(jm, cluster_size=64, method="sah-recursive"))


@pytest.mark.parametrize("variants", [("pmt",), ("pmt", "woop"),
                                      ("mt", "pmtt")],
                         ids=lambda v: "-".join(v))
def test_explicit_variants_build_those_tables(scenes, variants):
    """An explicit tuple builds just those families (pmt always), bit-equal
    to JAX's; a query of an unbuilt family raises."""
    js, ts = scenes
    ta = TP.build_cluster_accel(ts.mesh, cluster_size=16, variants=variants)
    _assert_accels_equal(ta, jax_build(js.mesh, cluster_size=16,
                                       variants=variants))
    p = T.rays_to_soa(torch.zeros((4, 3)), torch.tensor([[0.0, 0, 1]] * 4))
    for v in T.VARIANTS:
        if v == "pmt" or v in variants:
            T.nearest_hit_soa(ta, p, variant=v)
        else:
            with pytest.raises(ValueError, match="not built"):
                T.nearest_hit_soa(ta, p, variant=v)


def test_native_morton_matches_numpy():
    """tests/test_native.py:48 against the port's own host library."""
    pts = np.random.default_rng(1234).normal(size=(4096, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        native.morton_order(pts),
        np.argsort(TP._morton_codes(pts), kind="stable"))


def test_woop_blocks_recover_intersection(teapots):
    """tests/test_kernels.py:69: the Woop transform of cluster 0's first
    triangle reproduces (t, u, v) = (1, 1/3, 1/3) for a ray at its
    centroid, from the TPU block and from the card's rearranged table."""
    acc = TP.build_cluster_accel(teapots[1], cluster_size=128)
    cs = acc.cluster_size
    tri = acc.tri_blocks.numpy()
    v0, e1, e2 = tri[0, 0:3, 0], tri[0, 3:6, 0], tri[0, 6:9, 0]
    o = v0 + e1 / 3.0 + e2 / 3.0 - np.array([0.0, 0.0, 2.0])
    d = np.array([0.0, 0.0, 2.0])
    out = np.concatenate([o, [1.0], d, [0.0]]).astype(np.float32) \
        @ acc.woop_blocks[0].numpy()
    t = -out[2 * cs] / out[5 * cs]
    uv = [out[0] + t * out[3 * cs], out[cs] + t * out[4 * cs]]
    np.testing.assert_allclose(t, 1.0, rtol=1e-3)
    np.testing.assert_allclose(uv, [1 / 3, 1 / 3], atol=1e-3)
    w = T._woop_table(acc.woop_blocks)[0, :, 0].numpy()  # M rows | const
    ol = w[0:9].reshape(3, 3) @ o + w[9:12]
    dl = w[0:9].reshape(3, 3) @ d
    np.testing.assert_allclose(-ol[2] / dl[2], 1.0, rtol=1e-3)
    assert T._woop_table(acc.woop_blocks) is T._woop_table(acc.woop_blocks)


def test_index_method_matches_brute_force(scenes):
    """tests/test_trace.py:78: the reference's locality sort as the
    packing, walked by the port's kernel path, against brute force."""
    _, ts = scenes
    acc = TP.build_cluster_accel(ts.mesh, cluster_size=64, method="index")
    rng = np.random.default_rng(1234)
    o = torch.from_numpy(rng.uniform(-3, 3, (256, 3)).astype(np.float32)
                         + np.array([0, 0, -5], np.float32))
    d = torch.from_numpy(rng.normal(size=(256, 3)).astype(np.float32))
    d[:, 2] = d[:, 2].abs() + 0.5
    hb = nearest_hit_brute(triangle_soa(ts.mesh.verts, ts.mesh.tri_v), o, d)
    hk = T.nearest_hit(ts.mesh, acc, o, d)
    assert hb.hit.any() and not hb.hit.all()
    assert torch.equal(hb.hit, hk.hit)
    assert torch.equal(hb.tri[hb.hit], hk.tri[hb.hit])


@pytest.fixture(scope="module")
def teapot_setup(teapots):
    """tests/test_kernels.py's setup: the teapot at CS 128 (the JAX build,
    both packages' accels from its arrays), 128 rays from z = 0 toward it
    (rng 1234)."""
    jm, tm = teapots
    ja = jax_build(jm, cluster_size=128)
    rng = np.random.default_rng(1234)
    n = 128
    o = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    o[:, 2] = 0.0
    tgt = np.array([0.0, 0.0, 3.0]) + rng.normal(size=(n, 3)).astype(
        np.float32)
    d = (tgt - o).astype(np.float32)
    return jm, ja, tm, _port_accel(ja), o, d


@pytest.mark.parametrize("variant", FAMILIES)
def test_variant_nearest_matches_brute_and_jax(teapot_setup, variant):
    """`nearest_hit(variant=)` against brute force (tests/test_kernels.py:
    92) and against JAX's `nearest_hit_pallas(variant=)`."""
    jm, ja, tm, ta, o, d = teapot_setup
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    hb = nearest_hit_brute(triangle_soa(tm.verts, tm.tri_v), ot, dt)
    hk = T.nearest_hit(tm, ta, ot, dt, variant=variant)
    m = hb.hit
    assert m.any() and not m.all()
    assert torch.equal(hk.hit, m) and torch.equal(hk.tri[m], hb.tri[m])
    np.testing.assert_allclose(hk.t[m].numpy(), hb.t[m].numpy(), rtol=1e-4)
    hj = JT.nearest_hit_pallas(jm, ja, jnp.asarray(o), jnp.asarray(d),
                               interpret=True, variant=variant)
    np.testing.assert_array_equal(hk.tri.numpy(), _np(hj.tri))
    np.testing.assert_allclose(
        hk.t[m].numpy(), _np(hj.t)[m.numpy()], atol=JAX_ATOL,
        rtol=WOOP_RTOL if variant == "woop" else JAX_RTOL)
    if variant == "pmtt":  # pmt's arithmetic: pmt's bits
        hp = T.nearest_hit(tm, ta, ot, dt)
        assert torch.equal(hk.t, hp.t) and torch.equal(hk.tri, hp.tri)


@pytest.mark.parametrize("variant", FAMILIES)
def test_variant_any_hit_matches_brute(teapot_setup, variant):
    """`any_hit_soa(variant=)` under a scalar and a per-ray t_max against
    brute force."""
    _, _, tm, ta, o, d = teapot_setup
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    tri = triangle_soa(tm.verts, tm.tri_v)
    rays8 = T.rays_to_soa(ot, dt)
    lim = torch.from_numpy(np.linspace(0.2, 1.5, o.shape[0]).astype(
        np.float32))
    for t_max in (1.0, lim):
        want = any_hit_brute(tri, ot, dt, t_max)
        assert want.any() and not want.all()
        assert torch.equal(T.any_hit_soa(ta, rays8, t_max=t_max,
                                         variant=variant), want)


def _bounce_pack(seed, n=256):
    """Incoherent bounce-like rays leaving points near the default scene's
    teapots, one lane in ten dead: an [8, n] numpy pack."""
    rng = np.random.default_rng(seed)
    o = np.array([1.0, -1.2, 7.5]) + rng.normal(scale=[2.0, 0.6, 1.5],
                                                 size=(n, 3))
    d = rng.normal(size=(n, 3))
    alive = (rng.uniform(size=n) > 0.1).astype(np.float32)
    p = np.concatenate([o.T, np.ones((1, n)), d.T, alive[None]])
    return np.ascontiguousarray(p, dtype=np.float32)


@pytest.fixture(scope="module")
def default_accels(scenes):
    js, _ = scenes
    out = {}
    for cs in (16, 64):
        ja = jax_build(js.mesh, cluster_size=cs)
        out[cs] = (ja, _port_accel(ja))
    return out


@pytest.mark.parametrize("variant,cs", [("mt", 16), ("woop", 64)])
def test_variant_attrs_match_jax(default_accels, cs, variant):
    """`nearest_hit_attrs_soa(variant=)` on the default scene (mt at CS
    16, woop at CS 64) against JAX's, and against the port's pmt walk
    (the same winners)."""
    ja, ta = default_accels[cs]
    p = _bounce_pack(7)
    m = p[7] != 0
    tt, ts, tat = T.nearest_hit_attrs_soa(ta, torch.from_numpy(p),
                                          early_exit=True, variant=variant)
    jt, js, jat = JT.nearest_hit_attrs_soa(ja, jnp.asarray(p), interpret=True,
                                           early_exit=True, variant=variant)
    jt, js, jat = _np(jt)[m], _np(js)[m], _np(jat)[:, m]
    tt, ts, tat = tt.numpy()[m], ts.numpy()[m], tat.numpy()[:, m]
    hit = np.isfinite(jt)
    assert hit.sum() > 20 and (~hit).sum() > 20
    np.testing.assert_array_equal(np.isfinite(tt), hit)
    np.testing.assert_array_equal(ts[hit], js[hit])
    np.testing.assert_allclose(
        tt[hit], jt[hit], atol=JAX_ATOL,
        rtol=WOOP_RTOL if variant == "woop" else JAX_RTOL)
    np.testing.assert_allclose(tat, jat, rtol=JAX_RTOL, atol=JAX_ATOL)
    _, ps, _ = T.nearest_hit_attrs_soa(ta, torch.from_numpy(p),
                                       early_exit=True)
    np.testing.assert_array_equal(ps.numpy()[m][hit], ts[hit])


@pytest.mark.parametrize("impl", ["dma", "grid"])
def test_mt_wq_entries_at_cs128(scenes, monkeypatch, calls, impl):
    """mt at CS 128 through the wq entry — the `_walk_dma` walk (K2) and
    the work-queue walk (K4) — equals mt through K1 and, in its winners,
    pmt; woop with wq falls through to K1, as in the JAX package."""
    _, ts = scenes
    acc = TP.build_cluster_accel(ts.mesh, cluster_size=128)
    p = torch.from_numpy(_bounce_pack(11))
    m = p[7] != 0
    monkeypatch.setattr(T, "_WQ_IMPL", impl)
    want = T.nearest_hit_attrs_soa(acc, p, variant="mt")
    assert calls == ["walk_mt"]
    got = T.nearest_hit_attrs_soa(acc, p, variant="mt", wq=True)
    assert calls[1:] == (["refine_extents", "walk_dma_mt"] if impl == "dma"
                         else ["refine_extents", "walk_wq_mt"])
    assert all(torch.equal(a[..., m], b[..., m]) for a, b in zip(got, want))
    occ = T.any_hit_soa(acc, p, t_max=30.0, variant="mt")
    assert torch.equal(T.any_hit_soa(acc, p, t_max=30.0, variant="mt",
                                     wq=True)[m], occ[m])
    _, pmt_s, _ = T.nearest_hit_attrs_soa(acc, p)
    hit = torch.isfinite(want[0]) & m
    assert hit.any() and torch.equal(pmt_s[hit], want[1][hit])
    del calls[:]
    T.nearest_hit_attrs_soa(acc, p, variant="woop", wq=True)
    assert calls == ["walk_woop"]


def test_shaded_mt_gradient_matches_jax(teapots):
    """One differentiated `nearest_hit_shaded(variant="mt")` — t and the
    shading attributes into verts, normals and colors — against JAX's
    `jax.grad` of the same query (tests/test_kernels.py:104's rays)."""
    jm, _ = teapots
    ja = jax_build(jm, cluster_size=128)
    ta = _port_accel(ja)
    tm = teapot_only_mesh(device="cpu")
    rng = np.random.default_rng(1234)
    n = 32
    o = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    o[:, 2] = 0.0
    d = (np.array([0.0, 0.0, 3.0]) + rng.normal(size=(n, 3))
         - o).astype(np.float32)
    w = np.linspace(0.5, 1.5, 9).astype(np.float32)
    names = ("verts", "normals", "colors")

    def jloss(*vals):
        mesh = jm._replace(**dict(zip(names, vals)))
        h, attrs = JT.nearest_hit_shaded(mesh, ja, jnp.asarray(o),
                                         jnp.asarray(d), interpret=True,
                                         variant="mt")
        return jnp.sum(jnp.where(h.hit, h.t, 0.0)) + jnp.sum(attrs * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(getattr(jm, k)
                                                for k in names))
    tables = {k: getattr(tm, k).clone().requires_grad_() for k in names}
    h, attrs = T.nearest_hit_shaded(tm._replace(**tables), ta,
                                    torch.from_numpy(o), torch.from_numpy(d),
                                    variant="mt")
    assert 5 < int(h.hit.sum()) < n
    (torch.where(h.hit, h.t, 0.0).sum()
     + (attrs * torch.from_numpy(w)).sum()).backward()
    for k, wk in zip(names, want):
        wk = _np(wk)
        got = tables[k].grad.numpy()
        assert np.abs(got).max() > 0
        np.testing.assert_allclose(got, wk, rtol=2e-4,
                                   atol=4e-6 * float(np.abs(wk).max()),
                                   err_msg=k)


@pytest.fixture(scope="module")
def cap_setup(scenes):
    """tests/test_kernels.py:234's scene and rays: the default scene at CS
    16 (the ground plane in the rest set), 256 rays at the teapots (near
    hits), at far ground (hits beyond a cap) and at the sky (misses)."""
    js, _ = scenes
    ja = jax_build(js.mesh, cluster_size=16)
    ta = _port_accel(ja)
    assert ta.rest_ids is not None
    rng = np.random.default_rng(1234)
    n = 256
    o = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    tgt = np.concatenate([
        np.array([-0.9, -2.0, 9.0]) + rng.normal(size=(n // 2, 3)) * 1.5,
        np.array([0.0, -3.0, 60.0]) + rng.normal(size=(n // 4, 3)) * 20.0,
        np.array([0.0, 50.0, 10.0])
        + rng.normal(size=(n - n // 2 - n // 4, 3)) * 5.0,
    ]).astype(np.float32)
    d = tgt - o
    rays8 = T.rays_to_soa(torch.from_numpy(o), torch.from_numpy(d))
    return ja, ta, o, d, rays8, T.nearest_hit_attrs_soa(ta, rays8)


@pytest.mark.parametrize("t_cap", [2.0, 8.0, 40.0])
def test_t_cap_two_phase_matches_uncapped(cap_setup, calls, t_cap):
    """tests/test_kernels.py:234: the capped query equals the uncapped
    one bit for bit (t, slots, attributes) — a rest hit beyond the cap
    settles nothing; the first phase's walk counts as capped, the second
    as the plain walk. At the middle cap, also JAX's two-phase query at
    rtol 1e-5 (its three interpreted walks take ~13 s a cap)."""
    ja, ta, o, d, rays8, ref = cap_setup
    got = T.nearest_hit_attrs_soa(ta, rays8, t_cap=t_cap)
    assert calls == ["walk_capped", "walk"]
    hit = torch.isfinite(ref[0])
    assert hit.any() and not hit.all() and bool((ref[0][hit] < t_cap).any())
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    if t_cap != 8.0:
        return
    jt, js, jat = JT.nearest_hit_attrs_soa(
        ja, JT.rays_to_soa(jnp.asarray(o), jnp.asarray(d)), interpret=True,
        t_cap=t_cap)
    np.testing.assert_array_equal(got[1].numpy(), _np(js))
    np.testing.assert_allclose(got[0].numpy(), _np(jt), rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), _np(jat), rtol=1e-5,
                               atol=1e-6)


def test_capped_refined_lists_match_uncapped(scenes, calls):
    """The cap through the `_walk_dma` entry (K5 dense and gathered clip
    at it) and through the streamed-groups walk (K3): bit-equal to the
    uncapped query on alive lanes."""
    _, ts = scenes
    acc = TP.build_cluster_accel(ts.mesh, cluster_size=16)
    p = torch.from_numpy(_bounce_pack(3, 1024))
    m = p[7] != 0
    want = T.nearest_hit_attrs_soa(acc, p)
    del calls[:]
    got = T.nearest_hit_attrs_soa(acc, p, t_cap=3.0, wq=True)
    assert calls == ["walk_capped", "walk"]  # CS 16: no K2
    assert all(torch.equal(a[..., m], b[..., m]) for a, b in zip(got, want))
    acc128 = TP.build_cluster_accel(ts.mesh, cluster_size=128)
    want = T.nearest_hit_attrs_soa(acc128, p)
    for dense_max in (T._REFINE_DENSE_MAX_C, 8):
        T._REFINE_DENSE_MAX_C, saved = dense_max, T._REFINE_DENSE_MAX_C
        try:
            del calls[:]
            got = T.nearest_hit_attrs_soa(acc128, p, t_cap=3.0, wq=True)
        finally:
            T._REFINE_DENSE_MAX_C = saved
        form = "refine_extents" if dense_max > 8 else "refine_lists"
        assert calls == [form + "_capped", "walk_dma_capped", form,
                         "walk_dma"]
        assert all(torch.equal(a[..., m], b[..., m])
                   for a, b in zip(got, want))
    budget = TP._GROUP_BLOCK_BUDGET_BYTES
    TP._GROUP_BLOCK_BUDGET_BYTES = 1  # groups of 256 clusters: K3
    try:
        del calls[:]
        got = T.nearest_hit_attrs_soa(acc, p, t_cap=3.0, variant="mt")
        assert calls == ["walk_gstream_mt_capped", "walk_gstream_mt"]
    finally:
        TP._GROUP_BLOCK_BUDGET_BYTES = budget
    want = T.nearest_hit_attrs_soa(acc, p, variant="mt")
    assert all(torch.equal(a[..., m], b[..., m]) for a, b in zip(got, want))


def test_lane_cull_matches_off(calls):
    """tests/test_kernels.py:370: the lane-cull pre-test on against off,
    bit-equal on alive lanes — nearest with attributes, occlusion, and
    the camera walk — on incoherent rays where it skips visits."""
    rng = np.random.default_rng(7)
    n = 2048
    o = torch.from_numpy(rng.uniform(-3, 3, (n, 3)).astype(np.float32)
                         + np.array([1, -2, 7], np.float32))
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    alive = torch.from_numpy(rng.uniform(size=n) > 0.1)
    acc = TP.build_cluster_accel(build_default_scene(device="cpu").mesh,
                                 cluster_size=16)
    rays8 = T.rays_to_soa(o, d, alive=alive)
    off = T.nearest_hit_attrs_soa(acc, rays8, early_exit=True)
    on = T.nearest_hit_attrs_soa(acc, rays8, early_exit=True, lane_cull=True)
    assert calls == ["walk", "walk_lc"]
    assert torch.isfinite(off[0][alive]).any()
    assert all(torch.equal(a[..., alive], b[..., alive])
               for a, b in zip(on, off))
    assert torch.equal(T.any_hit_soa(acc, rays8, t_max=5.0, lane_cull=True)
                       [alive], T.any_hit_soa(acc, rays8, t_max=5.0)[alive])
    # The pre-test skips: fewer visits than listed.
    args, kw = T._groups_walk_args(acc, T._pad_rays_soa(rays8)[0], 1e-8,
                                   True, T.INF, 0, lane_cull=True)
    lb = kw["lane_bounds"]
    pack = args[0].reshape(8, -1, 1, T.RAY_TILE)
    act = torch.arange(pack.shape[1])
    kept = sum(int(T._lane_cull_keep(pack, act, args[1][:, j], lb).sum())
               for j in range(int(args[2].min())))
    assert kept < int(args[2].min()) * pack.shape[1]
    from raytracing_tpu_torch.ops.sampling import stratified_offsets

    cam = dict(width=32, height=32, spp=1)
    offs = stratified_offsets(1)
    del calls[:]
    c_off = T.nearest_hit_camera_soa(acc, offs, with_attrs=True, **cam)
    c_on = T.nearest_hit_camera_soa(acc, offs, with_attrs=True,
                                    lane_cull=True, **cam)
    assert calls == ["walk_camera", "walk_camera_lc"]
    assert all(torch.equal(a, b) for a, b in zip(c_on, c_off))


def test_accel_tables_survive_save_load_and_to(tmp_path, scenes):
    """save_accel / load_accel and .to() carry every family's table."""
    _, ts = scenes
    acc = TP.build_cluster_accel(ts.mesh, cluster_size=16)
    path = str(tmp_path / "a.npz")
    TP.save_accel(path, acc, ts.mesh)
    back = TP.load_accel(path, ts.mesh, cluster_size=16, device="cpu")
    for name in ("tri_blocks", "pmt_t_blocks", "woop_blocks", "order_blocks",
                 "attr_t_blocks"):
        assert getattr(acc, name) is not None, name
        assert torch.equal(getattr(back, name), getattr(acc, name)), name
        assert torch.equal(getattr(acc.to("cpu"), name), getattr(acc, name))
