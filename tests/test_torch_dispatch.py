"""Which walk a query takes, and that every one of them gives the same
answer: the streamed-groups walk (K3) and the K1 group loop behind a table
above the group budget, the work-queue walk (K4) behind
`_WQ_IMPL = "grid"`. CPU tensors, so each wrapper runs its plain version;
the kernels themselves against these are tests/test_torch_gpu.py.

Bars: inside the port every path is bit-equal to the single K1 launch (t,
slots, attributes, any-hit flags — the walks differ only in the order of
their visits, and the (min t, min slot) rule does not). Against JAX's
Pallas kernels in interpret mode, with the same grouping forced there:
slots and flags equal, t at rtol 1e-6 + atol 1e-5, the bar of
tests/test_torch_traverse.py (XLA contracts a*b+c, the port does not)."""

import collections

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracing_tpu.kernels.traverse as JT
from raytracing_tpu.accel import packets as jax_packets
from raytracing_tpu.accel.packets import build_cluster_accel as jax_build
from raytracing_tpu.geometry.scene import build_default_scene as jax_scene

import raytracing_tpu_torch.kernels.traverse as T
from raytracing_tpu_torch.accel import packets
from raytracing_tpu_torch.accel.packets import accel_from_numpy

torch.set_num_threads(2)

INF = float("inf")


@pytest.fixture(scope="module")
def accels():
    scene = jax_scene(t=0.0)
    out = {}
    for cs in (16, 128):
        j = jax_build(scene.mesh, cluster_size=cs)
        out[cs] = (j, accel_from_numpy(
            {k: (None if v is None else np.asarray(v))
             for k, v in j._asdict().items()}, device="cpu"))
    return out


def _camera_pack(seed, n=256):
    """The rays of tests/test_dispatch.py: a fan from the pinhole."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-0.5, 0.5, n)
    ph = rng.uniform(-0.2, 0.5, n)
    d = np.stack([np.sin(th), np.sin(ph), np.ones(n)], -1)
    p = np.concatenate([np.zeros((3, n)), np.ones((1, n)), d.T,
                        np.ones((1, n))])
    return np.ascontiguousarray(p, dtype=np.float32)


def _wq_pack(seed, n=2048):
    """The rays of tests/test_kernels.py's wq tests: half a camera fan,
    half incoherent rays among the teapots; one lane in ten dead, and the
    last tile dead as a whole (no visits)."""
    rng = np.random.default_rng(seed)
    h = n // 2
    xs = rng.uniform(-0.4, 0.4, (h, 2))
    d1 = np.concatenate([xs, np.ones((h, 1))], axis=1)
    o2 = rng.uniform(-3, 3, (h, 3))
    o2[:, 2] += 7.0
    d2 = rng.normal(size=(h, 3))
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    o = np.concatenate([np.zeros((h, 3)), o2])
    d = np.concatenate([d1, d2])
    alive = rng.uniform(size=n) > 0.1
    alive[1024:] &= np.arange(1024) < 1000  # keep tile 1 alive
    p = np.concatenate([o.T, np.ones((1, n)), d.T,
                        alive[None].astype(np.float64)])
    dead = np.tile(np.array([0, 0, 0, 1, 0, 0, 1, 0.0])[:, None], (1, 1024))
    dead[0:3] = o2[:1024].T  # finite garbage aimed through the scene
    dead[4:7] = d2[:1024].T
    return np.ascontiguousarray(np.concatenate([p, dead], axis=1),
                                dtype=np.float32)


def _queries(acc, p, tmax, **kw):
    """(t, tri), (t, slot, attrs), any-hit and per-ray any-hit of a pack."""
    tp = torch.from_numpy(p)
    return (T.nearest_hit_soa(acc, tp),
            T.nearest_hit_attrs_soa(acc, tp, **kw),
            T.any_hit_soa(acc, tp),
            T.any_hit_soa(acc, tp, t_max=torch.from_numpy(tmax)))


def _flat(results):
    return [x for r in results for x in (r if isinstance(r, tuple) else (r,))]


@pytest.mark.parametrize("early", [None, True], ids=["auto", "early-exit"])
@pytest.mark.parametrize("streamed", [True, False], ids=["K3", "K1-loop"])
def test_grouped_walk_matches_single_group(accels, monkeypatch, streamed,
                                           early):
    """A budget of one byte cuts the CS 16 teapot scene's 790 clusters into
    4 groups of 256: nearest (ids, slots, attributes) and any-hit (scalar
    and per-ray t_max) equal the single launch bit for bit."""
    _, acc = accels[16]
    p = _camera_pack(0)
    tmax = np.linspace(0.5, 30.0, p.shape[1]).astype(np.float32)
    single = _flat(_queries(acc, p, tmax, early_exit=early))
    assert 50 < int(torch.isfinite(single[0]).sum()) < 250
    monkeypatch.setattr(packets, "_GROUP_BLOCK_BUDGET_BYTES", 1)
    monkeypatch.setattr(T, "STREAM_GROUPS", streamed)
    assert T._group_clusters(acc, 4) == 256
    grouped = _flat(_queries(acc, p, tmax, early_exit=early))
    for a, b in zip(grouped, single):
        assert torch.equal(a, b)


def test_grouped_walk_matches_jax(accels, monkeypatch):
    """The same grouping forced in both packages (JAX's budget of
    tests/test_dispatch.py: groups of 256 clusters, streamed, early exit
    on)."""
    j_acc, acc = accels[16]
    p = _camera_pack(3)
    monkeypatch.setattr(jax_packets, "_PALLAS_BLOCK_BUDGET_BYTES",
                        300 * 8192)
    monkeypatch.setattr(JT, "_EARLY_EXIT_MIN_CLUSTERS", 1)
    jt, js, ja = JT.nearest_hit_attrs_soa(j_acc, jnp.asarray(p),
                                          interpret=True)
    jocc = JT.any_hit_soa(j_acc, jnp.asarray(p), interpret=True)
    monkeypatch.setattr(packets, "_GROUP_BLOCK_BUDGET_BYTES", 1)
    monkeypatch.setattr(T, "_EARLY_EXIT_MIN_CLUSTERS", 1)
    tt, ts, ta = T.nearest_hit_attrs_soa(acc, torch.from_numpy(p))
    tocc = T.any_hit_soa(acc, torch.from_numpy(p))
    hit = np.isfinite(np.asarray(jt))
    assert 50 < hit.sum() < 250
    np.testing.assert_array_equal(np.isfinite(tt.numpy()), hit)
    np.testing.assert_array_equal(ts.numpy()[hit], np.asarray(js)[hit])
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit],
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))


def test_streamed_lists_are_group_local_and_padded(accels, monkeypatch):
    """The K3 launch: per-group lists with ids below the group size, the
    listed clusters of all groups the single launch's list as a set, no
    entry on a dead tile, the table padded to whole groups with zero
    blocks, one union box per group."""
    _, acc = accels[16]
    p = np.concatenate([_camera_pack(1, 1024), _wq_pack(2)[:, 2048:]], axis=1)
    tp = torch.from_numpy(np.ascontiguousarray(p))
    monkeypatch.setattr(packets, "_GROUP_BLOCK_BUDGET_BYTES", 1)
    args, kw = T._gstream_walk_args(acc, tp, 1e-8, True, INF, 4,
                                    early_exit=True)
    ids, cnt, geo, attr, gsz = args[1], args[2], args[3], args[4], args[7]
    assert ids.shape == (4, 2, 256) and cnt.shape == (4, 2) and gsz == 256
    assert geo.shape[0] == attr.shape[0] == 1024
    assert not geo[790:].any() and not attr[790:].any()
    assert kw["bbox"].shape == (4, 6) and kw["tnear"].shape == ids.shape
    assert int(cnt[:, 1].sum()) == 0 and int(cnt[:, 0].sum()) > 0
    sids, _, scnt = T._tile_visit_lists_soa(tp, acc.cluster_min,
                                            acc.cluster_max)
    listed = set()
    for g in range(4):
        local = ids[g, 0, :int(cnt[g, 0])]
        assert int(local.max()) < 256
        listed |= set((local + g * 256).tolist())
    assert listed == set(sids[0, :int(scnt[0])].tolist())
    assert max(listed) < 790  # a padded cluster is never entered


def test_listed_zero_block_is_never_accepted(accels):
    """If a list does name a padded (all-zero) block, no ray hits it."""
    _, acc = accels[16]
    tp = torch.from_numpy(_camera_pack(4, 1024))
    geo = torch.cat([acc.pmt_blocks[:4], torch.zeros_like(acc.pmt_blocks[:4])])
    ids = torch.arange(4, dtype=torch.int32).reshape(1, 1, 4).repeat(2, 1, 1)
    cnt = torch.full((2, 1), 4, dtype=torch.int32)
    t, s, _ = T.walk_gstream(tp, ids, cnt, geo, None, 0, 16, 4, 1e-8, True)
    t0, s0, _ = T.walk(tp, ids[0], cnt[0], geo[:4], None, 0, 16, 1e-8, True)
    assert torch.equal(t, t0) and torch.equal(s, s0)


Sized = collections.namedtuple("Sized", "cluster_size num_clusters")


@pytest.mark.parametrize("clusters,n_attrs,groups", [
    (790 * 8 // 64, 4, 1),  # the reference frame's bounce accel
    (6320, 0, 1),           # 404k triangles, CS 64
    (12640, 4, 4), (12640, 0, 3),     # 1.6M triangles, CS 128
    (50560, 4, 13), (50560, 0, 10),   # 6.4M triangles, CS 128
])
def test_group_budget_sizes(clusters, n_attrs, groups):
    """The 32 MiB budget leaves the small tables whole and cuts the 1.6M
    and 6.4M scenes' into groups of 4,096 clusters with attribute rows,
    5,461 without."""
    cs = 64 if clusters == 6320 else 128
    gsz = T._group_clusters(Sized(cs, clusters), n_attrs)
    if cs == 128:
        assert gsz == (4096 if n_attrs else 5461)
    assert -(-clusters // gsz) == groups


def _spy(monkeypatch, name, calls):
    real = getattr(T, name)

    def wrapper(*a, **kw):
        calls.append(kw.get("entry", name))
        return real(*a, **kw)

    monkeypatch.setattr(T, name, wrapper)


@pytest.mark.parametrize("case,expect", [
    (dict(cs=16), ["walk"]),
    (dict(cs=16, budget=1), ["walk_gstream"]),
    (dict(cs=16, budget=1, streamed=False), ["walk"] * 4),
    (dict(cs=128, wq=True), ["walk_dma"]),
    (dict(cs=16, wq=True), ["walk"]),
    (dict(cs=128, wq=True, impl="grid"), ["walk_wq"]),
    (dict(cs=16, wq=True, impl="grid"), ["walk_wq"]),
    (dict(cs=16, wq=True, impl="grid", budget=1), ["walk_gstream"]),
    (dict(cs=128, wq=True, budget=1), ["walk_dma"]),
], ids=["K1", "K3", "K1-loop", "wq-dma-K2", "wq-dma-cs16-K1", "wq-grid-K4",
        "wq-grid-cs16-K4", "wq-grid-over-budget-K3", "wq-dma-any-size-K2"])
def test_walk_groups_dispatch(accels, monkeypatch, case, expect):
    """`_walk_groups` takes the TPU package's branches: K2 for `wq` at a
    128-multiple cluster size whatever the table's size, K4 for `wq` under
    "grid" while the table fits the budget, else K1, or K3 / the K1 loop
    above the budget."""
    calls = []
    for name in ("walk", "walk_gstream", "walk_wq"):
        _spy(monkeypatch, name, calls)
    if "budget" in case:
        monkeypatch.setattr(packets, "_GROUP_BLOCK_BUDGET_BYTES",
                            case["budget"])
    monkeypatch.setattr(T, "STREAM_GROUPS", case.get("streamed", True))
    monkeypatch.setattr(T, "_WQ_IMPL", case.get("impl", "dma"))
    _, acc = accels[case["cs"]]
    tp = torch.from_numpy(_camera_pack(5, 1024))
    if case["cs"] == 128 and "budget" in case:
        # 100 clusters never exceed the floor of 256: this case shows that
        # K2 does not ask.
        assert acc.num_clusters <= T._group_clusters(acc, 4)
    T._walk_groups(acc, tp, 1e-8, True, INF, 4, wq=case.get("wq", False))
    assert calls == expect


@pytest.fixture(scope="module")
def wq_pack():
    return _wq_pack(1234)


@pytest.mark.parametrize("cs", [128, 16])
def test_wq_grid_matches_default_walk(accels, monkeypatch, wq_pack, cs):
    """`_WQ_IMPL = "grid"` (K4): nearest with attributes, any-hit, per-ray
    t_max, bit-equal on alive lanes to the walk without `wq`; the dead
    tile (no visits) reads miss / not occluded."""
    _, acc = accels[cs]
    p = wq_pack
    m = torch.from_numpy(p[7] != 0)
    tmax = np.linspace(0.5, 30.0, p.shape[1]).astype(np.float32)
    base = _flat(_queries(acc, p, tmax)[1:])
    monkeypatch.setattr(T, "_WQ_IMPL", "grid")
    calls = []
    _spy(monkeypatch, "walk_wq", calls)
    grid = _flat(_queries(acc, p, tmax, wq=True)[1:])
    assert calls == ["walk_wq"]  # attrs only: any_hit below adds two
    tp = torch.from_numpy(p)
    grid[3] = T.any_hit_soa(acc, tp, wq=True)
    grid[4] = T.any_hit_soa(acc, tp, t_max=torch.from_numpy(tmax), wq=True)
    assert len(calls) == 3
    assert 200 < int(torch.isfinite(base[0][m]).sum()) < int(m.sum())
    for a, b in zip(grid, base):
        assert torch.equal(a[..., m], b[..., m])
    # The walk itself, before the rest set (the ground) is merged in.
    dead = slice(2048, 3072)
    t, s, a = T._walk_groups(acc, tp, 1e-8, True, INF, 4, wq=True)
    assert bool(torch.isinf(t[0, dead]).all())
    assert bool((s[0, dead] == 2 ** 30).all()) and not bool(a[:, dead].any())
    _, occ, _ = T._walk_groups(acc, tp, 1e-8, False, INF, 0, wq=True)
    assert not bool(occ[0, dead].any()) and bool(occ[0, :2048].any())
    assert len(calls) == 5


def test_wq_grid_gathered_refine_matches_dense(accels, monkeypatch, wq_pack):
    """Both forms of the refinement (K5) give K4 the same walk."""
    _, acc = accels[128]
    tp = torch.from_numpy(wq_pack)
    m = torch.from_numpy(wq_pack[7] != 0)
    monkeypatch.setattr(T, "_WQ_IMPL", "grid")
    dense = T.nearest_hit_attrs_soa(acc, tp, wq=True)
    monkeypatch.setattr(T, "_REFINE_DENSE_MAX_C", 0)
    gathered = T.nearest_hit_attrs_soa(acc, tp, wq=True)
    for a, b in zip(gathered, dense):
        assert torch.equal(a[..., m], b[..., m])


def test_wq_plain_merge_is_order_free(accels, wq_pack):
    """The work items of a tile fold to the same result whatever `u`."""
    _, acc = accels[128]
    tp = torch.from_numpy(wq_pack)
    args, _ = T._wq_walk_args(acc, tp, 1e-8, True, INF, 4)
    ref = T.walk_wq_plain(*args, u=4)
    for u in (1, 7, 1000):
        for a, b in zip(T.walk_wq_plain(*args, u=u), ref):
            assert torch.equal(a, b)


def test_wq_grid_matches_jax(accels, monkeypatch, wq_pack):
    """JAX under `_WQ_IMPL = "grid"` with its lists cut to 8 visits (so its
    residual launch runs), against the port's K4 path."""
    j_acc, acc = accels[128]
    p = wq_pack[:, :2048]
    monkeypatch.setattr(JT, "_WQ_IMPL", "grid")
    monkeypatch.setattr(JT, "_MAX_VISITS", 8)
    monkeypatch.setattr(JT, "_SMEM_IDS_BUDGET_BYTES", 4 * 8 * 8 * 8)
    jt, js, ja = JT.nearest_hit_attrs_soa(j_acc, jnp.asarray(p),
                                          interpret=True, wq=True)
    jocc = JT.any_hit_soa(j_acc, jnp.asarray(p), interpret=True, wq=True)
    monkeypatch.setattr(T, "_WQ_IMPL", "grid")
    tt, ts, ta = T.nearest_hit_attrs_soa(acc, torch.from_numpy(p), wq=True)
    tocc = T.any_hit_soa(acc, torch.from_numpy(p), wq=True)
    m = p[7] != 0
    jt, js, ja = np.asarray(jt)[m], np.asarray(js)[m], np.asarray(ja)[:, m]
    hit = np.isfinite(jt)
    assert hit.sum() > 200 and (~hit).sum() > 100
    np.testing.assert_array_equal(np.isfinite(tt.numpy()[m]), hit)
    np.testing.assert_array_equal(ts.numpy()[m][hit], js[hit])
    np.testing.assert_allclose(tt.numpy()[m][hit], jt[hit], rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(ta.numpy()[:, m], ja, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tocc.numpy()[m], np.asarray(jocc)[m])
