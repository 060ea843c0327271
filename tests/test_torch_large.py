"""The port's large-scene pieces on the CPU at a small size: midpoint
subdivision and the CS 128 accel of the twice-subdivided teapot (101,120
triangles, 790 clusters — more than the dense refinement takes, so bounce
queries go through the gathered refinement `refine_lists`), against the JAX
package. Subdivision and accel tables are bit-equal, with the native host
library and with the numpy fallbacks; refined lists are equal as sets;
nearest-hit results at the tolerances of tests/test_torch_traverse.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracing_tpu.kernels.traverse as JT
from raytracing_tpu.accel.packets import build_cluster_accel as jax_build
from raytracing_tpu.geometry.scene import (
    subdivided_teapot_mesh as jax_subdivided)
from raytracing_tpu.geometry.subdivide import (
    subdivide_arrays as jax_subdivide)

import raytracing_tpu_torch.kernels.traverse as T
from raytracing_tpu_torch import build_cluster_accel
from raytracing_tpu_torch.accel.packets import ClusterAccel, accel_from_numpy
from raytracing_tpu_torch.geometry import native
from raytracing_tpu_torch.geometry.mesh import Mesh
from raytracing_tpu_torch.geometry.obj import read_obj
from raytracing_tpu_torch.geometry.scene import (TEAPOT_OBJ,
                                                 subdivided_teapot_mesh,
                                                 teapot_only_mesh)
from raytracing_tpu_torch.geometry.subdivide import subdivide_arrays

torch.set_num_threads(2)

LEVELS = 2
N_RAYS = 2048


@pytest.fixture(scope="module")
def jax_side():
    mesh = jax_subdivided(levels=LEVELS)
    return mesh, jax_build(mesh, cluster_size=128, variants=("pmt",))


@pytest.fixture(scope="module")
def torch_side():
    mesh = subdivided_teapot_mesh(levels=LEVELS, device="cpu")
    return mesh, build_cluster_accel(mesh, cluster_size=128,
                                     variants=("pmt",))


def _no_native(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)


@pytest.mark.parametrize("host", ["native", "numpy"])
def test_subdivide_bit_equal_to_jax(host, monkeypatch):
    if host == "numpy":
        _no_native(monkeypatch)
    else:
        assert native.available(), "the host library did not build"
    ob = read_obj(TEAPOT_OBJ, offset=(0.0, 0.0, 3.0))
    tv, tt = subdivide_arrays(ob["verts"], ob["tri_v"], LEVELS)
    jv, jt = jax_subdivide(ob["verts"], ob["tri_v"], LEVELS)
    assert tt.shape == (6320 * 4 ** LEVELS, 3) and tt.dtype == np.int32
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)


def test_subdivided_mesh_bit_equal_to_jax(jax_side, torch_side):
    for name in Mesh._fields:
        np.testing.assert_array_equal(getattr(torch_side[0], name).numpy(),
                                      np.asarray(getattr(jax_side[0], name)),
                                      err_msg=name)
    one = teapot_only_mesh(device="cpu")
    assert one.num_triangles * 4 ** LEVELS == torch_side[0].num_triangles


def _assert_accel_equal(t_acc, j_acc):
    for name in ClusterAccel._fields:
        a, b = getattr(t_acc, name), getattr(j_acc, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)


@pytest.mark.parametrize("host", ["native", "numpy"])
def test_cs128_accel_bit_equal_to_jax(host, jax_side, torch_side,
                                      monkeypatch):
    if host == "numpy":
        _no_native(monkeypatch)
        acc = build_cluster_accel(torch_side[0], cluster_size=128,
                                  variants=("pmt",))
    else:
        acc = torch_side[1]
    assert acc.num_clusters == 790 and acc.cluster_size == 128
    assert acc.rest_blocks is None
    _assert_accel_equal(acc, jax_side[1])
    carried = accel_from_numpy(
        {k: (None if v is None else np.asarray(v))
         for k, v in jax_side[1]._asdict().items()}, device="cpu")
    for a, b in zip(carried, acc):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.fixture(scope="module")
def pack():
    """Incoherent rays leaving points around the teapot at (0, 0, 3); one
    lane in ten is dead, and the second tile's dead lanes all aim at it."""
    rng = np.random.default_rng(3)
    n = N_RAYS
    o = np.array([0.0, 0.0, 3.0]) + rng.normal(scale=[1.5, 1.0, 1.0],
                                               size=(n, 3))
    d = rng.normal(size=(n, 3))
    alive = (rng.uniform(size=n) > 0.1).astype(np.float32)
    dead = np.nonzero(alive[1024:] == 0)[0] + 1024
    d[dead] = np.array([0.0, 0.0, 3.0]) - o[dead]
    p = np.concatenate([o.T, np.ones((1, n)), d.T, alive[None]])
    return np.ascontiguousarray(p, dtype=np.float32)


def test_refine_lists_keeps_jax_sets(pack, jax_side, torch_side):
    j_acc, acc = jax_side[1], torch_side[1]
    tp = torch.from_numpy(pack)
    ids, tnear, cnt = T._narrow_lists(*T._tile_visit_lists_soa(
        tp, acc.cluster_min, acc.cluster_max))
    keep = T.refine_lists(tp, ids, cnt, acc.cluster_min, acc.cluster_max)
    assert keep.shape == ids.shape and keep.dtype == torch.bool
    assert 0 < int(keep.sum()) < int(cnt.sum())
    pos = torch.arange(ids.shape[1])[None]
    assert not (keep & (pos >= cnt[:, None])).any()
    # The dense form over all 790 clusters sets the same bits.
    dense = T.refine_dense_plain(tp, acc.cluster_min, acc.cluster_max,
                                 torch.ones(2, dtype=torch.bool))
    jp = jnp.asarray(pack)
    jl = JT._tile_visit_lists_soa(jp, j_acc.cluster_min, j_acc.cluster_max,
                                  1024, interpret=True)
    jids, _, jcnt = JT._lane_refine_lists(
        jp, *jl, j_acc.cluster_min, j_acc.cluster_max, 1024,
        j_acc.num_clusters, True)
    rids, rtnear, rcnt = T._refined_lists(acc, tp)
    np.testing.assert_array_equal(rcnt.numpy(), np.asarray(jcnt))
    for k, c in enumerate(rcnt.tolist()):
        kept = set(rids[k, :c].tolist())
        assert kept == set(np.asarray(jids)[k, :c].tolist())
        assert kept == set(ids[k][keep[k]].tolist())
        assert kept == set(torch.nonzero(dense[k]).flatten().tolist())
        assert bool((rtnear[k, 1:c] >= rtnear[k, :c - 1]).all())


def test_refine_lists_tile_with_no_alive_lane(pack, torch_side):
    acc = torch_side[1]
    p = pack.copy()
    p[7, 1024:] = 0.0
    tp = torch.from_numpy(p)
    ids = torch.arange(790, dtype=torch.int32).repeat(2, 1).contiguous()
    cnt = torch.tensor([790, 790], dtype=torch.int32)
    keep = T.refine_lists(tp, ids, cnt, acc.cluster_min, acc.cluster_max)
    assert keep[0].any() and not keep[1].any()
    _, _, rcnt = T._refined_lists(acc, tp)
    assert rcnt[1] == 0


def test_wq_nearest_attrs_match_jax_above_512_clusters(pack, jax_side,
                                                       torch_side):
    """`_walk_dma` entry (K2) over refine_lists' lists, early exit on.
    Tolerances as tests/test_torch_traverse.py: slots and hit flags equal,
    t at rtol 1e-6 plus atol 1e-5 for rays that leave a surface."""
    jt, js, ja = JT.nearest_hit_attrs_soa(jax_side[1], jnp.asarray(pack),
                                          interpret=True, early_exit=True,
                                          wq=True)
    tt, ts, ta = T.nearest_hit_attrs_soa(torch_side[1],
                                         torch.from_numpy(pack),
                                         early_exit=True, wq=True)
    m = pack[7] != 0
    jt, js, ja = np.asarray(jt)[m], np.asarray(js)[m], np.asarray(ja)[:, m]
    tt, ts, ta = tt.numpy()[m], ts.numpy()[m], ta.numpy()[:, m]
    hit = np.isfinite(jt)
    assert hit.sum() > 100 and (~hit).sum() > 100
    np.testing.assert_array_equal(np.isfinite(tt), hit)
    np.testing.assert_array_equal(ts[hit], js[hit])
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nearest", [True, False], ids=["nearest", "any"])
def test_wq_entry_equals_groups_entry(pack, torch_side, nearest):
    """Refined lists change which clusters are walked, never the result."""
    acc, tp = torch_side[1], torch.from_numpy(pack)
    m = torch.from_numpy(pack[7] != 0)
    if nearest:
        a = T.nearest_hit_attrs_soa(acc, tp, wq=True, early_exit=True)
        b = T.nearest_hit_attrs_soa(acc, tp, wq=False)
        assert torch.equal(a[0][m], b[0][m]) and torch.equal(a[1][m], b[1][m])
        assert torch.equal(a[2][:, m], b[2][:, m])
        t, tri = T.nearest_hit_soa(acc, tp)
        assert torch.equal(t[m], b[0][m])
        hit = torch.isfinite(t) & m
        assert torch.equal(tri[hit],
                           acc.order_ext[b[1][hit].long()])
    else:
        a = T.any_hit_soa(acc, tp, t_max=30.0, wq=True)
        b = T.any_hit_soa(acc, tp, t_max=30.0, wq=False)
        assert a[m].any() and not a[m].all()
        assert torch.equal(a[m], b[m])


def test_narrow_lists_keeps_every_listed_entry(torch_side):
    """Lists are cut to the longest one, never shorter: what the gathered
    refinement and the supertile re-test are given."""
    from raytracing_tpu_torch.ops.sampling import stratified_offsets

    acc = torch_side[1]
    ext = T._camera_tile_extents(16, stratified_offsets(1),
                                 T.Camera(64, 64, 1, 1.0, 16, 16))
    ids, tnear, cnt = T.lists_from_extents(*ext, acc.cluster_min,
                                           acc.cluster_max)
    nids, ntnear, ncnt = T._narrow_lists(ids, tnear, cnt)
    assert ids.shape[1] == 790
    assert 0 < nids.shape[1] == int(cnt.max()) < 790
    assert nids.is_contiguous() and ntnear.is_contiguous()
    assert torch.equal(ncnt, cnt) and int(cnt.min()) < int(cnt.max())
    for k, c in enumerate(cnt.tolist()):
        assert torch.equal(nids[k, :c], ids[k, :c])
        assert bool(torch.isfinite(ntnear[k, :c]).all())
        assert bool(torch.isinf(ntnear[k, c:]).all())
    empty = T._narrow_lists(ids, tnear, torch.zeros_like(cnt))
    assert empty[0].shape == (16, 1)


def test_camera_mode_on_the_subdivided_teapot(jax_side, torch_side):
    """CS 128 takes the combined-table camera entry; the subdivided teapot
    is the teapot, so it matches JAX's camera query on it."""
    from raytracing_tpu.ops.sampling import stratified_offsets as jax_offsets
    from raytracing_tpu_torch.ops.sampling import stratified_offsets

    w, h, spp = 32, 32, 1
    jt, js = JT.nearest_hit_camera_soa(jax_side[1], jax_offsets(spp),
                                       width=w, height=h, spp=spp,
                                       interpret=True)
    tt, ts = T.nearest_hit_camera_soa(torch_side[1], stratified_offsets(spp),
                                      width=w, height=h, spp=spp)
    hit = np.isfinite(np.asarray(jt))
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_array_equal(torch.isfinite(tt).numpy(), hit)
    np.testing.assert_array_equal(ts.numpy()[hit], np.asarray(js)[hit])
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit],
                               rtol=1e-5)
