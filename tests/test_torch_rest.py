"""The rest-set merge on the CPU: the triangles of objects too small to fill
a cluster (the ground plane's two in the default scene), tested against
every ray of a query and folded into the walk's results.

The query wrappers take the plain versions for CPU tensors (the CUDA kernel,
csrc/rest.cu, only for CUDA tensors: tests/test_torch_gpu.py holds it to
these versions bit for bit); the plain versions' tie rules (the lowest rest
index among equal rest hits, the walk's hit where it ties the rest set),
the per-ray limits of an occlusion merge, and the callers' use of a merge
that updates the walk's outputs in place, as the kernel does.
"""

import numpy as np
import pytest
import torch

from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                  build_default_scene)
from raytracing_tpu_torch.geometry.mesh import concat_objects
from raytracing_tpu_torch.geometry.scene import ground_plane_object
from raytracing_tpu_torch.kernels import traverse as T
from raytracing_tpu_torch.models.camera import (block_ray_ids,
                                                camera_rays_for_ids)
from raytracing_tpu_torch.ops.intersect import INF
from raytracing_tpu_torch.ops.sampling import stratified_offsets

torch.set_num_threads(2)
EPS = 1e-8


def rest_mesh(small: int = 0, seed: int = 0):
    """A mesh with a rest set of 2 + 2 * small rows at CS 16: a 32-triangle
    wall far down +z (the one object big enough for a cluster), the ground
    plane (rest rows 0 and 1, sharing the diagonal x = z at y = -3), then
    `small` quads of 2 triangles above the ground. Quad 0 is a copy of the
    ground (rows 2 and 3 equal rows 0 and 1), and the quad 32 places after
    a quad is that quad again: rows of equal triangles, exact ties."""
    k = 16
    xs = np.linspace(-5.0, 5.0, k + 1)
    wall = np.concatenate([np.stack([xs, 0 * xs, 0 * xs + 60.0], 1),
                           np.stack([xs, 0 * xs + 3.0, 0 * xs + 60.0], 1)])
    tri = [t for i in range(k) for t in ([i, i + 1, k + 1 + i],
                                         [i + 1, k + 2 + i, k + 1 + i])]
    objects = [dict(verts=wall, tri_v=np.array(tri), colors=(0.5, 0.5, 0.5),
                    material=(0.8, 0.0, 1.0)), ground_plane_object()]
    rng = np.random.default_rng(seed)
    quads = []
    for j in range(small):
        if j == 0:
            v = objects[1]["verts"]
        elif j >= 32:
            v = quads[j - 32]
        else:
            c = rng.uniform([-8.0, -2.5, 4.0], [8.0, 2.0, 30.0])
            a, b = rng.normal(size=(2, 3)) * rng.uniform(0.5, 3.0)
            v = np.stack([c, c + a, c + a + b, c + b])
        quads.append(v)
        objects.append(dict(verts=v.astype(np.float32),
                            tri_v=np.array([[0, 1, 2], [0, 3, 2]]),
                            colors=(0.2, 0.3 + 0.01 * j, 0.4),
                            material=(0.5, 0.1, 0.5)))
    return concat_objects(objects)


def _rows(o, d):
    return (tuple(o[k:k + 1] for k in range(3)),
            tuple(d[k:k + 1] for k in range(3)))


def _diagonal_rays(n, seed=0):
    """[3, n] origins near the camera and directions to points on the
    ground's diagonal x = z (the two ground triangles' shared edge)."""
    g = torch.Generator().manual_seed(seed)
    o = torch.stack([torch.rand(n, generator=g) * 4 - 2,
                     torch.rand(n, generator=g) * 3,
                     torch.rand(n, generator=g) * 4 - 2])
    s = torch.linspace(-40.0, 40.0, n)
    return o, torch.stack([s, torch.full_like(s, -3.0), s]) - o


@pytest.fixture(scope="module")
def scene():
    s = build_default_scene(device="cpu")
    return s, build_cluster_accel(s.mesh, cluster_size=16)


@pytest.fixture(scope="module")
def rest_accel():
    return build_cluster_accel(rest_mesh(small=31), cluster_size=16)


def _pack(scene_, n=4096, seed=3):
    """The reference camera's first n rays of block order, one lane in ten
    dead, as a pack."""
    cfg = RenderConfig(width=64, height=64, samples_per_pixel=1)
    o, d = camera_rays_for_ids(block_ray_ids(0, n, cfg, device="cpu"), cfg)
    alive = torch.rand(n, generator=torch.Generator().manual_seed(seed)) > 0.1
    return T.rays_to_soa(o, d, alive=alive)


@pytest.mark.parametrize("query", ["nearest", "attrs", "any_hit",
                                   "any_hit_row", "camera"])
def test_cpu_tensors_take_the_plain_merge(scene, monkeypatch, query):
    """Every query wrapper routes CPU tensors to the plain versions: the
    kernel's launch is never reached and `LAUNCHES["rest_merge"]` stays
    put, and the merge still brings the ground's hits in."""
    _, acc = scene
    seen = []
    for name in ("_merge_rest_nearest_rows", "_merge_rest_occlusion"):
        real = getattr(T, name)
        monkeypatch.setattr(T, name, lambda *a, _r=real, _n=name, **k:
                            seen.append(_n) or _r(*a, **k))

    def launch(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel")
    monkeypatch.setattr(T, "_rest_launch", launch)
    before = T.LAUNCHES["rest_merge"]
    p = _pack(scene)
    n_slots = acc.order.shape[0]
    if query == "nearest":
        _, tri = T.nearest_hit_soa(acc, p)
        hit_rest = torch.isin(tri, acc.rest_ids)
    elif query == "attrs":
        _, slot, _ = T.nearest_hit_attrs_soa(acc, p)
        hit_rest = slot >= n_slots
    elif query == "camera":
        _, slot = T.nearest_hit_camera_soa(acc, stratified_offsets(1),
                                           width=64, height=64, spp=1)
        hit_rest = slot >= n_slots
    else:
        limit = (torch.full((p.shape[1],), 50.0) if query == "any_hit_row"
                 else INF)
        occ = T.any_hit_soa(acc, p, t_max=limit)
        hit_rest = occ & ~T.any_hit_soa(acc._replace(rest_blocks=None), p,
                                         t_max=limit)
    assert seen and set(seen) <= {"_merge_rest_nearest_rows",
                                  "_merge_rest_occlusion"}
    assert T.LAUNCHES["rest_merge"] == before
    assert bool(hit_rest.any())


def test_plain_merge_lowest_rest_index_wins_a_tie(rest_accel):
    """Rays through the ground's shared diagonal hit both ground rows at
    the same t on many lanes; every such lane takes row 0, and no lane
    takes row 2 or 3, the copy of the ground that ties rows 0 and 1."""
    acc = rest_accel
    s0 = acc.order.shape[0]
    o, d = _diagonal_rays(4096)
    t_r = T._rest_t_rows(*_rows(o, d), acc.rest_blocks, EPS)
    tmin = t_r.amin(dim=0)
    tie = torch.isfinite(tmin) & (t_r[0] == tmin) & (t_r[1] == tmin)
    assert int(tie.sum()) > 100
    miss = torch.full((1, o.shape[1]), INF)
    t, slot, _ = T._merge_rest_nearest_rows(
        acc, *_rows(o, d), miss, torch.zeros((1, o.shape[1]),
                                             dtype=torch.int32), None, EPS, 0)
    assert torch.equal(t[0], tmin)
    first = (t_r == tmin).int().argmax(dim=0)   # the lowest equal row
    hit = torch.isfinite(tmin)
    assert torch.equal(slot[0][hit], s0 + first[hit].int())
    assert bool((slot[0][tie] == s0).all())
    rb = acc.rest_blocks
    assert torch.equal(rb[2:4], rb[0:2])        # quad 0: the ground again
    assert not bool(torch.isin(slot[0], s0 + torch.tensor([2, 3])).any())


def test_plain_merge_walk_keeps_a_tie(rest_accel):
    """A walk hit at the rest set's t keeps its slot and attributes; one a
    float step further loses them to the rest set; a nearer one keeps
    them."""
    acc = rest_accel
    o, d = _diagonal_rays(3000, seed=1)
    t_r = T._rest_t_rows(*_rows(o, d), acc.rest_blocks, EPS)
    tmin = t_r.amin(dim=0)
    assert bool(torch.isfinite(tmin).all())
    n = o.shape[1]
    third = torch.arange(n) % 3
    t_walk = torch.where(third == 0, tmin, torch.where(
        third == 1, torch.nextafter(tmin, torch.full_like(tmin, INF)),
        tmin * 0.5))[None]
    slot = torch.full((1, n), 7, dtype=torch.int32)
    na = acc.rest_attrs.shape[1]
    attrs = torch.full((na, n), -1.0)
    t, s, a = T._merge_rest_nearest_rows(acc, *_rows(o, d), t_walk.clone(),
                                         slot, attrs, EPS, na)
    rest = third == 1
    assert bool((s[0][~rest] == 7).all()) and bool((a[:, ~rest] == -1).all())
    assert bool((s[0][rest] >= acc.order.shape[0]).all())
    assert torch.equal(t[0][rest], tmin[rest])
    assert torch.equal(t[0][~rest], t_walk[0][~rest])
    j = s[0][rest] - acc.order.shape[0]
    assert torch.equal(a[:, rest], acc.rest_attrs[j.long()].T)


@pytest.mark.parametrize("limit", ["scalar", "tmax_row"])
def test_plain_occlusion_merge_under_limits(rest_accel, limit):
    """A rest hit occludes only below its ray's limit: the scalar t_max or
    its entry of tmax_row; OR-ed into the walk's flags, never clearing
    one."""
    acc = rest_accel
    o, d = _diagonal_rays(2048, seed=2)
    n = o.shape[1]
    rays8 = torch.cat([o, torch.ones((1, n)), d, torch.ones((1, n))])
    tmin = T._rest_t_rows(*_rows(o, d), acc.rest_blocks, EPS).amin(dim=0)
    assert bool(torch.isfinite(tmin).all())
    below = torch.arange(n) % 2 == 0
    walk = torch.arange(n) % 5 == 0
    if limit == "scalar":
        t_max = float(tmin.median())
        want = walk | (tmin < t_max)
        got = T._merge_rest_occlusion(acc, rays8, walk, EPS, t_max)
    else:
        row = torch.where(below, tmin * 0.999, torch.nextafter(
            tmin, torch.full_like(tmin, INF)))[None]
        want = walk | ~below
        got = T._merge_rest_occlusion(acc, rays8, walk, EPS, INF, row)
        at = T._merge_rest_occlusion(acc, rays8, walk, EPS, INF, tmin[None])
        assert torch.equal(at, walk)        # t < limit: a hit at it is not
    assert torch.equal(got, want)
    assert bool((got & ~walk).any()) and not bool(got.all())


def _in_place(real, first):
    """A merge with the kernel's contract: the plain version's results
    written into the walk's own outputs (arguments first to first + 2),
    which it returns."""
    def merge(*args, **kw):
        new = real(*args, **kw)
        old = args[first:first + 3]
        for a, b in zip(old, new):
            if a is not None:
                a.copy_(b)
        return old
    return merge


@pytest.mark.parametrize("t_cap", [None, 4.0, 12.0])
def test_in_place_merge_equals_the_reassigning_form(scene, monkeypatch,
                                                    t_cap):
    """The queries give the same results whether the merge returns new
    tensors (the plain versions) or updates the walk's outputs in place
    (the kernel's contract), also in the two-phase query under a cap, whose
    phase 2 reads the merged phase-1 results; and the camera query."""
    _, acc = scene
    p = _pack(scene, seed=4)
    want = T.nearest_hit_attrs_soa(acc, p, t_cap=t_cap)
    offs = stratified_offsets(1)
    cam_want = T.nearest_hit_camera_soa(acc, offs, width=64, height=64,
                                        spp=1, with_attrs=True)
    monkeypatch.setattr(T, "_merge_rest_nearest",
                        _in_place(T._merge_rest_nearest, 2))
    monkeypatch.setattr(T, "_merge_rest_camera",
                        _in_place(T._merge_rest_camera, 4))
    got = T.nearest_hit_attrs_soa(acc, p, t_cap=t_cap)
    cam_got = T.nearest_hit_camera_soa(acc, offs, width=64, height=64,
                                       spp=1, with_attrs=True)
    for a, b in zip(got + cam_got, want + cam_want):
        assert torch.equal(a, b)
    assert bool((want[1] >= acc.order.shape[0]).any())
