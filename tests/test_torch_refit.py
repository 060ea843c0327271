"""The accel's geometry refit (`accel.packets.refit_geometry`) and the
inverse fit that takes it (`Fitter`, whenever it fits verts or pose), on the
CPU through the port's plain kernel versions.

Bars: at the vertices the accel was built from, every table the refit
recomputes equals the build's bit for bit, with the host library's build
and with its numpy fallback; after a pose and a vertex jitter, the refit
accel's nearest hits and shadow answers on seeded rays equal brute
force's and a fresh build's, up to ties (a ray whose triangles differ
must hit both at the same t within 1e-5 of it), while the stale accel's
differ on many rays (the control); a pose fit of a wall under a sun just
in front of it lowers its loss with the refit and leaves it flat
without, since the stale fit walks the start geometry at every step."""

import numpy as np
import pytest
import torch

from raytracing_tpu_torch import RenderConfig, build_cluster_accel
from raytracing_tpu_torch.accel.packets import refit_geometry
from raytracing_tpu_torch.geometry import native
from raytracing_tpu_torch.geometry.mesh import (Scene, concat_objects,
                                                triangle_soa)
from raytracing_tpu_torch.geometry.scene import build_default_scene
from raytracing_tpu_torch.geometry.transform import apply_pose
from raytracing_tpu_torch.kernels import traverse as T
from raytracing_tpu_torch.models import inverse
from raytracing_tpu_torch.models.camera import camera_rays_for_ids
from raytracing_tpu_torch.models.whitted import render
from raytracing_tpu_torch.ops.trace import any_hit_brute, nearest_hit_brute
from raytracing_tpu_torch.utils import profiling as P

torch.set_num_threads(2)

# Tables the refit recomputes; the rest must come back as the same tensors.
GEOMETRY = ("cluster_min", "cluster_max", "pmt_blocks", "grad_blocks",
            "rest_blocks", "rest_grad", "tri_blocks", "pmt_t_blocks")


@pytest.fixture(scope="module")
def scene():
    return build_default_scene(device="cpu")


def _moved(mesh, seed=4):
    """The mesh with object 0 posed and every vertex jittered."""
    g = torch.Generator().manual_seed(seed)
    pose = torch.tensor([0.02, -0.05, 0.03, 0.08, -0.04, 0.06])
    mesh = apply_pose(mesh, pose, 0)
    jitter = (torch.rand(mesh.verts.shape, generator=g) - 0.5) * 0.01
    return mesh._replace(verts=mesh.verts + jitter)


@pytest.mark.parametrize("host", ["native", "numpy"])
@pytest.mark.parametrize("cs,variants", [(16, "auto"), (128, ("pmt",))])
def test_refit_at_unchanged_vertices_is_the_build(scene, monkeypatch, host,
                                                  cs, variants):
    if host == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("the host library is not built")
    acc = build_cluster_accel(scene.mesh, cluster_size=cs, variants=variants)
    P.COUNTERS.reset()
    got = refit_geometry(acc, scene.mesh)
    n_rest = 0 if acc.rest_ids is None else acc.rest_ids.shape[0]
    assert P.COUNTERS.host["refit.slots"] == acc.order.shape[0] + n_rest
    for name in acc._fields:
        want, have = getattr(acc, name), getattr(got, name)
        if name == "woop_blocks":
            assert have is None
        elif want is None:
            assert have is None, name
        elif name in GEOMETRY:
            assert have.dtype == want.dtype and torch.equal(have, want), name
        else:
            assert have is want, name


def _rays(n=2048, seed=9):
    """Camera rays of a 64x64 frame and rays from inside the scene in
    random directions."""
    g = torch.Generator().manual_seed(seed)
    cfg = RenderConfig(width=64, height=64, samples_per_pixel=1)
    o1, d1 = camera_rays_for_ids(torch.randint(0, 64 * 64, (n,), generator=g),
                                 cfg)
    o2 = torch.tensor([1.0, -1.2, 7.5]) + torch.randn(n, 3, generator=g) \
        * torch.tensor([2.0, 0.6, 1.5])
    d2 = torch.randn(n, 3, generator=g)
    return torch.cat([o1, o2]), torch.cat([d1, d2])


def _same_up_to_ties(t, tri, t_ref, tri_ref):
    """Hits equal, and a ray whose triangle differs hits both at one t."""
    assert torch.equal(torch.isfinite(t), torch.isfinite(t_ref))
    hit = torch.isfinite(t)
    other = hit & (tri != tri_ref)
    assert int(other.sum()) <= 2
    gap = (t - t_ref).abs()
    assert bool((gap[hit] <= 1e-5 * t_ref[hit].abs().clamp_min(1.0)).all())


def test_refit_follows_moved_geometry(scene):
    acc = build_cluster_accel(scene.mesh, cluster_size=16)
    moved = _moved(scene.mesh)
    refit = refit_geometry(acc, moved)
    fresh = build_cluster_accel(moved, cluster_size=16)
    o, d = _rays()
    rays8 = T.rays_to_soa(o, d)
    brute = nearest_hit_brute(triangle_soa(moved.verts, moved.tri_v), o, d,
                              1e-8)
    t_ref = torch.where(brute.hit, brute.t, torch.inf)
    for acc_k in (refit, fresh):
        t, tri = T.nearest_hit_soa(acc_k, rays8)
        _same_up_to_ties(t, tri, t_ref, brute.tri)
    # Shadow rays toward a point above the scene, stopped short of it.
    target = torch.tensor([0.5, 6.0, 7.0])
    sd = target - o
    occ_ref = any_hit_brute(triangle_soa(moved.verts, moved.tri_v), o, sd,
                            0.999, 1e-8)
    occ = T.any_hit_soa(refit, T.rays_to_soa(o, sd), t_max=0.999)
    assert int((occ != occ_ref).sum()) <= 2
    assert 0.05 < float(occ_ref.float().mean()) < 0.95
    # The control: the stale accel walks the start geometry.
    t_old, tri_old = T.nearest_hit_soa(acc, rays8)
    changed = (torch.isfinite(t_old) != brute.hit) | (
        brute.hit & (tri_old != brute.tri))
    assert int(changed.sum()) > 50
    occ_old = T.any_hit_soa(acc, T.rays_to_soa(o, sd), t_max=0.999)
    assert int((occ_old != occ_ref).sum()) > 10


def test_refit_keeps_no_woop_table(scene):
    acc = build_cluster_accel(scene.mesh, cluster_size=16)
    refit = refit_geometry(acc, _moved(scene.mesh))
    o, d = _rays(256)
    with pytest.raises(ValueError, match="woop"):
        T.nearest_hit_soa(refit, T.rays_to_soa(o, d), variant="woop")
    base = T.nearest_hit_soa(refit, T.rays_to_soa(o, d))
    for variant in ("mt", "pmtt"):
        got = T.nearest_hit_soa(refit, T.rays_to_soa(o, d), variant=variant)
        assert torch.equal(got[1], base[1]), variant


def _lit_scene():
    """A wall facing the camera under a sun one unit in front of it: the
    sun's direction changes across the wall, so the shading follows its
    position."""
    wall = {"verts": np.array([[-6, -6, 5], [6, -6, 5], [6, 6, 5],
                               [-6, 6, 5]], np.float32),
            "tri_v": np.array([[0, 2, 1], [0, 3, 2]], np.int32),
            "colors": np.array([0.9, 0.6, 0.3], np.float32),
            "material": (1.0, 0.0, 0.0)}
    return Scene(concat_objects([wall]), torch.tensor([0.5, 0.3, 2.0]))


def test_pose_fit_descends_with_the_refit_and_stays_flat_without(
        monkeypatch):
    """The stale fit (the refit taken out) renders the build's geometry,
    the target's, at every step: its loss stays where it starts whatever
    the pose. A fit of colors alone refits no geometry."""
    scene = _lit_scene()
    cfg = RenderConfig(width=24, height=24, samples_per_pixel=1,
                       reflect_depth=1, diffuse_depth=1, chunk_size=576)
    acc = build_cluster_accel(scene.mesh, cluster_size=4)
    target = render(scene, cfg, accel=acc)
    start = {"pose": torch.tensor([0.0, 0.0, 0.0, 0.1, -0.1, 0.3])}
    idx = torch.arange(24 * 24)
    losses = {}
    for refit in (True, False):
        with monkeypatch.context() as m:
            if not refit:
                m.setattr(inverse, "refit_geometry", lambda acc, mesh: acc)
            f = inverse.Fitter(scene, target, start, cfg, accel=acc,
                               learning_rate=2e-2)
            assert f.refits_geometry
            losses[refit] = [
                f.step(idx, lambda tag, shape: torch.zeros(shape))
                for _ in range(12)]
    assert losses[True][-1] < 0.3 * losses[True][0], losses[True]
    assert len(set(losses[False])) == 1, losses[False]
    colors = inverse.Fitter(scene, target, {"colors": scene.mesh.colors},
                            cfg, accel=acc)
    assert not colors.refits_geometry
