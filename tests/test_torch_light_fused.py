"""The area lights' glue off the card: where `area_light_term` does not run
csrc/light.cu's kernels, how its autograd wrapper of them differentiates,
and how their wrappers refuse what they cannot take.

The kernels (`kernels.light`) run on the kernel path with CUDA tensors;
tests/test_torch_gpu.py holds them to the plain functions bit for bit on
the card. Here, on the CPU: a frame with area lights never reaches a
kernel entry and `area_light.fused` reads 0; the gradient reaches the
lights' centre, radius and emission; with stand-ins for the two kernels
(the plain functions, written in place as the kernels write), a term that
requires grad goes through `_KernelLightSum` and has the plain term's
value and gradient (bit for bit but for the verts' order of summation);
and each wrapper raises ValueError on a wrong dtype, shape, layout or
device before it loads the library.
"""

import pytest
import torch

from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                  build_default_scene)
from raytracing_tpu_torch.geometry.mesh import Scene, SphereLight
from raytracing_tpu_torch.kernels import cuda
from raytracing_tpu_torch.kernels import light as LK
from raytracing_tpu_torch.models import whitted
from raytracing_tpu_torch.models.camera import (block_ray_ids,
                                                camera_rays_for_ids)
from raytracing_tpu_torch.utils import profiling as P

torch.set_num_threads(2)

CFG = RenderConfig(width=16, height=16, samples_per_pixel=1,
                   chunk_size=128, light_samples=3)


@pytest.fixture(scope="module")
def scene_accel():
    scene = build_default_scene(device="cpu")
    return scene, build_cluster_accel(scene.mesh, cluster_size=16)


def _lights(grad: bool = False) -> SphereLight:
    """Two lights: the benchmark's above the teapots and one in front of
    them, so the estimator sums over lights."""
    return SphereLight(*(torch.tensor(v, requires_grad=grad) for v in (
        [[1.0, 8.0, 7.0], [-2.0, 3.0, 1.0]], [1.5, 0.7],
        [[1.5, 1.5, 1.5], [0.4, 0.6, 0.9]])))


def _no_kernels(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a light kernel entry was reached")

    monkeypatch.setattr(LK, "light_sample", refuse)
    monkeypatch.setattr(LK, "light_fold", refuse)


@pytest.mark.parametrize("bin_secondary", [True, False])
def test_cpu_frame_takes_the_plain_path(scene_accel, monkeypatch,
                                        bin_secondary):
    """A CPU frame with two lights, three bounce levels (binned or not):
    no kernel entry is reached, `area_light.fused` is 0 beside the lights'
    rays, and the lights light the frame."""
    scene, accel = scene_accel
    lit = Scene(scene.mesh, scene.sun, _lights())
    cfg = CFG.replace(bin_secondary=bin_secondary, diffuse_depth=3,
                      diffuse_scatter=2, reflect_depth=3)

    def frame():
        return whitted.render(lit, cfg, accel=accel,
                              generator=torch.Generator().manual_seed(3))

    _no_kernels(monkeypatch)
    P.COUNTERS.reset()
    got = frame()
    counts = P.COUNTERS.read()
    assert counts["area_light.fused"] == 0 < counts["rays.area_light"]
    assert counts["launches.light_sample"] == counts["launches.light_fold"] == 0
    dark = whitted.render(Scene(scene.mesh, scene.sun, None), cfg,
                          accel=accel,
                          generator=torch.Generator().manual_seed(3))
    assert float((got - dark).abs().max()) > 1e-3


def test_fused_only_on_the_card(scene_accel):
    """`_fused_light` is False on CPU tensors, whatever the backend, and
    whether they require grad or not."""
    scene, accel = scene_accel
    o, d = camera_rays_for_ids(block_ray_ids(0, 64, CFG, device="cpu"), CFG)
    h, attrs = whitted.nearest_hit_shaded(scene.mesh, accel, o, d, CFG)
    sh = whitted.shade(scene.mesh, accel, scene.sun, o, d, h, CFG, attrs)
    for backend in ("auto", "cuda", "cluster", "bruteforce"):
        for pos in (sh.pos, sh.pos.clone().requires_grad_()):
            assert not whitted._fused_light(CFG.replace(backend=backend),
                                            pos)


def test_light_gradients_flow_through_the_term(scene_accel, monkeypatch):
    """With the lights' tables requiring grad, the term takes the plain
    functions, and a loss of the rendered rays differentiates into each
    light's centre, radius and emission: finite, and nonzero for every
    light that reaches a ray."""
    scene, accel = scene_accel
    _no_kernels(monkeypatch)
    lights = _lights(grad=True)
    o, d = camera_rays_for_ids(block_ray_ids(3, 256, CFG, device="cpu"), CFG)
    g = torch.Generator().manual_seed(1)
    rgb = whitted.render_rays(
        scene.mesh, accel, scene.sun, o, d, CFG.replace(reflect_depth=1,
                                                        diffuse_depth=1),
        lambda tag, shape: torch.rand(shape, generator=g), lights=lights)
    (rgb * rgb).sum().backward()
    for t in lights:
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert float(t.grad.abs().sum()) > 0


def _stand_in_sample(pos, n, hit, u, rows, lights, li):
    """`kernels.light.light_sample` on the CPU: the plain functions."""
    return whitted.light_shadow_rays(whitted.light_cone(lights, li, pos),
                                     pos, n, hit,
                                     u if rows is None else u[rows])


def _stand_in_fold(acc, total, alive, occluded, ndl, s, ns, li, lights,
                   pos, albedo_pi, color):
    """`kernels.light.light_fold` on the CPU: the plain estimator, written
    into acc and total in place as the kernel writes them."""
    v = torch.where(alive & ~occluded, torch.clamp_min(ndl, 0.0), 0.0)
    acc.copy_(v if s == 0 else acc + v)
    if s < ns - 1:
        return
    cone = whitted.light_cone(lights, li, pos)
    term = (acc / ns * cone.omega)[:, None] * lights.emission[li]
    total.copy_(term if li == 0 else total + term)
    if li == lights.center.shape[0] - 1:
        total.copy_(total * albedo_pi[:, None] * color)


@pytest.mark.parametrize("bin_secondary", [True, False])
def test_kernel_light_sum_differentiates_as_the_plain_term(
        scene_accel, monkeypatch, bin_secondary):
    """With the kernels' stand-ins in `kernels.light` and `_fused_light`
    True, a term whose mesh tables and lights require grad runs through
    `_KernelLightSum`: one stand-in call of each a sample, and the rays'
    radiance and the gradients to colors, materials and the lights' tables
    have the bits of the plain term's (`_fused_light` False). The verts'
    gradient is summed in another order (the term's share of the points'
    gradient arrives as one tensor), so it is held within 1e-6 of its
    largest entry."""
    scene, accel = scene_accel
    cfg = CFG.replace(bin_secondary=bin_secondary, reflect_depth=1,
                      diffuse_depth=2, diffuse_scatter=2)
    o, d = camera_rays_for_ids(block_ray_ids(3, 256, cfg, device="cpu"), cfg)
    calls = {"sample": 0, "fold": 0}

    def sample(*a):
        calls["sample"] += 1
        return _stand_in_sample(*a)

    def fold(*a):
        calls["fold"] += 1
        return _stand_in_fold(*a)

    monkeypatch.setattr(LK, "light_sample", sample)
    monkeypatch.setattr(LK, "light_fold", fold)

    def run(fused):
        monkeypatch.setattr(whitted, "_fused_light", lambda *a: fused)
        g = torch.Generator().manual_seed(1)
        live = {k: getattr(scene.mesh, k).clone().requires_grad_()
                for k in ("verts", "colors", "materials")}
        lights = _lights(grad=True)
        P.COUNTERS.reset()
        rgb = whitted.render_rays(
            scene.mesh._replace(**live), accel, scene.sun, o, d, cfg,
            lambda tag, shape: torch.rand(shape, generator=g),
            lights=lights)
        fused_rays = P.COUNTERS.read()["area_light.fused"]
        (rgb * rgb).sum().backward()
        return rgb.detach(), fused_rays, [
            *(t.grad for t in live.values()), *(t.grad for t in lights)]

    rgb, fused_rays, grads = run(True)
    assert calls["sample"] == calls["fold"] > 0 and fused_rays > 0
    want, plain_rays, want_grads = run(False)
    assert calls["sample"] == calls["fold"] and plain_rays == 0
    assert torch.equal(rgb, want)
    verts, ref = grads[0], want_grads[0]
    assert float((verts - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    for got, ref in zip(grads[1:], want_grads[1:]):
        assert got is not None and torch.equal(got, ref)
    assert all(float(g.abs().sum()) > 0 for g in grads)


def _sample_args(n=8):
    """Arguments of `light_sample` that are right but for the device."""
    return dict(pos=torch.zeros(n, 3), n=torch.zeros(n, 3),
                hit=torch.zeros(n, dtype=torch.bool), u=torch.zeros(n, 2),
                rows=torch.arange(n), lights=_lights(), li=0)


def _fold_args(n=8):
    return dict(acc=torch.zeros(n), total=torch.zeros(n, 3),
                alive=torch.zeros(n, dtype=torch.bool),
                occluded=torch.zeros(n, dtype=torch.bool),
                ndl=torch.zeros(n), s=0, ns=4, li=0, lights=_lights(),
                pos=torch.zeros(n, 3), albedo_pi=torch.zeros(n),
                color=torch.zeros(n, 3))


SAMPLE_FAULTS = {
    "pos f64": lambda a: a.update(pos=a["pos"].double()),
    "n [N, 4]": lambda a: a.update(n=torch.zeros(8, 4)),
    "hit f32": lambda a: a.update(hit=a["hit"].float()),
    "hit strided": lambda a: a.update(
        hit=torch.zeros(16, dtype=torch.bool)[::2]),
    "u [N, 3]": lambda a: a.update(u=torch.zeros(8, 3)),
    "u short": lambda a: a.update(u=torch.zeros(4, 2)),
    "rows i32": lambda a: a.update(rows=a["rows"].int()),
    "light 2 of 2": lambda a: a.update(li=2),
    "radius [L, 1]": lambda a: a.update(
        lights=a["lights"]._replace(radius=torch.ones(2, 1))),
    "center strided": lambda a: a.update(
        lights=a["lights"]._replace(center=torch.zeros(3, 2).T)),
    "cpu": lambda a: None,
}

FOLD_FAULTS = {
    "acc strided": lambda a: a.update(acc=torch.zeros(16)[::2]),
    "total [N]": lambda a: a.update(total=torch.zeros(8)),
    "occluded u8": lambda a: a.update(
        occluded=torch.zeros(8, dtype=torch.uint8)),
    "ndl short": lambda a: a.update(ndl=torch.zeros(7)),
    "albedo [N, 1]": lambda a: a.update(albedo_pi=torch.zeros(8, 1)),
    "color f16": lambda a: a.update(color=a["color"].half()),
    "sample 4 of 4": lambda a: a.update(s=4),
    "emission [L]": lambda a: a.update(
        lights=a["lights"]._replace(emission=torch.ones(2))),
    "cpu": lambda a: None,
}


@pytest.mark.parametrize("entry, fault", [
    *(("light_sample", k) for k in SAMPLE_FAULTS),
    *(("light_fold", k) for k in FOLD_FAULTS)])
def test_wrappers_refuse_before_a_launch(monkeypatch, entry, fault):
    """Each fault (and CPU tensors, right in every other way) raises
    ValueError before the library is loaded, and counts no launch."""
    def no_library():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(cuda, "library", no_library)
    args = _sample_args() if entry == "light_sample" else _fold_args()
    (SAMPLE_FAULTS if entry == "light_sample" else FOLD_FAULTS)[fault](args)
    before = dict(LK.LAUNCHES)
    with pytest.raises(ValueError, match="light kernels"):
        getattr(LK, entry)(**args)
    assert LK.LAUNCHES == before
