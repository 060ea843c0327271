"""The port's inverse fit on the CPU against the JAX package's: the pose
transform, the camera rays, the accel's refit, Adam against optax.adam,
one whole fit step against JAX's `value_and_grad` + optax step on the same
rays and uniforms, checkpoints, and a fit that recovers a color.

Bars: rays and refit planes bit-equal; the rotation and the pose at rtol
1e-6 (+ atol 1e-7: XLA contracts a*b+c, the port does not); Adam's
moments at rtol 1e-6 and each step's update at 2e-5 of its size (optax
rounds its bias correction in f32, torch in float64); the fit step's loss and parameters at rtol 1e-4
+ atol 1e-6 (the renderer's gradients meet JAX's at rtol 2e-4,
tests/test_torch_grad.py, and one step of lr 1e-2 moves a parameter by at
most about 1e-2); checkpoints bit for bit."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracing_tpu.accel import packets as JP
from raytracing_tpu.config import RenderConfig as JaxConfig
from raytracing_tpu.geometry import transform as JX
from raytracing_tpu.geometry.mesh import concat_objects as jax_concat
from raytracing_tpu.geometry.scene import build_default_scene as jax_scene
from raytracing_tpu.models import camera as JC
from raytracing_tpu.models import inverse as JI
from raytracing_tpu.models.whitted import render_rays as jax_render_rays

from raytracing_tpu_torch import RenderConfig
from raytracing_tpu_torch.accel.packets import (accel_from_numpy,
                                                build_cluster_accel,
                                                refit_attr_planes)
from raytracing_tpu_torch.geometry import transform as TX
from raytracing_tpu_torch.geometry.mesh import (Mesh, Scene, concat_objects,
                                                scene_from_numpy)
from raytracing_tpu_torch.models import camera as TC
from raytracing_tpu_torch.models import inverse
from raytracing_tpu_torch.models.whitted import render
from raytracing_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)


def _np(x):
    return np.asarray(x)


def test_rotation_matrix():
    """tests/test_models.py:106, and JAX's matrix and its gradient on
    random axis-angles (one below the 1e-5 blend)."""
    r = TX.rotation_matrix(torch.tensor([0.0, 0.0, np.pi / 2]))
    np.testing.assert_allclose(r.numpy() @ np.array([1.0, 0, 0]), [0, 1, 0],
                               atol=1e-6)
    np.testing.assert_allclose(TX.rotation_matrix(torch.zeros(3)).numpy(),
                               np.eye(3), atol=1e-7)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 3)).astype(np.float32)
    for aa in list(rng.standard_normal((4, 3)).astype(np.float32)) + [
            np.array([3e-6, -2e-6, 1e-6], np.float32)]:
        x = torch.from_numpy(aa).requires_grad_()
        r = TX.rotation_matrix(x)
        (r * torch.from_numpy(w)).sum().backward()
        want = JX.rotation_matrix(jnp.asarray(aa))
        g = jax.grad(lambda a: jnp.sum(JX.rotation_matrix(a) * w))(
            jnp.asarray(aa))
        np.testing.assert_allclose(r.detach().numpy(), _np(want), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(x.grad.numpy(), _np(g), rtol=1e-6,
                                   atol=1e-7)


def _two_triangles():
    a = {"verts": np.eye(3, dtype=np.float32),
         "tri_v": np.array([[0, 1, 2]], dtype=np.int32),
         "colors": np.ones(3, dtype=np.float32),
         "material": (1.0, 0.0, 1.0)}
    b = dict(a, verts=np.eye(3, dtype=np.float32) + 5.0)
    return [a, b]


def test_apply_pose_moves_only_target_object():
    """tests/test_models.py:114, and JAX's vertices and pose gradient for
    a pose that rotates too."""
    mesh = concat_objects(_two_triangles())
    moved = TX.apply_pose(mesh, torch.tensor([0.0, 0, 0, 1.0, 2.0, 3.0]),
                          obj_index=1)
    np.testing.assert_array_equal(moved.verts[:3].numpy(),
                                  mesh.verts[:3].numpy())
    np.testing.assert_allclose(moved.verts[3:].numpy(),
                               mesh.verts[3:].numpy() + [1.0, 2.0, 3.0],
                               atol=1e-6)
    jm = jax_concat(_two_triangles())
    pose = np.array([0.3, -0.2, 0.1, 1.0, 2.0, 3.0], np.float32)
    w = np.random.default_rng(1).standard_normal((6, 3)).astype(np.float32)
    p = torch.from_numpy(pose).requires_grad_()
    got = TX.apply_pose(mesh, p, obj_index=1).verts
    (got * torch.from_numpy(w)).sum().backward()
    want = JX.apply_pose(jm, jnp.asarray(pose), 1).verts
    g = jax.grad(lambda q: jnp.sum(JX.apply_pose(jm, q, 1).verts * w))(
        jnp.asarray(pose))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), _np(g), rtol=1e-5, atol=1e-6)


def test_camera_rays_bit_equal_to_jax():
    cfg = dict(width=16, height=8, samples_per_pixel=3, scale=0.9)
    o, d = TC.camera_rays(RenderConfig(**cfg), device="cpu")
    jo, jd = JC.camera_rays(JaxConfig(**cfg))
    assert d.shape == (3, 8, 16, 3)
    np.testing.assert_array_equal(o.numpy(), _np(jo))
    np.testing.assert_array_equal(d.numpy(), _np(jd))


@pytest.mark.parametrize("mode", ["objid", "full"])
def test_refit_attr_planes_bit_equal_to_jax(mode):
    """New normals, colors and materials reach the shading planes (and,
    in objid mode, the object table) exactly as JAX's refit puts them."""
    js = jax_scene(t=0.0)
    mesh = js.mesh
    rng = np.random.default_rng(2)
    if mode == "full":
        mesh = mesh._replace(colors=jnp.asarray(rng.uniform(
            size=mesh.colors.shape).astype(np.float32)))
    ja = JP.build_cluster_accel(mesh, cluster_size=16)
    ta = accel_from_numpy({k: (None if v is None else _np(v))
                           for k, v in ja._asdict().items()}, device="cpu")
    new = {k: (rng.uniform(size=getattr(mesh, k).shape) * 0.9)
           .astype(np.float32) for k in ("normals", "colors", "materials")}
    want = JP.refit_attr_planes(
        ja, mesh._replace(**{k: jnp.asarray(v) for k, v in new.items()}))
    tm = Mesh(*(torch.from_numpy(np.ascontiguousarray(_np(v)))
                for v in mesh))
    got = refit_attr_planes(ta, tm._replace(
        **{k: torch.from_numpy(v) for k, v in new.items()}))
    assert (got.attr_tables is None) == (mode == "full")
    for name in ("attr_blocks", "attr_tables", "rest_attrs"):
        w = getattr(want, name)
        if w is None:
            assert getattr(got, name) is None
            continue
        np.testing.assert_array_equal(getattr(got, name).numpy(), _np(w),
                                      err_msg=name)
    for name in ("pmt_blocks", "grad_blocks", "cluster_min"):
        assert getattr(got, name) is getattr(ta, name)


def test_adam_matches_optax():
    """torch.optim.Adam (the fit's default) against optax.adam on the same
    gradients over 5 steps, each from the same parameters and moments:
    the moments at rtol 1e-6, the update at 2e-5 of its size."""
    rng = np.random.default_rng(3)
    p0 = {"a": rng.standard_normal((7, 3)).astype(np.float32),
          "b": rng.uniform(size=(2, 3)).astype(np.float32)}
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in p0.items()}
    opt = torch.optim.Adam(list(tp.values()), lr=1e-2)
    jopt = optax.adam(1e-2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = jopt.init(jp)
    for _ in range(5):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in p0.items()}
        before = {k: _np(v) for k, v in jp.items()}
        for k, v in tp.items():
            v.grad = torch.from_numpy(grads[k])
        opt.step()
        updates, state = jopt.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k in p0:
            # The moments (b m + (1 - b) g, where torch lerps; a sum that
            # cancels is held to 1e-6 of the table's largest entry).
            mine = opt.state[tp[k]]
            for name, theirs in (("exp_avg", state[0].mu[k]),
                                 ("exp_avg_sq", state[0].nu[k])):
                theirs = _np(theirs)
                np.testing.assert_allclose(
                    mine[name].numpy(), theirs, rtol=1e-6,
                    atol=1e-6 * float(np.abs(theirs).max()), err_msg=k)
                mine[name].copy_(torch.from_numpy(theirs.copy()))
            # optax rounds the bias correction 1 - b2^t in f32 (1.3e-5
            # off at t = 1), torch in float64: the updates differ by up to
            # 9.9e-6 of their size (measured over these 5 steps), so 2e-5
            # of it; and the parameter is rounded once (torch) or twice
            # (optax: the update, then the sum), so one f32 spacing of it
            # besides.
            got, want = tp[k].detach().numpy(), _np(jp[k])
            step = np.abs(_np(updates[k]).astype(np.float64))
            slack = 2e-5 * step + np.spacing(
                np.maximum(np.abs(before[k]), np.abs(want)))
            assert (np.abs(got - want) <= slack).all(), k
            # The next step starts from the same parameters and moments.
            tp[k].data.copy_(torch.from_numpy(want.copy()))


def _fit_objects():
    """test_grad's triangle in front of tests/test_models.py's diffuse
    floor (below the camera), two objects of their own colors."""
    tri = {"verts": np.array([[-2.0, -2.0, 5.0], [3.0, -2.0, 5.0],
                              [-2.0, 3.0, 5.0]], np.float32),
           "tri_v": np.array([[0, 2, 1]], np.int32),
           "colors": np.array([0.8, 0.6, 0.4], np.float32),
           "material": (1.0, 0.3, 0.5)}
    floor = {"verts": np.array([[-50, -2, -50], [-50, -2, 50], [50, -2, 50],
                                [50, -2, -50]], np.float32),
             "tri_v": np.array([[0, 1, 2], [0, 2, 3]], np.int32),
             "normals": np.array([[0, 1, 0], [0, 1, 0]], np.float32),
             "colors": np.array([0.6, 0.7, 0.8], np.float32),
             "material": (1.0, 0.0, 0.9)}
    return [tri, floor]


def test_fit_step_matches_jax():
    """One step of the port's fit (`Fitter.step`) with given ray indices
    and JAX's uniforms against JAX's fit step written out
    (`inverse.fit`'s loss_fn: apply_params, refit_attr_planes,
    render_rays, value_and_grad, optax.adam): the loss, and every
    parameter after the step."""
    jm = jax_concat(_fit_objects())
    sun = jnp.array([200.0, 300.0, -1000.0])
    cfg = dict(width=8, height=8, samples_per_pixel=2, reflect_depth=1,
               diffuse_depth=1)
    jcfg = JaxConfig(backend="pallas", **cfg)
    ja = JP.build_cluster_accel(jm, cluster_size=8)
    arrays = {k: _np(v) for k, v in jm._asdict().items()}
    arrays["sun"] = _np(sun)
    ts = scene_from_numpy(arrays, device="cpu")
    ta = accel_from_numpy({k: (None if v is None else _np(v))
                           for k, v in ja._asdict().items()}, device="cpu")
    rng = np.random.default_rng(4)
    target = rng.uniform(size=(8, 8, 3)).astype(np.float32)
    p0 = {"colors": _np(jm.colors) * 0.5, "materials": _np(jm.materials),
          "verts": _np(jm.verts)}
    idx = rng.integers(0, 2 * 8 * 8, 48)
    key = jax.random.PRNGKey(9)

    o_all, d_all = JC.camera_rays(jcfg)
    o_all, d_all = o_all.reshape(-1, 3), d_all.reshape(-1, 3)
    tgt = jnp.asarray(target).reshape(-1, 3)[idx % 64]
    first_tri = JP.first_tri_per_object(_np(jm.obj_id),
                                        ja.attr_tables.shape[0])

    def loss_fn(p):
        mesh = JI.apply_params(jm, p)
        acc = JP.refit_attr_planes(ja, mesh, first_tri)
        rgb = jax_render_rays(mesh, acc, sun, o_all[idx], d_all[idx], key,
                              jcfg)
        return jnp.mean((rgb - tgt) ** 2)

    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jopt = optax.adam(1e-2)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    updates, _ = jopt.update(grads, jopt.init(jp), jp)
    want = optax.apply_updates(jp, updates)

    def uniforms(tag, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, tag), shape, dtype=jnp.float32)))

    fitter = inverse.Fitter(ts, torch.from_numpy(target),
                            {k: torch.from_numpy(v) for k, v in p0.items()},
                            RenderConfig(**cfg), accel=ta,
                            learning_rate=1e-2)
    got = fitter.step(torch.from_numpy(idx), uniforms)
    np.testing.assert_allclose(got, float(loss), rtol=1e-4, atol=1e-6)
    moved = 0
    for k in p0:
        w = _np(want[k])
        np.testing.assert_allclose(fitter.params[k].detach().numpy(), w,
                                   rtol=1e-4, atol=1e-6, err_msg=k)
        moved += int((w != p0[k]).sum())
    assert moved > 10  # the step moved colors, materials and vertices


def _floor_scene():
    """tests/test_models.py:138's diffuse floor, below the camera."""
    floor = _fit_objects()[1]
    return Scene(mesh=concat_objects([floor]),
                 sun=torch.tensor([0.0, 1000.0, 0.0]))


def test_inverse_fit_recovers_color():
    """tests/test_models.py:138 on a CS 8 accel: from colors x 0.3 the fit
    brings the loss under a quarter of its start and recovers the visible
    triangle's color."""
    scene = _floor_scene()
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1,
                       chunk_size=64, diffuse_depth=1)
    accel = build_cluster_accel(scene.mesh, cluster_size=8)
    target = render(scene, cfg, accel=accel,
                    generator=torch.Generator().manual_seed(0))
    res = inverse.fit(scene, target, {"colors": scene.mesh.colors * 0.3},
                      cfg, accel=accel, steps=48, rays_per_step=64,
                      learning_rate=8e-2)
    assert res.losses[-1] < res.losses[0] * 0.25, res.losses[::10]
    got, want = res.params["colors"].numpy(), scene.mesh.colors.numpy()
    assert (np.abs(got - want).max(axis=1) < 0.05).any(), (got, want)


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_utils_app.py:17 with a torch Adam state: params, the
    optimizer's state and the step come back bit for bit, and the state
    loads into a fresh optimizer."""
    params = {"verts": torch.ones((5, 3)), "colors": torch.zeros((2, 3))}
    ps = [v.clone().requires_grad_() for v in params.values()]
    opt = torch.optim.Adam(ps, lr=1e-2)
    for p in ps:
        p.grad = torch.full_like(p, 0.5)
    opt.step()
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, params, opt.state_dict(), step=7, metadata={"note": "x"})
    p2, s2, step, meta = ckpt.load(path, params, opt.state_dict())
    assert step == 7 and meta["note"] == "x"
    for k in params:
        assert torch.equal(p2[k], params[k])
    s0 = opt.state_dict()
    assert s2["param_groups"] == s0["param_groups"]
    for i, st in s0["state"].items():
        for name, v in st.items():
            assert torch.equal(s2["state"][i][name], v), (i, name)
    fresh = torch.optim.Adam([p.detach().clone() for p in ps], lr=1e-2)
    fresh.load_state_dict(s2)


def test_checkpoint_shape_mismatch(tmp_path):
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, {"v": torch.ones(3)})
    with pytest.raises(ValueError):
        ckpt.load(path, {"v": torch.ones(4)})


def test_fit_checkpoints_every_k_steps(tmp_path):
    """checkpoint_every=k writes (params, Adam state, step) every k steps;
    the last snapshot is the result bit for bit, and resuming from it
    continues the descent."""
    scene = _floor_scene()
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1,
                       diffuse_depth=1)
    accel = build_cluster_accel(scene.mesh, cluster_size=8)
    target = torch.full((8, 8, 3), 0.5)
    path = str(tmp_path / "fit.npz")
    params = {"colors": scene.mesh.colors * 0.3}
    res = inverse.fit(scene, target, params, cfg, accel=accel, steps=4,
                      rays_per_step=32, checkpoint_path=path,
                      checkpoint_every=2)
    p2, s2, step, _ = ckpt.load(path, res.params, res.opt_state)
    assert step == 4
    assert torch.equal(p2["colors"], res.params["colors"])
    for i, st in res.opt_state["state"].items():
        for name, v in st.items():
            assert torch.equal(s2["state"][i][name], v), name
    more = inverse.fit(scene, target, p2, cfg, accel=accel, steps=2,
                       rays_per_step=32, opt_state=s2)
    assert float(more.opt_state["state"][0]["step"]) == 6


def test_fit_rebuilds_the_accel_every_k_steps(monkeypatch):
    calls = []
    real = inverse.build_cluster_accel
    monkeypatch.setattr(inverse, "build_cluster_accel",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    scene = _floor_scene()
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1,
                       diffuse_depth=1)
    accel = build_cluster_accel(scene.mesh, cluster_size=8)
    inverse.fit(scene, torch.full((8, 8, 3), 0.5),
                {"verts": scene.mesh.verts}, cfg, accel=accel, steps=5,
                rays_per_step=16, rebuild_every=2)
    assert len(calls) == 2  # before steps 2 and 4


def test_fit_refuses_retries():
    """A negative retry count is refused; retries > 0 runs every step
    under the Supervisor (utils/resilience.py is ported) and, with no
    fault, descends exactly as a fit without retries."""
    scene = _floor_scene()
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1,
                       diffuse_depth=1)
    with pytest.raises(ValueError, match="retries"):
        inverse.fit(scene, torch.zeros((8, 8, 3)),
                    {"colors": scene.mesh.colors}, cfg, steps=1, retries=-1)
    accel = build_cluster_accel(scene.mesh, cluster_size=8)
    runs = [inverse.fit(scene, torch.full((8, 8, 3), 0.5),
                        {"colors": scene.mesh.colors * 0.3}, cfg,
                        accel=accel, steps=2, rays_per_step=16,
                        retries=retries)
            for retries in (0, 2)]
    assert runs[0].losses == runs[1].losses
    assert torch.equal(runs[0].params["colors"], runs[1].params["colors"])
