"""Inverse rendering: fit scene parameters to a target image by gradient
descent through the renderer (twin of `raytracing_tpu.models.inverse`).

Parameters live in a flat dict, any subset of:
  "verts"     [V, 3]  vertex positions
  "normals"   [T, 3]  stored face normals
  "colors"    [T, 3]  per-triangle albedo colors
  "materials" [O, 3]  (albedo/π, reflectivity, roughness)
  "pose"      [6]     axis-angle + translation applied to `pose_obj`'s verts

A step draws a batch of the frame's primary rays, renders them with the
current parameters (`whitted.render_rays`, whose nearest queries are
differentiable walks), and takes one step of Adam (the JAX package's
optax.adam) on the mean squared error against the target's pixels. Which
triangle a ray hits stays detached, so the descent follows the shading and
intersection gradients.

A geometry fit (verts or pose) with an accel refits it inside every
step: before the shading planes are refit, `accel.packets.refit_geometry`
recomputes the accel's geometry tables (bounds, triangle blocks and the
backward's corners) from the step's live vertices on their device, in
the build's cluster order, so the forward walks and the backward
differentiates the geometry being fitted. This departs from the JAX
package's fit, which walks the tables of its last build; at the
vertices an accel was built from the refit is the build bit for bit, so
a step from there is the JAX package's. `rebuild_every` still re-sorts
(a host SAH build and upload); the refit follows the vertices between
rebuilds.

Spans (`utils.profiling`): `rt.fit` around a step, `rt.backward` around
its `loss.backward()` (autograd's own thread runs the backward functions,
each in `rt.grad`), `rt.optim` around Adam's update, and `rt.refit`
around the geometry refit; `fit.steps` counts the steps.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Optional

import torch

from raytracing_tpu_torch.accel.packets import (ClusterAccel,
                                                build_cluster_accel,
                                                first_tri_per_object,
                                                refit_attr_planes,
                                                refit_geometry)
from raytracing_tpu_torch.config import RenderConfig
from raytracing_tpu_torch.geometry.mesh import Mesh, Scene
from raytracing_tpu_torch.geometry.transform import apply_pose
from raytracing_tpu_torch.models.camera import camera_rays
from raytracing_tpu_torch.models.whitted import default_accel, render_rays
from raytracing_tpu_torch.utils.profiling import COUNTERS, span

# Parameters whose change the accel's shading planes must follow (the JAX
# package's set).
_REFIT_PARAMS = {"colors", "materials", "verts", "pose"}
_GEOMETRY_PARAMS = {"verts", "pose"}


def apply_params(mesh: Mesh, params: Dict[str, torch.Tensor],
                 pose_obj: int = 0) -> Mesh:
    """The mesh with the parameters in place of its own tables, and the
    pose applied to object pose_obj's vertices."""
    mesh = mesh._replace(**{k: v for k, v in params.items() if k != "pose"})
    if "pose" in params:
        mesh = apply_pose(mesh, params["pose"], pose_obj)
    return mesh


@dataclasses.dataclass
class FitResult:
    params: Dict[str, torch.Tensor]
    losses: list
    opt_state: Optional[dict] = None  # the optimizer's state_dict()


class Fitter:
    """One inverse fit's state and its step, callable with given ray
    indices and uniforms (`step`), so that a step can be held against the
    JAX package's.

    params are copied into leaf tensors that require grad, which
    `torch.optim.Adam` at learning_rate descends (optax.adam's update);
    opt_state: an Adam state_dict to resume from. accel defaults to
    `build_cluster_accel(scene.mesh)`, except under config.backend
    "bruteforce", which renders without one (as the JAX package's fit
    does when given none); an accel's shading planes are refit from the
    live parameters inside every step, and where verts or pose are
    fitted its geometry tables too, first (module docstring). Any
    backend of `RenderConfig` runs."""

    def __init__(self, scene: Scene, target: torch.Tensor,
                 params: Dict[str, torch.Tensor], config: RenderConfig,
                 accel: Optional[ClusterAccel] = None,
                 learning_rate: float = 1e-2, pose_obj: int = 0,
                 opt_state: Optional[dict] = None):
        self.scene, self.config, self.pose_obj = scene, config, pose_obj
        self.params = {k: v.detach().clone().requires_grad_()
                       for k, v in params.items()}
        self.optimizer = torch.optim.Adam(list(self.params.values()),
                                          lr=learning_rate)
        if opt_state is not None:
            self.optimizer.load_state_dict(opt_state)
        self.accel = accel = default_accel(scene.mesh, config, accel)
        self.refits = accel is not None and bool(_REFIT_PARAMS & set(params))
        self.refits_geometry = (accel is not None
                                and bool(_GEOMETRY_PARAMS & set(params)))
        self.first_tri = None
        if self.refits and self.accel.attr_tables is not None:
            self.first_tri = first_tri_per_object(
                scene.mesh.obj_id.cpu().numpy(),
                self.accel.attr_tables.shape[0])
        o, d = camera_rays(config, device=scene.mesh.verts.device)
        self.o, self.d = o.reshape(-1, 3), d.reshape(-1, 3)
        # The samples of one pixel share its target.
        self.target = target.reshape(-1, 3)
        self.pixels = config.height * config.width

    @property
    def n_rays(self) -> int:
        return self.o.shape[0]

    def loss(self, idx: torch.Tensor, uniforms) -> torch.Tensor:
        """Mean squared error of rays idx rendered with the current
        parameters; uniforms(tag, shape) as `render_rays` takes them."""
        mesh = apply_params(self.scene.mesh, self.params, self.pose_obj)
        acc = (refit_geometry(self.accel, mesh) if self.refits_geometry
               else self.accel)
        if self.refits:
            acc = refit_attr_planes(acc, mesh, self.first_tri)
        rgb = render_rays(mesh, acc, self.scene.sun, self.o[idx],
                          self.d[idx], self.config, uniforms)
        return ((rgb - self.target[idx % self.pixels]) ** 2).mean()

    def step(self, idx: torch.Tensor, uniforms) -> float:
        """One optimizer step on rays idx; returns the loss before it."""
        COUNTERS.add("fit.steps")
        with span("rt.fit", rays=idx.shape[0]):
            self.optimizer.zero_grad(set_to_none=True)
            loss = self.loss(idx, uniforms)
            with span("rt.backward"):
                loss.backward()
            with span("rt.optim"):
                self.optimizer.step()
            return float(loss.detach())

    def rebuild(self) -> None:
        """Rebuild the accel around the current (detached) geometry (none
        to rebuild without one)."""
        if self.accel is None:
            return
        mesh = apply_params(self.scene.mesh, self.params, self.pose_obj)
        self.accel = build_cluster_accel(mesh, self.accel.cluster_size)

    def state(self, step: int) -> dict:
        """The live params (detached) and the optimizer's state_dict:
        views of the fit's own tensors, not copies."""
        return dict(params={k: v.detach() for k, v in self.params.items()},
                    opt_state=self.optimizer.state_dict(), step=step)

    def load_state(self, st: dict) -> None:
        """Put the params and the optimizer's state back from `st` (as
        `state` gives them, on any device), copied: `st` stays as it is."""
        with torch.no_grad():
            for k, v in st["params"].items():
                self.params[k].copy_(v)
        self.optimizer.load_state_dict(copy.deepcopy(st["opt_state"]))


def fit(scene: Scene, target: torch.Tensor, params: Dict[str, torch.Tensor],
        config: RenderConfig, accel: Optional[ClusterAccel] = None,
        steps: int = 100, rays_per_step: int = 4096,
        learning_rate: float = 1e-2, pose_obj: int = 0,
        generator: Optional[torch.Generator] = None,
        callback: Optional[Callable[[int, float], None]] = None,
        rebuild_every: int = 0, retries: int = 0,
        checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
        opt_state: Optional[dict] = None, start_step: int = 0
        ) -> FitResult:
    """Stochastic inverse rendering: every step draws rays_per_step of the
    frame's primary rays and the render's uniforms from `generator`
    (default: seed 0 on the scene's device) and descends the squared error
    against target [H, W, 3] (`Fitter`); callback(i, loss) after step i
    (from 0).

    rebuild_every=k (> 0): when the geometry is fitted (verts or pose),
    rebuild the accel around it every k steps — its bounds and triangle
    blocks otherwise follow the vertices by the refit inside every step
    (`Fitter`), in the order of the last build. opt_state: an Adam
    state_dict to resume; start_step: the step count a resumed fit starts from,
    which its checkpoints count on from.

    Recovery, as in the JAX package: retries > 0 or a checkpoint_path runs
    every step under `utils.resilience.Supervisor`. A transient device
    fault is retried up to `retries` times, each retry from the params,
    optimizer state and generator state from before the failed attempt,
    so a retried step ends as a clean one would; when the device is lost,
    (params, optimizer state, step) of the last good step go to
    checkpoint_path (default "fit_recovery.npz") before DeviceLost is
    raised. checkpoint_every=k also writes them there every k steps."""
    if retries < 0:
        raise ValueError(f"retries must be >= 0, got {retries}")
    fitter = Fitter(scene, target, params, config, accel=accel,
                    learning_rate=learning_rate, pose_obj=pose_obj,
                    opt_state=opt_state)
    dev = scene.mesh.verts.device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)

    def uniforms(tag, shape):
        return torch.rand(shape, generator=generator, device=dev)

    def one_step():
        idx = torch.randint(0, fitter.n_rays, (rays_per_step,),
                            generator=generator, device=dev)
        return fitter.step(idx, uniforms)

    supervisor = None
    if retries > 0 or checkpoint_path:
        from raytracing_tpu_torch.utils.resilience import Supervisor

        supervisor = Supervisor(
            checkpoint_path or "fit_recovery.npz",
            state_fn=lambda: fitter.state(supervisor.step),
            retries=retries, checkpoint_every=checkpoint_every,
            restore_fn=fitter.load_state, step=start_step)
    rebuilds = rebuild_every > 0 and bool(_GEOMETRY_PARAMS & set(params))
    losses = []
    for i in range(steps):
        if rebuilds and i > 0 and i % rebuild_every == 0:
            fitter.rebuild()
        if supervisor is None:
            losses.append(one_step())
        else:
            rng = generator.get_state()

            def attempt():
                generator.set_state(rng)
                return one_step()

            losses.append(supervisor.run_step(attempt))
        if callback is not None:
            callback(i, losses[-1])
    st = fitter.state(start_step + steps)
    return FitResult(params=st["params"], losses=losses,
                     opt_state=st["opt_state"])
