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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from raytracing_tpu_torch.accel.packets import (ClusterAccel,
                                                build_cluster_accel,
                                                first_tri_per_object,
                                                refit_attr_planes)
from raytracing_tpu_torch.config import RenderConfig
from raytracing_tpu_torch.geometry.mesh import Mesh, Scene
from raytracing_tpu_torch.geometry.transform import apply_pose
from raytracing_tpu_torch.models.camera import camera_rays
from raytracing_tpu_torch.models.whitted import render_rays
from raytracing_tpu_torch.utils import checkpoint as ckpt

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
    `build_cluster_accel(scene.mesh)` (the JAX package's fit renders
    without one through its brute-force backend, which is not ported);
    its shading planes are refit from the live parameters inside every
    step."""

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
        self.accel = (build_cluster_accel(scene.mesh) if accel is None
                      else accel)
        self.refits = bool(_REFIT_PARAMS & set(params))
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
        acc = (refit_attr_planes(self.accel, mesh, self.first_tri)
               if self.refits else self.accel)
        rgb = render_rays(mesh, acc, self.scene.sun, self.o[idx],
                          self.d[idx], self.config, uniforms)
        return ((rgb - self.target[idx % self.pixels]) ** 2).mean()

    def step(self, idx: torch.Tensor, uniforms) -> float:
        """One optimizer step on rays idx; returns the loss before it."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(idx, uniforms)
        loss.backward()
        self.optimizer.step()
        return float(loss.detach())

    def rebuild(self) -> None:
        """Rebuild the accel around the current (detached) geometry."""
        mesh = apply_params(self.scene.mesh, self.params, self.pose_obj)
        self.accel = build_cluster_accel(mesh, self.accel.cluster_size)

    def state(self, step: int) -> dict:
        return dict(params={k: v.detach() for k, v in self.params.items()},
                    opt_state=self.optimizer.state_dict(), step=step)


def fit(scene: Scene, target: torch.Tensor, params: Dict[str, torch.Tensor],
        config: RenderConfig, accel: Optional[ClusterAccel] = None,
        steps: int = 100, rays_per_step: int = 4096,
        learning_rate: float = 1e-2, pose_obj: int = 0,
        generator: Optional[torch.Generator] = None,
        rebuild_every: int = 0, retries: int = 0,
        checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
        opt_state: Optional[dict] = None) -> FitResult:
    """Stochastic inverse rendering: every step draws rays_per_step of the
    frame's primary rays and the render's uniforms from `generator`
    (default: seed 0 on the scene's device) and descends the squared error
    against target [H, W, 3] (`Fitter`).

    rebuild_every=k (> 0): when the geometry is fitted (verts or pose),
    rebuild the accel around it every k steps — its bounds and triangle
    blocks otherwise keep the geometry it was built from. checkpoint_path
    with checkpoint_every=k: snapshot (params, optimizer state, step) there
    every k steps (`utils.checkpoint`); opt_state resumes an optimizer.
    retries > 0 (retrying steps after device faults) needs the port of
    `utils/resilience.py`, which is not done."""
    if retries > 0:
        raise NotImplementedError(
            "fit(retries > 0): retrying a step after a device fault needs "
            "utils/resilience.py, which is not ported (ROADMAP Queue 1 "
            "item 3)")
    fitter = Fitter(scene, target, params, config, accel=accel,
                    learning_rate=learning_rate, pose_obj=pose_obj,
                    opt_state=opt_state)
    dev = scene.mesh.verts.device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)

    def uniforms(tag, shape):
        return torch.rand(shape, generator=generator, device=dev)

    rebuilds = rebuild_every > 0 and bool(_GEOMETRY_PARAMS & set(params))
    losses = []
    for i in range(steps):
        if rebuilds and i > 0 and i % rebuild_every == 0:
            fitter.rebuild()
        idx = torch.randint(0, fitter.n_rays, (rays_per_step,),
                            generator=generator, device=dev)
        losses.append(fitter.step(idx, uniforms))
        if checkpoint_path and checkpoint_every and \
                (i + 1) % checkpoint_every == 0:
            st = fitter.state(i + 1)
            ckpt.save(checkpoint_path, st["params"], st["opt_state"],
                      step=st["step"])
    st = fitter.state(steps)
    return FitResult(params=st["params"], losses=losses,
                     opt_state=st["opt_state"])
