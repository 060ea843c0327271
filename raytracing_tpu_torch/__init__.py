"""raytracing_tpu_torch — the PyTorch + CUDA port of `raytracing_tpu`.

The JAX package stays the reference; this package renders the same Whitted
and path-traced frames with PyTorch on the host and hand-written CUDA
kernels for Hopper (csrc/: the visit-list walk with its camera,
streamed-groups and work-queue forms, the entered-refinement and the tile
extents). Every kernel has a plain PyTorch version that CPU tensors run.
Module paths and public names follow the JAX package. Importing the
package builds nothing and never imports jax.

Public surface:
  config    — RenderConfig (same fields and defaults as the JAX package)
  geometry  — OBJ loading, SoA Mesh/Scene, the default scene
  accel     — the host-side cluster build (SAH, Baldwin–Weber blocks)
  kernels   — traversal: visit lists, CUDA kernels and plain versions
  models    — camera, the Whitted integrator (with area lights) and the
              path tracer
"""

from raytracing_tpu_torch.accel.packets import ClusterAccel, build_cluster_accel
from raytracing_tpu_torch.config import RenderConfig
from raytracing_tpu_torch.geometry.mesh import Mesh, Scene, SphereLight
from raytracing_tpu_torch.geometry.scene import build_default_scene
from raytracing_tpu_torch.models.path_tracer import PathTracerConfig
from raytracing_tpu_torch.models.path_tracer import render as render_path_traced
from raytracing_tpu_torch.models.whitted import render as render_whitted

__all__ = [
    "ClusterAccel",
    "Mesh",
    "PathTracerConfig",
    "RenderConfig",
    "Scene",
    "SphereLight",
    "build_cluster_accel",
    "build_default_scene",
    "render_path_traced",
    "render_whitted",
]
