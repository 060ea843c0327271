"""Query dispatch (twin of `raytracing_tpu.tracer`).

One call surface, three engines, chosen by config.backend:
  "bruteforce" — `ops.trace`, every ray against every triangle (the
      oracle; it takes no accel);
  "cluster" — `accel.packets.nearest_hit_cluster` / `any_hit_cluster`, the
      flat cluster structure walked in plain PyTorch;
  "auto", "cuda", "pallas" — `kernels.traverse`, the cluster traversal of
      the hand-written CUDA kernels (their plain PyTorch versions on CPU
      tensors).
The first two are plain PyTorch on the card as on the CPU and never stand
in for a kernel: the kernel path runs the kernels or raises. Unlike the
JAX package, which brute-forces any query given no accel, a "cluster" or
kernel-path query without an accel raises (`render`, `Fitter` and
`render_sharded` build one for the caller). The queries
take the mesh, as the JAX package's do: brute force reads it, and
gradients go to its live tables.
"""

from __future__ import annotations

from typing import Optional

from raytracing_tpu_torch.accel.packets import (ClusterAccel,
                                                any_hit_cluster,
                                                nearest_hit_cluster)
from raytracing_tpu_torch.config import RenderConfig
from raytracing_tpu_torch.geometry.mesh import Mesh, triangle_soa
from raytracing_tpu_torch.kernels import traverse as T
from raytracing_tpu_torch.ops.intersect import INF
from raytracing_tpu_torch.ops.trace import any_hit_brute, nearest_hit_brute

KERNEL_BACKENDS = ("auto", "cuda", "pallas")


def resolve_backend(backend: str) -> str:
    """The backend a name runs: "auto" is the kernel path ("cuda") on the
    card and on the CPU alike, where the JAX package resolves it to the
    XLA "cluster" backend off the TPU (the port's kernel path runs on the
    CPU through the kernels' plain versions). Other names pass through."""
    return "cuda" if backend == "auto" else backend


def uses_kernels(config: RenderConfig) -> bool:
    """True when config's backend is the kernel path."""
    return config.backend in KERNEL_BACKENDS


def _engine(config: RenderConfig, accel: Optional[ClusterAccel]) -> str:
    """"bruteforce", "cluster" or "kernels" for config's backend; raises
    when a backend that walks an accel was given none."""
    if config.backend == "bruteforce":
        return "bruteforce"
    if accel is None:
        raise ValueError(f"backend {config.backend!r} walks a cluster accel "
                         f"and was given none (accel=None): build one with "
                         f"build_cluster_accel, or use backend 'bruteforce'")
    return "cluster" if config.backend == "cluster" else "kernels"


def nearest_hit(mesh: Mesh, accel: Optional[ClusterAccel], o, d,
                config: RenderConfig, alive=None):
    """Nearest hit with original triangle ids; t differentiates into
    mesh.verts and the rays. alive: an optional [R] bool mask; dead lanes'
    results are meaningless (the kernel path culls them, the others
    ignore the mask)."""
    engine = _engine(config, accel)
    if engine == "bruteforce":
        return nearest_hit_brute(triangle_soa(mesh.verts, mesh.tri_v), o, d,
                                 config.eps)
    if engine == "cluster":
        return nearest_hit_cluster(mesh, accel, o, d, config.eps)
    return T.nearest_hit(mesh, accel, o, d, config.eps, alive=alive)


def nearest_hit_shaded(mesh: Mesh, accel: Optional[ClusterAccel], o, d,
                       config: RenderConfig, alive=None, early_exit=None,
                       wq: bool = False, shared_origin=None,
                       t_cap: Optional[float] = None,
                       lane_cull: bool = False):
    """Nearest hit plus, on the kernel path, the winner's shading
    attributes: (Hit, attrs [N, 9]) with Hit.tri packed slot ids. Off the
    kernel path (Hit with original triangle ids, None): the caller gathers
    the attributes itself. t and attrs differentiate into the mesh and the
    rays when one of them requires grad. shared_origin: a [3] origin every
    ray leaves (selects the origin-folded intersector); t_cap: the
    two-phase capped query; lane_cull: the walk's lane-cull pre-test (the
    last three on the kernel path only; no result depends on them)."""
    if _engine(config, accel) == "kernels":
        return T.nearest_hit_shaded(mesh, accel, o, d, config.eps,
                                    alive=alive, early_exit=early_exit,
                                    wq=wq, shared_origin=shared_origin,
                                    t_cap=t_cap, lane_cull=lane_cull)
    return nearest_hit(mesh, accel, o, d, config, alive=alive), None


def nearest_hit_shaded_camera(accel: ClusterAccel, offs,
                              config: RenderConfig, tile_base: int,
                              tiles: int, bh: int = 16, bw: int = 16):
    """`nearest_hit_shaded` for frame blocks [tile_base, tile_base + tiles)
    of config's camera, the rays derived in the kernel (camera mode; the
    kernel path only). Its results are detached, as in the JAX package: a
    differentiated render traces its primaries through
    `nearest_hit_shaded`."""
    return T.nearest_hit_shaded_camera(
        accel, offs, width=config.width, height=config.height,
        spp=config.samples_per_pixel, scale=config.scale, eps=config.eps,
        tile_base=tile_base, tiles=tiles, bh=bh, bw=bw)


def any_hit(mesh: Mesh, accel: Optional[ClusterAccel], o, d,
            config: RenderConfig, t_max=INF, alive=None, wq: bool = False,
            lane_cull: bool = False):
    """Occlusion of rays o, d [N, 3] -> [N] bool. t_max: a number, or an
    [N] tensor of per-ray bounds (an area light's shadow samples).
    lane_cull: the walk's lane-cull pre-test (kernel path only)."""
    engine = _engine(config, accel)
    if engine == "bruteforce":
        return any_hit_brute(triangle_soa(mesh.verts, mesh.tri_v), o, d,
                             t_max, config.eps)
    if engine == "cluster":
        return any_hit_cluster(mesh, accel, o, d, t_max, config.eps)
    return T.any_hit(accel, o, d, config.eps, t_max=t_max, alive=alive,
                     wq=wq, lane_cull=lane_cull)
