"""Query dispatch (twin of `raytracing_tpu.tracer`).

The port has one engine, the cluster traversal of `kernels/traverse.py`:
CUDA kernels on CUDA tensors, their plain PyTorch versions on CPU tensors.
The JAX package's brute-force and pure-XLA cluster backends are not
ported, so a query needs a ClusterAccel. The nearest queries take the
mesh, as the JAX package's do: their gradients go to its live tables.
"""

from __future__ import annotations

from typing import Optional

from raytracing_tpu_torch.accel.packets import ClusterAccel
from raytracing_tpu_torch.config import RenderConfig
from raytracing_tpu_torch.geometry.mesh import Mesh
from raytracing_tpu_torch.kernels import traverse as T
from raytracing_tpu_torch.ops.intersect import INF


def _require(accel: Optional[ClusterAccel]) -> ClusterAccel:
    if accel is None:
        raise NotImplementedError(
            "queries without a ClusterAccel (the brute-force backend) are "
            "not ported (ROADMAP Queue 1, the off-main-path variants)")
    return accel


def nearest_hit(mesh: Mesh, accel: Optional[ClusterAccel], o, d,
                config: RenderConfig, alive=None):
    """Nearest hit with original triangle ids; t differentiates into
    mesh.verts and the rays (the kernel's value forward). alive: an
    optional [R] bool mask; dead lanes' results are meaningless."""
    return T.nearest_hit(mesh, _require(accel), o, d, config.eps,
                         alive=alive)


def nearest_hit_shaded(mesh: Mesh, accel: Optional[ClusterAccel], o, d,
                       config: RenderConfig, alive=None, early_exit=None,
                       wq: bool = False, shared_origin=None):
    """Nearest hit plus the winner's shading attributes: (Hit, attrs
    [N, 9]); Hit.tri holds packed slot ids. t and attrs differentiate into
    the mesh and the rays when one of them requires grad. shared_origin: a
    [3] origin every ray leaves (selects the origin-folded intersector)."""
    return T.nearest_hit_shaded(mesh, _require(accel), o, d, config.eps,
                                alive=alive, early_exit=early_exit, wq=wq,
                                shared_origin=shared_origin)


def nearest_hit_shaded_camera(accel: Optional[ClusterAccel], offs,
                              config: RenderConfig, tile_base: int,
                              tiles: int, bh: int = 16, bw: int = 16):
    """`nearest_hit_shaded` for frame blocks [tile_base, tile_base + tiles)
    of config's camera, the rays derived in the kernel (camera mode). Its
    results are detached, as in the JAX package: a differentiated render
    traces its primaries through `nearest_hit_shaded`."""
    return T.nearest_hit_shaded_camera(
        _require(accel), offs, width=config.width, height=config.height,
        spp=config.samples_per_pixel, scale=config.scale, eps=config.eps,
        tile_base=tile_base, tiles=tiles, bh=bh, bw=bw)


def any_hit(accel: Optional[ClusterAccel], o, d, config: RenderConfig,
            t_max=INF, alive=None, wq: bool = False):
    """Occlusion of rays o, d [N, 3] -> [N] bool. t_max: a number, or an
    [N] tensor of per-ray bounds (an area light's shadow samples)."""
    return T.any_hit(_require(accel), o, d, config.eps, t_max=t_max,
                     alive=alive, wq=wq)
