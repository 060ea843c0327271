"""Small end-to-end drives of the port (twin of the JAX package's root
`__graft_entry__.py`):

  entry()            — the flagship forward step (the Whitted renderer on
                       the reference scene, the cluster backend) and its
                       example arguments;
  dryrun_multichip() — one full inverse-rendering train step sharded over
                       n devices (`shard.make_train_step`) on a small
                       scene that exercises real traversal: a bumpy 6x6
                       quad grid (72 triangles, 9 clusters of 8) and a
                       floor quad in the rest set, the kernel path.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def entry(device="cuda", width: int = 64, height: int = 64,
          chunk: int = 4096):
    """(fn, example_args): fn(mesh, accel, sun, o, d, uniforms) is
    `render_rays` at the flagship config (width x height, 1 spp, backend
    "cluster"); the arguments are the default scene's, its CS 128 accel and
    the first `chunk` camera rays, on `device`."""
    from raytracing_tpu_torch.accel.packets import build_cluster_accel
    from raytracing_tpu_torch.config import RenderConfig
    from raytracing_tpu_torch.geometry.scene import build_default_scene
    from raytracing_tpu_torch.models.camera import camera_rays
    from raytracing_tpu_torch.models.whitted import render_rays

    cfg = RenderConfig(width=width, height=height, samples_per_pixel=1,
                       chunk_size=chunk, backend="cluster")
    scene = build_default_scene(t=0.0, device=device)
    accel = build_cluster_accel(scene.mesh)
    o, d = camera_rays(cfg, device=device)
    o, d = o.reshape(-1, 3)[:chunk], d.reshape(-1, 3)[:chunk]
    gen = torch.Generator(device=scene.mesh.verts.device)
    gen.manual_seed(0)

    def uniforms(tag, shape):
        return torch.rand(shape, generator=gen, device=gen.device)

    def fn(mesh, accel_, sun, o_, d_, uniforms_):
        return render_rays(mesh, accel_, sun, o_, d_, cfg, uniforms_)

    return fn, (scene.mesh, accel, scene.sun, o, d, uniforms)


def _bumpy_scene():
    """The JAX dryrun's scene: a 6x6 quad grid with a sine bump, and a
    floor quad far below (2 triangles: the rest set at CS 8)."""
    from raytracing_tpu_torch.geometry.mesh import Scene, concat_objects

    g = 6
    gx, gz = np.meshgrid(np.arange(g + 1), np.arange(g + 1), indexing="ij")
    gv = np.stack(
        [gx.ravel() - g / 2.0,
         0.35 * np.sin(gx.ravel() * 1.7) * np.cos(gz.ravel() * 2.1),
         gz.ravel() + 4.0], axis=1).astype(np.float32)
    quads = []
    for i in range(g):
        for j in range(g):
            a = i * (g + 1) + j
            b, c = a + 1, a + (g + 1)
            quads += [[a, c, b], [b, c, c + 1]]
    grid = {"verts": gv, "tri_v": np.asarray(quads, dtype=np.int32),
            "colors": np.array([0.8, 0.6, 0.4], dtype=np.float32),
            "material": (1.0, 0.3, 0.5)}
    floor = {"verts": np.array([[-40, -3, -40], [-40, -3, 60], [40, -3, 60],
                                [40, -3, -40]], dtype=np.float32),
             "tri_v": np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32),
             "colors": np.array([0.55, 0.55, 0.55], dtype=np.float32),
             "material": (1.0, 0.0, 1.0)}
    return Scene(mesh=concat_objects([grid, floor]),
                 sun=torch.tensor([200.0, 300.0, -1000.0]))


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> float:
    """One sharded train step over n devices: every card by default
    (`make_device_mesh(n_devices)`, which raises when there are fewer), or
    n virtual shards of `device` ("cuda:0", "cpu"). The bumpy grid at CS 8
    with its rest set, the 8x8 geometric-normal config (reflect depth 3,
    diffuse depth 2, 2 fan rays), 32 n rays, Adam at 1e-2 from vertices
    moved by 0.03. Asserts a finite loss and finite parameters; returns the
    loss."""
    from raytracing_tpu_torch.accel.packets import build_cluster_accel
    from raytracing_tpu_torch.config import RenderConfig
    from raytracing_tpu_torch.models.whitted import render_rays
    from raytracing_tpu_torch.parallel.shard import (make_device_mesh,
                                                     make_train_step)

    dmesh = (make_device_mesh(n_devices) if device is None
             else make_device_mesh(n_devices, devices=[device] * n_devices))
    dev = dmesh.devices[0]
    scene = _bumpy_scene().to(dev)
    accel = build_cluster_accel(scene.mesh, cluster_size=8)
    assert accel.num_clusters >= 4, accel.num_clusters
    assert accel.rest_ids is not None
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1,
                       backend="cuda", reflect_depth=3, diffuse_depth=2,
                       diffuse_scatter=2, normals="geometric")
    n_rays = 32 * n_devices
    xs = torch.linspace(-0.15, 0.15, n_rays, device=dev)
    o = torch.zeros((n_rays, 3), device=dev)
    d = torch.stack([xs, xs * 0.3 + 0.02, torch.ones_like(xs)], dim=-1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    with torch.no_grad():
        target = render_rays(
            scene.mesh, accel, scene.sun, o, d, cfg,
            lambda tag, shape: torch.rand(shape, generator=gen, device=dev))
    params = {"verts": scene.mesh.verts + 0.03,
              "colors": scene.mesh.colors,
              "materials": scene.mesh.materials}
    step = make_train_step(cfg, functools.partial(torch.optim.Adam, lr=1e-2),
                           dmesh)
    params, _, loss = step(params, None, scene.mesh, accel, scene.sun, o, d,
                           target, seed=0)
    loss = float(loss)
    assert np.isfinite(loss), f"non-finite loss {loss}"
    for k, v in params.items():
        assert bool(torch.isfinite(v).all()), f"non-finite {k}"
    print(f"dryrun_multichip({n_devices}): ok, loss={loss:.6f}")
    return loss
