"""Worker of the port's 2-process tests (tests/test_torch_distributed.py):
joins a gloo group on the CPU, renders this process's shards of a 16x16
frame with `render_distributed` and writes them, then takes 2 sharded
train steps and saves the params and losses.
Usage: torch_dist_worker.py <process_id> <port> <out_dir>"""
import functools
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from raytracing_tpu_torch.parallel import distributed as D  # noqa: E402
from raytracing_tpu_torch.parallel import shard as S  # noqa: E402

# Shared with the test: the frame and the train step both sides run.
FRAME = dict(width=16, height=16, samples_per_pixel=1, diffuse_scatter=2)
STEP = dict(width=16, height=16, samples_per_pixel=1, backend="bruteforce",
            chunk_size=32, reflect_depth=1, diffuse_depth=1,
            normals="geometric")
STEPS = 2


def two_triangles():
    from raytracing_tpu_torch.geometry.mesh import Scene, concat_objects

    obj = {"verts": np.array(
        [[-2.0, -2.0, 5.0], [3.0, -2.0, 5.0], [-2.0, 3.0, 5.0],
         [2.5, 2.5, 6.0], [4.0, 2.5, 6.0], [2.5, 4.0, 6.0]], np.float32),
        "tri_v": np.array([[0, 2, 1], [3, 5, 4]], np.int32),
        "colors": np.array([0.8, 0.6, 0.4], np.float32),
        "material": (1.0, 0.2, 0.5)}
    return Scene(mesh=concat_objects([obj]),
                 sun=torch.tensor([200.0, 300.0, -1000.0]))


def step_batch(n=64):
    xs = torch.linspace(-0.15, 0.15, n)
    return torch.zeros((n, 3)), torch.stack(
        [xs, xs * 0.3 + 0.02, torch.ones(n)], dim=-1)


def train(mesh):
    """STEPS Adam steps over `mesh` from vertices moved by 0.05; returns
    (params, losses)."""
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.models.whitted import render_rays

    scene = two_triangles()
    cfg = RenderConfig(**STEP)
    o, d = step_batch()
    with torch.no_grad():
        target = render_rays(scene.mesh, None, scene.sun, o, d, cfg,
                             lambda tag, shape: torch.rand(shape))
    step = S.make_train_step(cfg, functools.partial(torch.optim.Adam,
                                                    lr=1e-2), mesh)
    params, opt_state, losses = {"verts": scene.mesh.verts + 0.05}, None, []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, scene.mesh, None,
                                       scene.sun, o, d, target, seed=1)
        losses.append(float(loss))
    return params, losses


def main():
    pid, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    assert D.initialize(f"localhost:{port}", 2, pid, backend="gloo")
    assert D.process_count() == 2 and D.process_index() == pid

    from raytracing_tpu_torch import RenderConfig, build_cluster_accel
    from raytracing_tpu_torch.geometry.scene import build_default_scene

    scene = build_default_scene(t=0.0, device="cpu")
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    mesh = D.global_ray_mesh(devices=["cpu"])
    shards = D.render_distributed(scene, RenderConfig(**FRAME), accel=accel,
                                  seed=3, mesh=mesh)
    files = D.save_local_shards(shards, os.path.join(out_dir, "render"))
    print(f"WROTE {len(files)}", flush=True)

    S.COLLECTIVES["all_reduce"] = 0
    params, losses = train(mesh)
    np.savez(os.path.join(out_dir, f"step_{pid}.npz"),
             verts=params["verts"].numpy(), losses=np.array(losses),
             all_reduce=S.COLLECTIVES["all_reduce"])
    D.barrier()
    D.shutdown()
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
