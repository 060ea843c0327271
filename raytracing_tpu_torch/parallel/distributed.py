"""Multi-process rendering on `torch.distributed` (twin of
`raytracing_tpu.parallel.distributed`).

  1. `initialize` — join a process group from explicit arguments, the
     RTPU_COORDINATOR / RTPU_NUM_PROCESSES / RTPU_PROCESS_ID environment
     variables, or torchrun's RANK / WORLD_SIZE / MASTER_ADDR /
     MASTER_PORT ("auto"); NCCL for cards, gloo for the CPU, and gloo on a
     card only when named.
  2. `global_ray_mesh` — one 1-D mesh over every shard of every process
     (processes x local devices): a ray batch has no reason to tell the two
     apart.
  3. `render_distributed` — each process makes only its own shards' camera
     rays (index arithmetic: no process holds the whole frame's rays),
     renders them, and `save_local_shards` writes them without a gather;
     `assemble_shards` stitches the files.

The frame is split as `shard.render_sharded` splits it (`shard_layout`),
and a shard draws from `shard_generator(seed, shard)` wherever it runs, so
2 processes of 1 shard render the image 1 process of 2 shards renders.
The shard files are the JAX package's: either package assembles the
other's.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import numpy as np
import torch

from raytracing_tpu_torch.accel.packets import ClusterAccel
from raytracing_tpu_torch.config import RenderConfig
from raytracing_tpu_torch.geometry.mesh import Scene
from raytracing_tpu_torch.parallel.shard import (DeviceMesh, frame_accels,
                                                 make_device_mesh,
                                                 render_shards)

# The local device ids `initialize` was given (None: every card).
_LOCAL_DEVICE_IDS: list = [None]


def initialize(coordinator_address: Optional[str] = None,
               num_processes=None, process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               backend: Optional[str] = None) -> bool:
    """Join a `torch.distributed` process group for a multi-process run.

    Each argument resolves as in the JAX package: the explicit parameter,
    then RTPU_COORDINATOR ("host:port" of process 0) /
    RTPU_NUM_PROCESSES / RTPU_PROCESS_ID. With no process count, or one
    of at most 1, it is a no-op returning False: a single process never
    starts a group. num_processes "auto" reads torchrun's RANK,
    WORLD_SIZE, MASTER_ADDR and MASTER_PORT (the counterpart of JAX's
    pod detection). The group meets at tcp://<coordinator>.

    backend: "nccl" by default where there is a card (local_device_ids
    names cards, or CUDA is available), "gloo" on a CPU-only machine.
    Nothing falls back: gloo on a card (two processes sharing one, which
    NCCL refuses) only when asked for by name. local_device_ids: the cards
    of this process (`global_ray_mesh`'s default devices; under NCCL the
    first becomes the current card). Returns True once joined."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(
        "RTPU_COORDINATOR")
    if num_processes is None:
        num_processes = os.environ.get("RTPU_NUM_PROCESSES")
    if num_processes is None:
        return False
    if num_processes == "auto":
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
        if num_processes <= 1:
            return False
        process_id = int(os.environ["RANK"])
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    num_processes = int(num_processes)
    if num_processes <= 1:
        return False
    if process_id is None:
        process_id = int(os.environ["RTPU_PROCESS_ID"])
    if not coordinator_address:
        raise ValueError("initialize: a multi-process run needs the "
                         "coordinator's host:port (RTPU_COORDINATOR)")
    if backend is None:
        backend = ("nccl" if local_device_ids is not None
                   or torch.cuda.is_available() else "gloo")
    if backend == "nccl" and local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=int(process_id))
    _LOCAL_DEVICE_IDS[0] = (None if local_device_ids is None
                            else [int(i) for i in local_device_ids])
    return True


def _group() -> bool:
    return torch.distributed.is_available() and \
        torch.distributed.is_initialized()


def process_index() -> int:
    return torch.distributed.get_rank() if _group() else 0


def process_count() -> int:
    return torch.distributed.get_world_size() if _group() else 1


def barrier() -> None:
    """Wait for every process of the group (nothing without one). Under
    gloo, also on a card, without device ids."""
    import torch.distributed as dist

    if not _group():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if _group():
        torch.distributed.destroy_process_group()


def global_ray_mesh(devices: Optional[Sequence] = None) -> DeviceMesh:
    """The 1-D mesh over every process's local devices: this process's
    `devices` (default: the cards `initialize` was given, else every
    card), at its rank among process_count() processes. Every process
    must have as many local devices."""
    if devices is None and _LOCAL_DEVICE_IDS[0] is not None:
        devices = [f"cuda:{i}" for i in _LOCAL_DEVICE_IDS[0]]
    local = make_device_mesh(devices=devices)
    return DeviceMesh(local.devices, process_index(), process_count())


def render_distributed(scene: Scene, config: RenderConfig,
                       accel: Optional[ClusterAccel] = None, seed: int = 0,
                       mesh: Optional[DeviceMesh] = None,
                       gi_accel: Optional[ClusterAccel] = None) -> list:
    """This process's shards of the frame over the global mesh: [(global
    shard, first ray id, radiance [rays per shard, 3] on its device)], in
    ray order, the last shard padded (`shard.shard_layout`). Only this
    process's rays are made. Write them with `save_local_shards`; stitch
    the frame with `assemble_shards`. accel and gi_accel default as in
    `render_sharded`."""
    mesh = mesh or global_ray_mesh()
    accel, gi_accel = frame_accels(scene, config, accel, gi_accel)
    return render_shards(scene, config, mesh, accel, gi_accel, seed)


def save_local_shards(shards: list, out_dir: str, tag: str = "shard"
                      ) -> list:
    """Write each of this process's shards to
    `{out_dir}/{tag}_d{shard}.npy` in the JAX package's format (`np.save`
    of {"start": first ray id, "data": f32 [rays, 3]}, pickled). Returns
    the file names."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for g, start, rgb in shards:
        path = os.path.join(out_dir, f"{tag}_d{g}.npy")
        np.save(path, {"start": int(start),
                       "data": rgb.detach().cpu().numpy().astype(np.float32)},
                allow_pickle=True)
        written.append(path)
    return written


def assemble_shards(out_dir: str, config: RenderConfig, tag: str = "shard"
                    ) -> np.ndarray:
    """Stitch every process's saved shards into the [H, W, 3] image
    (averaged over the samples); run after every process has written."""
    spp, h, w = config.samples_per_pixel, config.height, config.width
    r = spp * h * w
    buf = np.zeros((r, 3), np.float32)
    for path in sorted(glob.glob(os.path.join(out_dir, f"{tag}_d*.npy"))):
        rec = np.load(path, allow_pickle=True).item()
        start, data = rec["start"], rec["data"]
        stop = min(start + data.shape[0], r)
        buf[start:stop] = data[:stop - start]
    return buf.reshape(spp, h, w, 3).mean(axis=0)
