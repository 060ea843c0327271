"""Multi-device rendering and training: shard the ray batch, replicate the
scene (twin of `raytracing_tpu.parallel.shard`).

Rays are independent, so the only parallel axis is the ray batch
(`RAY_AXIS`). A `DeviceMesh` is an ordered tuple of devices, one per
shard; a device may repeat, so `["cuda:0"] * 4` is 4 shards of one card
and `["cpu"] * 8` the 8 virtual shards the tests run. The scene, the
accels and the lights are copied once to every distinct device for each
frame or step; shard s renders its slice of the frame on its device,
chunk by chunk, with its own random numbers (`shard_generator`). The
train step averages each shard's loss and gradients (the JAX package's
`pmean`), across processes too when `torch.distributed` is up, and takes
one optimizer step that every process takes alike.

The shards run one after the other: the renderer reads the device at
every level (`whitted.render_rays`' all-dead test), so a shard on a second
card waits for the first. Keeping that test on the device is host work
for a later change.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from raytracing_tpu_torch.accel.packets import ClusterAccel
from raytracing_tpu_torch.config import RenderConfig
from raytracing_tpu_torch.geometry.mesh import Mesh, Scene
from raytracing_tpu_torch.models.camera import camera_rays_for_ids
from raytracing_tpu_torch.models.whitted import frame_accels, render_rays

RAY_AXIS = "rays"

# Collectives the train step ran since the last reset: "all_reduce" counts
# its cross-process reductions (one per step in a process group).
COLLECTIVES = {"all_reduce": 0}


class DeviceMesh(NamedTuple):
    """This process's shards: devices[j] renders global shard
    process_index * len(devices) + j of process_count * len(devices)."""

    devices: Tuple[torch.device, ...]
    process_index: int = 0
    process_count: int = 1

    @property
    def size(self) -> int:
        """Shards of this process."""
        return len(self.devices)

    @property
    def n_shards(self) -> int:
        """Shards of every process together."""
        return self.size * self.process_count

    @property
    def first_shard(self) -> int:
        return self.process_index * self.size


def make_device_mesh(n_devices: Optional[int] = None,
                     devices: Optional[Sequence] = None) -> DeviceMesh:
    """A 1-D mesh over `devices` (default: every card, `cuda:0` ...
    `cuda:{device_count() - 1}`), cut to the first n_devices. Devices may
    repeat: `make_device_mesh(8, devices=["cpu"] * 8)` is 8 virtual shards
    of the CPU. Asking for more devices than there are raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_device_mesh: no CUDA card here; name "
                               "the devices (e.g. devices=['cpu'] * 8)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(_device(d) for d in devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"make_device_mesh: {n_devices} devices asked "
                             f"for, {len(devs)} there")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("make_device_mesh: no devices")
    return DeviceMesh(devs)


def _device(d) -> torch.device:
    """torch.device(d), a card named with its index; a card that is not
    there raises."""
    d = torch.device(d)
    if d.type != "cuda":
        return d
    if not torch.cuda.is_available():
        raise RuntimeError(f"{d} named and there is no CUDA card here")
    index = torch.cuda.current_device() if d.index is None else d.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"{d} named and there are "
                         f"{torch.cuda.device_count()} cards")
    return torch.device("cuda", index)


def _on(dev: torch.device):
    """The context a shard's work runs in: its card current (so that
    PyTorch's own launches go there too), or nothing on the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def shard_layout(n_rays: int, n_shards: int, chunk_size: int
                 ) -> Tuple[int, int]:
    """(rays per shard, chunk) of a frame of n_rays primaries split over
    n_shards: each shard renders whole chunks of min(chunk_size, its share)
    rays, and the rays past the frame's end repeat its last ray (their
    results are dropped). `render_sharded` and `render_distributed` both
    split by it, so one process of 2 shards and 2 processes of 1 render
    the same rays with the same draws."""
    share = -(-n_rays // n_shards)
    chunk = max(1, min(chunk_size, share))
    return -(-share // chunk) * chunk, chunk


def shard_generator(seed: int, shard: int, device) -> torch.Generator:
    """The generator global shard `shard` draws its uniforms from, on
    `device`, seeded with the first 64-bit word of
    `numpy.random.SeedSequence((seed, shard))` (the counterpart of the JAX
    package's fold_in(key, axis_index)): a function of (seed, shard) only,
    so that a shard's noise does not depend on which process or device
    renders it."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence((seed, shard))
                        .generate_state(1, np.uint64)[0]))
    return gen


def _draws(seed: int, shard: int, device, uniforms=None):
    """The draws of global shard `shard`, as `render_rays` takes them
    (tag, shape): from `shard_generator(seed, shard)`, or from
    uniforms(shard, tag, shape) when given."""
    if uniforms is not None:
        return lambda tag, shape: uniforms(shard, tag, shape)
    gen = shard_generator(seed, shard, device)
    return lambda tag, shape: torch.rand(shape, generator=gen, device=device)


def _to(x, device):
    """x (a tensor, a NamedTuple of tensors, or None) on `device`, every
    tensor contiguous (the kernels read raw strides)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device).contiguous()
    return type(x)(*(_to(f, device) for f in x))


def replicate(objs: tuple, device) -> tuple:
    """Each of `objs` (a tensor, a NamedTuple of tensors, or None) on
    `device`, every tensor contiguous (the counterpart of the JAX
    package's replicated inputs). A frame or a step replicates once per
    distinct device of its mesh and drops the copies when it returns."""
    return tuple(_to(o, torch.device(device)) for o in objs)


def render_shards(scene: Scene, config: RenderConfig,
                  device_mesh: DeviceMesh, accel: Optional[ClusterAccel],
                  gi_accel: Optional[ClusterAccel], seed: int) -> list:
    """This process's shards of a frame: [(global shard, first ray id,
    radiance [rays per shard, 3] on the shard's device)], each shard's
    camera rays (raster order, `shard_layout`) rendered chunk by chunk
    through `render_rays`, drawing from `shard_generator(seed, shard)`."""
    spp, h, w = config.samples_per_pixel, config.height, config.width
    r = spp * h * w
    per, chunk = shard_layout(r, device_mesh.n_shards, config.chunk_size)
    out, copies = [], {}
    for j, dev in enumerate(device_mesh.devices):
        g = device_mesh.first_shard + j
        if dev not in copies:
            copies[dev] = replicate(
                (scene.mesh, scene.sun, scene.lights, accel, gi_accel), dev)
        m, sun, lights, acc, gi = copies[dev]
        draw = _draws(seed, g, dev)
        ids = torch.clamp_max(
            torch.arange(g * per, (g + 1) * per, dtype=torch.int64,
                         device=dev), r - 1)
        rgb = torch.empty((per, 3), dtype=torch.float32, device=dev)
        with _on(dev):
            for c0 in range(0, per, chunk):
                o, d = camera_rays_for_ids(ids[c0:c0 + chunk], config)
                rgb[c0:c0 + chunk] = render_rays(
                    m, acc, sun, o, d, config, draw, gi_accel=gi,
                    lights=lights)
        out.append((g, g * per, rgb))
    return out


def render_sharded(scene: Scene, config: RenderConfig,
                   device_mesh: DeviceMesh,
                   accel: Optional[ClusterAccel] = None, seed: int = 0,
                   gi_accel: Optional[ClusterAccel] = None
                   ) -> torch.Tensor:
    """A full frame with the primary rays sharded over device_mesh -> [H,
    W, 3] on the mesh's first device.

    The rays are the camera's in raster order, padded by repeating the last
    ray (`shard_layout`); shard i renders its slice on device i in chunks,
    drawing from `shard_generator(seed, i)`;
    the radiance is gathered on the first device, cut to the frame and
    averaged over the samples. The scene's area lights and gi_accel go with
    every shard. accel defaults to `build_cluster_accel(mesh)` except under
    "bruteforce", gi_accel to the auto-built bounce accel on the kernel
    path, as `whitted.render` chooses them."""
    if device_mesh.process_count != 1:
        raise ValueError("render_sharded renders one process's frame; a "
                         "mesh over processes is `render_distributed`'s")
    accel, gi_accel = frame_accels(scene, config, accel, gi_accel)
    shards = render_shards(scene, config, device_mesh, accel, gi_accel, seed)
    first = device_mesh.devices[0]
    spp, h, w = config.samples_per_pixel, config.height, config.width
    rgb = torch.cat([x.to(first) for _, _, x in shards])[:spp * h * w]
    return rgb.reshape(spp, h, w, 3).mean(dim=0)


def _grad(leaf: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(leaf) if leaf.grad is None else leaf.grad


def make_train_step(config: RenderConfig,
                    optimizer: Callable[[list], torch.optim.Optimizer],
                    device_mesh: DeviceMesh,
                    loss_weights: Tuple[float, float, float] = (1.0, 1.0,
                                                                1.0)):
    """The data-parallel inverse-rendering step over device_mesh.

    optimizer: a callable that makes a torch optimizer over a list of
    tensors (e.g. `functools.partial(torch.optim.Adam, lr=1e-2)`; optax's
    transformation in the JAX package). loss_weights is accepted and
    unused, as in the JAX package.

    Returned: step(params, opt_state, mesh, accel, sun, o, d, target,
    seed=0, uniforms=None, grads_out=None) -> (params, opt_state, loss).
    params: a dict of mesh tables ("verts", "normals", "colors",
    "materials"); opt_state: the optimizer's `state_dict()` (None to start
    fresh); o, d, target [R, 3]: the whole batch, R a multiple of the
    mesh's shard count, each process passing the same. Shard s renders
    rays [s R/n, (s+1) R/n) on its device with a copy of params and takes
    mean((rgb - target)^2) over them; its uniforms come from
    `shard_generator(seed, s)` or uniforms(s, tag, shape). The loss and
    the gradients are the mean over every shard — summed over this
    process's shards, then, in a `torch.distributed` group, all_reduce'd
    (SUM: gloo has no average) and divided by the shard count of the
    world. One optimizer step follows on the mesh's first device, the same
    on every process. Returns the new params and opt_state there and the
    loss (a 0-d tensor); grads_out, a dict, receives the mean gradients."""
    del loss_weights

    def step(params: Dict[str, torch.Tensor], opt_state: Optional[dict],
             mesh: Mesh, accel: Optional[ClusterAccel], sun, o, d, target,
             seed: int = 0, uniforms=None,
             grads_out: Optional[dict] = None):
        n = device_mesh.n_shards
        if o.shape[0] % n:
            raise ValueError(f"train step: {o.shape[0]} rays do not split "
                             f"into {n} equal shards")
        per = o.shape[0] // n
        first = device_mesh.devices[0]
        names = list(params)
        leaves, copies = {}, {}  # device -> its params, its replicas
        loss_sum = torch.zeros((), dtype=torch.float32, device=first)
        for j, dev in enumerate(device_mesh.devices):
            g = device_mesh.first_shard + j
            if dev not in leaves:
                leaves[dev] = {k: params[k].detach().to(dev).clone()
                               .requires_grad_() for k in names}
                copies[dev] = replicate((mesh, accel, sun), dev)
            m, acc, sun_d = copies[dev]
            sl = slice(g * per, (g + 1) * per)
            o_s, d_s, t_s = (x[sl].to(dev) for x in (o, d, target))
            draw = _draws(seed, g, dev, uniforms)
            with _on(dev):
                rgb = render_rays(m._replace(**leaves[dev]), acc, sun_d,
                                  o_s, d_s, config, draw)
                loss = ((rgb - t_s) ** 2).mean()
                loss.backward()
            loss_sum = loss_sum + loss.detach().to(first)
        flat = torch.cat([loss_sum.reshape(1)] + [
            sum(_grad(lv[k]).to(first) for lv in leaves.values()).reshape(-1)
            for k in names])
        if torch.distributed.is_available() and \
                torch.distributed.is_initialized():
            world = torch.distributed.get_world_size()
            if world != device_mesh.process_count:
                raise ValueError(f"train step: a mesh over "
                                 f"{device_mesh.process_count} processes "
                                 f"in a group of {world}")
            torch.distributed.all_reduce(flat)
            COLLECTIVES["all_reduce"] += 1
        flat = flat / n
        live = {k: params[k].detach().to(first).clone().requires_grad_()
                for k in names}
        opt = optimizer(list(live.values()))
        if opt_state is not None:
            opt.load_state_dict(opt_state)
        off = 1
        for k in names:
            size = live[k].numel()
            live[k].grad = flat[off:off + size].reshape(live[k].shape)
            off += size
        if grads_out is not None:
            grads_out.update({k: live[k].grad.clone() for k in names})
        opt.step()
        return ({k: v.detach() for k, v in live.items()}, opt.state_dict(),
                flat[0])

    return step
