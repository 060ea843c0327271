"""The port's benchmark command: the headline (`measure`) and the cells of
the JAX package's `bench_suite.py` that one card runs (`suite`).

    python -m raytracing_tpu_torch bench            # the headline
    python -m raytracing_tpu_torch bench --suite    # every cell below

Each record is one JSON line, as `bench_suite.py`'s `_emit` prints it,
under the same metric names, with the card it was measured on:
`{"metric", "value", "unit", "device", "power_limit_w"}`. Every number is
measured fresh on the card; a run without a card fails, it never falls
back to the CPU. Nothing here is compared with a number of the JAX
package.

Cells (`suite`):
  primary_rays_per_s_per_chip_teapot   the headline (`measure`)
  backward_over_forward(_arealight),   262,144 camera rays of the reference
  forward/backward_262k_rays(_arealight)  frame through `render_rays`, loss
                                       sum(rgb^2), gradients for verts,
                                       colors and materials (CS 16; one
                                       area light), median of 3
  whitted_frame_seconds, whitted_fps,  the reference frame, 800x800x4 and
  whitted_frame_1600_*                 1600x1600x4 (CS 16 plus the
                                       auto-built CS 128 bounce accel)
  whitted_frame_arealight_seconds      the same frame lit by one spherical
                                       light, 4 shadow samples
  path_tracer_config3_*                800x800, 64 spp, 4 bounces
  accel_build_teapot_scene             the CS 16 build of the default scene
  mesh_gen_*, accel_build_*,           the headline query on the subdivided
  rays_per_s_404k/1m6/6m4              teapot (CS 64; CS 128; CS 128)
  sharding_overhead_virtual8_weak,     `bench_suite.py:275-343`'s weak pair on
  virtual8_t1, virtual8_t8             8 virtual shards of the one card:
                                       128x128 at spp 1 over 1 shard against
                                       spp 8 over 8 (the same rays a shard),
                                       the reference pipeline, CS 16, chunks
                                       of 8,192; t8 / (8 t1)
  scaling_efficiency_2proc,            `:346-465`: one 128x128x2 frame
  twoproc_t1, twoproc_t2               (reflect depth 3, 6 fan rays) at fixed
                                       total work, 1 process of 2 shards
                                       against 2 processes of 1 (a gloo
                                       group) sharing the card; t1 / t2
  scaling_efficiency_n<N>              `:243-268`: per-card rays/s of
                                       `render_sharded` at N cards against 1
                                       (256x256x4, reflect depth 1, no fan),
                                       only where N = device_count() > 1
Beside every frame stands its count of alive ray queries and their rate
(`*_alive_ray_queries`, `*_alive_ray_queries_per_s`): a frame's
"rays/s" otherwise counts its primaries only.

Frames are timed with the host clock around work that ends in
`torch.cuda.synchronize()`; the headline and the large scenes with CUDA
events over 20 (10, 5) chained calls, best of 3 (`utils.timing`).
"""

from __future__ import annotations

import json
import statistics
import time
from typing import Callable, Optional

import torch

# The spherical light of bench_suite.py:542-546: centre, radius, emission.
LIGHT = ((1.0, 8.0, 7.0), 1.5, (1.5, 1.5, 1.5))
HIT_GATE = (0.2, 0.9)          # the default scene, as the JAX bench gates it
HIT_GATE_LARGE = (0.05, 0.95)  # the subdivided teapot
BACKWARD_REPS = 3


def require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark measures a CUDA card and there is "
                           "none (torch.cuda.is_available() is False)")


def card() -> dict:
    """The card of every record: its name and its power limit in W (None
    where `nvidia-smi` does not say)."""
    from raytracing_tpu_torch.utils.profiling import power_limit

    limit = power_limit(torch.cuda.current_device())
    try:
        watts = float(limit.split()[0])
    except ValueError:
        watts = None
    return {"device": torch.cuda.get_device_name(), "power_limit_w": watts}


def emit(records: list, metric: str, value, unit: str, **extra) -> None:
    """Print one record, with the card of the run (`records.card`), as a
    JSON line and append it to `records`."""
    rec = {"metric": metric, "value": value, "unit": unit, **records.card,
           **extra}
    print(json.dumps(rec), flush=True)
    records.append(rec)


class Records(list):
    """The records of one run and the card they were measured on."""

    def __init__(self):
        super().__init__()
        self.card = card()


def sphere_light(device="cuda"):
    from raytracing_tpu_torch.geometry.mesh import SphereLight

    c, r, e = LIGHT
    return SphereLight(torch.tensor([c]), torch.tensor([r]),
                       torch.tensor([e])).to(device)


def camera_rate(accel, width: int, height: int, spp: int, iters: int):
    """(primary rays/s, hit fraction) of `nearest_hit_camera_soa` over the
    whole frame: `iters` calls, each call's offsets perturbed by the
    previous call's result (`utils.timing.chain_bench`), best of 3; CUDA
    events on a card."""
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.ops.sampling import stratified_offsets
    from raytracing_tpu_torch.utils.timing import chain_bench

    dev = accel.cluster_min.device
    offs0 = stratified_offsets(spp, device=dev)

    def frame(state):
        t, _ = T.nearest_hit_camera_soa(accel, offs0 + state * 1e-12,
                                        width=width, height=height, spp=spp)
        hit = torch.isfinite(t)
        return torch.where(hit, t, 0.0).sum() * 1e-20, hit.sum()

    n = width * height * spp
    _, hits = frame(torch.zeros((), device=dev))
    ms = chain_bench(lambda s: frame(s)[0], torch.zeros((), device=dev),
                     iters=iters, trials=3)
    return n / (ms / 1e3), int(hits) / n


def measure() -> dict:
    """The headline: `nearest_hit_camera_soa` at 800x800x4 on the default
    scene's CS 16 accel, 20 chained calls in CUDA events, best of 3; gated
    on 0.2 < hits / rays < 0.9. Returns the record (printed by `main`).

    The rate is the host's, not the card's: one call queues about 300
    launches (the lists' PyTorch glue around one camera-walk launch), and
    the host takes longer to queue them than the card to run them, so the
    card idles inside the events. On an H100 80GB HBM3 (700 W) the card
    was busy 2.4 ms a call while the host took 3.8-4.1 ms to queue one,
    and readings in one process spread from 3.4e8 to 7.3e8 rays/s with
    the load of the shared host; the first calls were not the slow ones,
    so it is no warm-up (`tools/headline_warmup.py`). Compare two
    readings only within one run."""
    from raytracing_tpu_torch import build_cluster_accel, build_default_scene

    require_card()
    scene = build_default_scene(device="cuda")
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    rate, frac = camera_rate(accel, 800, 800, 4, 20)
    if not HIT_GATE[0] < frac < HIT_GATE[1]:
        raise RuntimeError(f"implausible hit fraction {frac}")
    return {"metric": "primary_rays_per_s_per_chip_teapot", "value": rate,
            "unit": "rays/s", **card(), "hit_fraction": frac}


def timed_frames(scene, cfg, accel, reps: int, gi_accel=None, pt=None):
    """One frame counted under `counting(True)` (`utils.profiling.COUNTERS`:
    the port's launches, the ray queries' lanes and alive lanes, the
    levels, the syncs, the walks' visits), then `reps` timed frames,
    each synchronised: the Whitted renderer, or with `pt` (a
    PathTracerConfig) the path tracer. The device counts are summed on the
    device, without a host sync, and read once after the counted frame.
    Returns (img, launches, counts, first s, [s per timed frame]);
    launches: `kernels.traverse.LAUNCHES`; counts: `COUNTERS.read()`."""
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.models import path_tracer, whitted
    from raytracing_tpu_torch.utils.profiling import COUNTERS, counting

    dev = scene.mesh.verts.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def frame():
        if pt is not None:
            return path_tracer.render(scene, cfg, pt, accel=accel,
                                      gi_accel=gi_accel)
        return whitted.render(scene, cfg, accel=accel, gi_accel=gi_accel)

    was = counting(True)
    try:
        sync()
        COUNTERS.reset()
        t0 = time.perf_counter()
        img = frame()
        sync()
        first = time.perf_counter() - t0
        launches = dict(T.LAUNCHES)
        counts = COUNTERS.read()
    finally:
        counting(was)
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        img = frame()
        sync()
        times.append(time.perf_counter() - t0)
    if img.shape != (cfg.height, cfg.width, 3) or \
            not bool(torch.isfinite(img).all()):
        raise RuntimeError(f"frame of shape {tuple(img.shape)} is not a "
                           "finite [H, W, 3] image")
    return img, launches, counts, first, times


def backward_262k(scene, accel, gi_accel=None, lights=None,
                  around_counted: Optional[Callable] = None) -> dict:
    """`bench_suite.py:80-130`'s backward cell: the 262,144 camera rays of
    blocks 90-105 (16,384 rays each) of the 800x800x4 reference frame
    through `render_rays`, loss sum(rgb^2), gradients for verts, colors
    and materials. The forward without grad and the forward + backward,
    synchronised, each the median of BACKWARD_REPS after a warm-up; the
    launches and the peak device memory of one counted forward + backward,
    run as `around_counted(run)` when given. Returns a dict: loss of the
    forward and of the counted run, their grads, forward and backward ms
    lists, launches, peak GiB."""
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.models.camera import (block_ray_ids,
                                                    camera_rays_for_ids)
    from raytracing_tpu_torch.models.whitted import render_rays

    dev = scene.mesh.verts.device
    cfg = RenderConfig()
    ids = torch.cat([block_ray_ids(i, 16384, cfg, 16, 16, device=dev)
                     for i in range(90, 106)])
    o, d = camera_rays_for_ids(ids, cfg)
    tables = ("verts", "colors", "materials")

    def run(grad):
        gen = torch.Generator(device=dev)
        gen.manual_seed(3)
        live = {k: getattr(scene.mesh, k).clone().requires_grad_(grad)
                for k in tables}
        with torch.set_grad_enabled(grad):
            rgb = render_rays(
                scene.mesh._replace(**live), accel, scene.sun, o, d, cfg,
                lambda tag, shape: torch.rand(shape, generator=gen,
                                              device=dev),
                gi_accel=gi_accel, lights=lights)
            loss = (rgb * rgb).sum()
        if grad:
            loss.backward()
        return loss.detach(), {k: v.grad for k, v in live.items()}

    def timed(grad):
        out = run(grad)  # warm-up
        times = []
        for _ in range(BACKWARD_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run(grad)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, times

    (loss_f, _), fwd = timed(False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    T.reset_launches()
    out = []
    counted = lambda: out.append(run(True))  # noqa: E731
    if around_counted is None:
        counted()
    else:
        around_counted(counted)
    (loss_b, grads), = out
    torch.cuda.synchronize()
    launches = dict(T.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _, bwd = timed(True)
    return dict(loss_f=loss_f, loss_b=loss_b, grads=grads, fwd_ms=fwd,
                bwd_ms=bwd, launches=launches, peak_gib=peak)


def _frame_records(records, prefix, img_frame, primaries=None):
    """The seconds of a frame cell and its alive ray queries beside it;
    with `primaries`, its primary rays/s too."""
    _, _, counts, _, times = img_frame
    spf = min(times)
    alive = counts["alive.nearest"] + counts.get("alive.shadow", 0)
    emit(records, f"{prefix}_seconds", spf, "s")
    if primaries is not None:
        emit(records, f"{prefix}_rays_per_s", primaries / spf, "rays/s")
    emit(records, f"{prefix}_alive_ray_queries", alive, "queries")
    emit(records, f"{prefix}_alive_ray_queries_per_s", alive / spf,
         "queries/s")
    return spf


def suite() -> list:
    """Every cell of the module docstring, measured fresh on the card, one
    JSON line each. Returns the records."""
    from raytracing_tpu_torch import (PathTracerConfig, RenderConfig,
                                      build_cluster_accel, build_default_scene)
    from raytracing_tpu_torch.geometry.mesh import Scene
    from raytracing_tpu_torch.geometry.scene import subdivided_teapot_mesh

    require_card()
    records = Records()
    rec = measure()
    emit(records, rec["metric"], rec["value"], rec["unit"],
         hit_fraction=rec["hit_fraction"])

    scene = build_default_scene(device="cuda")
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    for suffix, lights in (("", None), ("_arealight", sphere_light())):
        b = backward_262k(scene, accel, lights=lights)
        tf, tb = statistics.median(b["fwd_ms"]), statistics.median(b["bwd_ms"])
        emit(records, f"backward_over_forward{suffix}", tb / tf, "x")
        emit(records, f"forward_262k_rays{suffix}", tf, "ms")
        emit(records, f"backward_262k_rays{suffix}", tb, "ms")
        del b

    cfg = RenderConfig()
    spf = _frame_records(records, "whitted_frame",
                         timed_frames(scene, cfg, accel, 2))
    emit(records, "whitted_fps", 1.0 / spf, "fps")
    big = cfg.replace(width=1600, height=1600)
    _frame_records(records, "whitted_frame_1600",
                   timed_frames(scene, big, accel, 2),
                   primaries=1600 * 1600 * 4)
    lit = Scene(scene.mesh, scene.sun, sphere_light())
    _frame_records(records, "whitted_frame_arealight",
                   timed_frames(lit, cfg.replace(light_samples=4), accel, 1))
    pt = PathTracerConfig(max_bounces=4, samples_per_pixel=64)
    spf = _frame_records(
        records, "path_tracer_config3",
        timed_frames(scene, RenderConfig(chunk_size=131072), accel, 1, pt=pt))
    emit(records, "path_tracer_config3_paths_per_s", 800 * 800 * 64 / spf,
         "paths/s")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    build_cluster_accel(scene.mesh, cluster_size=16)
    torch.cuda.synchronize()
    emit(records, "accel_build_teapot_scene",
         (time.perf_counter() - t0) * 1e3, "ms")
    scaling_cells(records, scene, accel)
    del scene, accel, lit

    for levels, tag, cs, iters in ((3, "404k", 64, 10), (4, "1m6", 128, 10),
                                   (5, "6m4", 128, 5)):
        t0 = time.perf_counter()
        mesh = subdivided_teapot_mesh(levels=levels, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        emit(records, f"mesh_gen_{tag}", t1 - t0, "s")
        acc = build_cluster_accel(mesh, cluster_size=cs, variants=("pmt",))
        torch.cuda.synchronize()
        emit(records, f"accel_build_{tag}", time.perf_counter() - t1, "s")
        rate, frac = camera_rate(acc, 800, 800, 4, iters)
        if not HIT_GATE_LARGE[0] < frac < HIT_GATE_LARGE[1]:
            raise RuntimeError(f"{tag}: implausible hit fraction {frac}")
        emit(records, f"rays_per_s_{tag}", rate, "rays/s",
             hit_fraction=frac)
        del acc, mesh
    return records


def _sharded_seconds(scene, cfg, mesh, accel, reps: int = 3) -> float:
    """Mean seconds of `render_sharded` over `reps` synchronised frames,
    after one frame of warm-up."""
    from raytracing_tpu_torch.parallel.shard import render_sharded

    render_sharded(scene, cfg, mesh, accel=accel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(reps):
        img = render_sharded(scene, cfg, mesh, accel=accel, seed=k + 1)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("render_sharded: a frame that is not finite")
    return (time.perf_counter() - t0) / reps


# One process of the 2-process cell: argv = process id, port, processes,
# shards of this process. Prints {"t_s": best seconds a frame} from
# process 0. Each frame ends with a barrier, so the time covers the
# slowest process.
_TWO_PROC_SNIPPET = r'''
import json, sys, time, torch
from raytracing_tpu_torch import RenderConfig, build_cluster_accel
from raytracing_tpu_torch.geometry.scene import build_default_scene
from raytracing_tpu_torch.parallel import distributed as D
pid, port, nprocs, shards = map(int, sys.argv[1:5])
if nprocs > 1:
    assert D.initialize(f"localhost:{port}", nprocs, pid, backend="gloo")
scene = build_default_scene(device="cuda")
accel = build_cluster_accel(scene.mesh, cluster_size=16)
cfg = RenderConfig(width=128, height=128, samples_per_pixel=2,
                   chunk_size=8192, reflect_depth=3, diffuse_scatter=6)
mesh = D.global_ray_mesh(devices=["cuda:0"] * shards)
def frame(seed):
    D.render_distributed(scene, cfg, accel=accel, seed=seed, mesh=mesh)
    torch.cuda.synchronize()
    D.barrier()
frame(0)
best = float("inf")
for trial in range(3):
    t0 = time.perf_counter()
    for k in range(2):
        frame(1 + trial * 2 + k)
    best = min(best, (time.perf_counter() - t0) / 2)
if pid == 0:
    print(json.dumps({"t_s": best}), flush=True)
D.shutdown()
'''


def two_process_seconds(nprocs: int, shards: int, timeout: float = 600.0
                        ) -> float:
    """Seconds a frame of `_TWO_PROC_SNIPPET` with `nprocs` processes of
    `shards` shards each on the card (a gloo group when nprocs > 1, whose
    processes share it), each process started fresh from this checkout."""
    import os
    import socket
    import subprocess
    import sys

    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TWO_PROC_SNIPPET, str(i), str(port),
         str(nprocs), str(shards)], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(nprocs)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"2-process cell: a process failed:\n"
                               f"{out[-2000:]}")
    line = [ln for ln in outs[0].splitlines() if ln.startswith("{")][-1]
    return json.loads(line)["t_s"]


def scaling_cells(records, scene, accel) -> None:
    """The scaling cells of the module docstring, on the cards there
    are."""
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.parallel.shard import make_device_mesh

    t = {}
    for n in (1, 8):
        cfg = RenderConfig(width=128, height=128, samples_per_pixel=n,
                           chunk_size=8192)
        t[n] = _sharded_seconds(
            scene, cfg, make_device_mesh(n, devices=["cuda:0"] * n), accel)
    emit(records, "sharding_overhead_virtual8_weak", t[8] / (8.0 * t[1]),
         "x")
    emit(records, "virtual8_t1", t[1], "s")
    emit(records, "virtual8_t8", t[8], "s")

    t1, t2 = two_process_seconds(1, 2), two_process_seconds(2, 1)
    emit(records, "scaling_efficiency_2proc", t1 / t2, "x")
    emit(records, "twoproc_t1", t1, "s")
    emit(records, "twoproc_t2", t2, "s")

    n_all = torch.cuda.device_count()
    if n_all > 1:
        cfg = RenderConfig(width=256, height=256, samples_per_pixel=4,
                           diffuse_depth=0, reflect_depth=1)
        rate = {}
        for n in (1, n_all):
            rate[n] = 256 * 256 * 4 / _sharded_seconds(
                scene, cfg, make_device_mesh(n), accel) / n
        emit(records, f"scaling_efficiency_n{n_all}", rate[n_all] / rate[1],
             "x")


def main() -> None:
    rec = measure()
    print(json.dumps(rec), flush=True)
