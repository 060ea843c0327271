#!/usr/bin/env python3
"""Device-time profile of one of the port's frames on one CUDA card.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 tools/profile_frame.py [--out chiprun_out/profile_frame.json]
                                   [--camera] [--lights]
                                   [--path-tracer [--spp N]]
                                   [--wq-impl dma|grid]
                                   [--scene default|404k|1m6]

Renders the reference frame (800x800 at 4 spp, `RenderConfig()` defaults:
the CS=16 accel plus the auto-built CS=128 bounce accel) once to warm up,
times two unprofiled frames, then profiles one frame with `torch.profiler`.
Every CUDA kernel, memcpy and memset of the profiled frame is put in a
layer by its name. The script prints device ms, share and launches per
layer, the device-busy time, and the idle share against the median
unprofiled frame (the profiler slows the host, so the profiled frame's
own wall time is not used). `--out` gets the same table plus every
kernel's totals as JSON. `--camera` renders with
`primary_shared_origin=True` (camera-mode primaries); `--lights` adds one
spherical area light (centre (1, 8, 7), radius 1.5, 4 shadow samples per
level). `--path-tracer` profiles the path tracer instead (800x800, 4
bounces, chunks of 131,072 pixels) at `--spp` samples per pixel (default
4: every sample repeats the same levels, so a 64-spp frame is 16 of these;
the profiler's trace of all 64 would hold half a million launches).
`--wq-impl grid` sends the bounce queries through the work-queue walk (K4)
instead of the `_walk_dma` entry (K2), the default. `--scene 404k` renders
the Whitted frame of the subdivided teapot at 404k triangles (CS=64 accel,
CS=128 bounce accel), `--scene 1m6` at 1.6M triangles (one CS=128 accel
for every level: its 12,640 clusters exceed the group budget, so the
primary and sun-shadow queries run the streamed-groups walk, K3); the
scene is built before the warm-up and its build is not profiled. The
script never imports JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

# The layers device time is sorted into: the benchmark's table (first
# match wins; the last layer takes every name), by its descriptions.
from rtbench.layers import LAYERS, layer_of  # noqa: E402

LAYER_NAMES = {key: what for key, what, _ in LAYERS}


def _device_us(ev) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total",
                 "device_time_total", "cuda_time_total"):
        v = getattr(ev, attr, None)
        if v:
            return float(v)
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/profile_frame.json",
                    help="JSON file for the full table")
    ap.add_argument("--camera", action="store_true",
                    help="camera-mode primaries (primary_shared_origin)")
    ap.add_argument("--lights", action="store_true",
                    help="one spherical area light, 4 shadow samples")
    ap.add_argument("--path-tracer", action="store_true",
                    help="the path tracer instead of the Whitted frame")
    ap.add_argument("--spp", type=int, default=4,
                    help="samples per pixel of the path-traced frame")
    ap.add_argument("--wq-impl", choices=("dma", "grid"), default="dma",
                    help="what the bounce (wq) queries run: K2 or K4")
    ap.add_argument("--scene", choices=("default", "404k", "1m6"),
                    default="default",
                    help="the two-teapot scene or a subdivided teapot")
    opts = ap.parse_args()
    out = opts.out
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytracing_tpu_torch import (PathTracerConfig, RenderConfig,
                                      SphereLight, build_cluster_accel,
                                      build_default_scene,
                                      render_path_traced, render_whitted)
    from raytracing_tpu_torch.geometry.mesh import Scene
    from raytracing_tpu_torch.geometry.scene import (subdivided_teapot_mesh,
                                                     sun_position)
    from raytracing_tpu_torch.kernels import traverse

    traverse._WQ_IMPL = opts.wq_impl

    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    cfg = RenderConfig(primary_shared_origin=opts.camera, light_samples=4,
                       chunk_size=131072 if opts.path_tracer else 65536)
    scene = build_default_scene(device="cuda")
    if opts.lights:
        scene = Scene(scene.mesh, scene.sun, SphereLight(
            torch.tensor([[1.0, 8.0, 7.0]]), torch.tensor([1.5]),
            torch.tensor([[1.5, 1.5, 1.5]])).to("cuda"))
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    gi_accel = None
    if opts.scene != "default":
        levels, cs = {"404k": (3, 64), "1m6": (4, 128)}[opts.scene]
        mesh = subdivided_teapot_mesh(levels=levels, device="cuda")
        scene = Scene(mesh, sun_position(0.0).to("cuda"), scene.lights)
        accel = build_cluster_accel(mesh, cluster_size=cs, variants=("pmt",))
        if cs < 128:
            gi_accel = build_cluster_accel(mesh, cluster_size=128,
                                           variants=("pmt",))
    pt = PathTracerConfig(max_bounces=4, samples_per_pixel=opts.spp)

    def frame():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if opts.path_tracer:
            render_path_traced(scene, cfg, pt, accel=accel,
                               gi_accel=gi_accel)
        else:
            render_whitted(scene, cfg, accel=accel, gi_accel=gi_accel)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    frame()  # warm-up: kernel build, bounce accel, allocator
    wall = statistics.median([frame(), frame()])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = frame()

    kernels = {}
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        us = _device_us(ev)
        k = kernels.setdefault(ev.key, {"us": 0.0, "count": 0})
        k["us"] += us
        k["count"] += int(ev.count)
    if not kernels:
        raise SystemExit("profile_frame: the profiler recorded no device "
                         "events")
    layers = {what: {"ms": 0.0, "launches": 0}
              for what in LAYER_NAMES.values()}
    for name, k in kernels.items():
        row = layers[LAYER_NAMES[layer_of(name)]]
        row["ms"] += k["us"] / 1e3
        row["launches"] += k["count"]
    busy_ms = sum(r["ms"] for r in layers.values())
    launches = sum(r["launches"] for r in layers.values())
    what = (f"path-traced frame, {opts.spp} spp, 4 bounces"
            if opts.path_tracer else "reference Whitted frame")
    print(f"[profile] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {what}, scene {opts.scene}"
          f"{', camera-mode primaries' if opts.camera else ''}"
          f"{', one area light' if opts.lights else ''}"
          f", wq queries through {opts.wq_impl}")
    print(f"[profile] unprofiled frame median {wall} s; profiled frame "
          f"{prof_wall} s")
    print("| layer | device ms | share of device | launches |")
    print("|---|---|---|---|")
    for layer, r in sorted(layers.items(), key=lambda kv: -kv[1]["ms"]):
        print(f"| {layer} | {r['ms']:.2f} | {100 * r['ms'] / busy_ms:.1f}% "
              f"| {r['launches']} |")
    print(f"| total | {busy_ms:.2f} | | {launches} |")
    idle = 1.0 - busy_ms / 1e3 / wall
    print(f"[profile] device busy {busy_ms / 1e3} s of a {wall} s frame: "
          f"idle share {100 * idle:.1f}%")
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["us"])[:12]
    for name, k in top:
        print(f"[profile] {k['us'] / 1e3:10.3f} ms {k['count']:7d}x "
              f"{name[:100]}")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"card": card, "what": what, "scene": opts.scene,
                   "camera": opts.camera,
                   "lights": opts.lights, "wq_impl": opts.wq_impl,
                   "frame_s": wall, "profiled_frame_s":
                   prof_wall, "device_busy_s": busy_ms / 1e3,
                   "idle_share": idle, "layers": layers,
                   "kernels": kernels}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
