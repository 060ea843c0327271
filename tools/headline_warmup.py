#!/usr/bin/env python3
"""Where the headline (`bench.measure`) loses rate in a fresh process.

Runs in a new process on one CUDA card, from the root of a checkout:

    python3 tools/headline_warmup.py

The headline is `nearest_hit_camera_soa` at 800x800x4 on the default
scene's CS 16 accel, timed by `bench.camera_rate`. This script times that
very call four ways, in this order, right after the kernels and the accel
are built:

1. the host syncs of one call, counted under
   `torch.cuda.set_sync_debug_mode("warn")`;
2. 120 back-to-back calls, each between its own pair of CUDA events, with
   the card's SM clock read by `nvidia-smi` before the first and while the
   calls run: the device time of call k against k shows a warm-up;
3. the host's time to queue 20 calls (no sync) against their device time:
   a host slower than the card leaves it idle inside the events;
4. the host's time for one call with the card idle, and a
   `torch.profiler` trace of 20 calls: the card's busy time per call
   (the sum of its kernels) against the wall time per call, the kernels
   per call, and the host operators that take the most time;
5. `bench.measure()` three times in a row, then three reference frames
   (`bench.timed_frames`, a second of heavy work, as `chip_smoke.py` has
   done before its headline phase), then `bench.measure()` twice more.

Prints one line per reading and the card's name and power limit. Never
imports JAX.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402


def _smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi failed"


def main() -> int:
    if not torch.cuda.is_available():
        print("headline_warmup: needs a CUDA card", file=sys.stderr)
        return 2
    from raytracing_tpu_torch import (bench, build_cluster_accel,
                                      build_default_scene)
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.ops.sampling import stratified_offsets
    from raytracing_tpu_torch.utils.cache import enable_persistent_cache

    print(f"[card] {_smi('name,power.limit')}")
    print(f"[clock] idle, before the build: SM "
          f"{_smi('clocks.sm,clocks.max.sm')}")
    enable_persistent_cache()
    scene = build_default_scene(device="cuda")
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    offs0 = stratified_offsets(4, device="cuda")
    n = 800 * 800 * 4

    def call(state):
        t, _ = T.nearest_hit_camera_soa(accel, offs0 + state * 1e-12,
                                        width=800, height=800, spp=4)
        return torch.where(torch.isfinite(t), t, 0.0).sum() * 1e-20

    state = torch.zeros((), device="cuda")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        state = call(state)
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message)]
    print(f"[syncs] host syncs in one call: {len(syncs)} {syncs[:3]}")

    torch.cuda.synchronize()
    print(f"[clock] before the calls: SM {_smi('clocks.sm')}")
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(120)]
    for a, b in events:
        a.record()
        state = call(state)
        b.record()
    during = _smi("clocks.sm")
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in events]
    print(f"[clock] while the 120 calls ran: SM {during}; after: SM "
          f"{_smi('clocks.sm')}")
    for k in range(0, 120, 10):
        part = ms[k:k + 10]
        print(f"[calls {k + 1}-{k + 10}] device ms per call: min "
              f"{min(part)}, median {statistics.median(part)}, max "
              f"{max(part)} -> {n / (statistics.median(part) / 1e3)} "
              f"rays/s")

    for trial in range(3):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        for _ in range(20):
            state = call(state)
        b.record()
        queued = (time.perf_counter() - t0) * 1e3 / 20
        b.synchronize()
        dev = a.elapsed_time(b) / 20
        print(f"[host] trial {trial + 1}: host queues a call in {queued} "
              f"ms, the card runs it in {dev} ms (events around 20 calls)")

    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = call(state)
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    print(f"[host] one call queued with the card idle: median "
          f"{statistics.median(host)} ms, min {min(host)} ms")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(20):
            state = call(state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 20
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e3 / 20
    print(f"[profile] 20 calls: wall {wall} ms a call (profiler on), card "
          f"busy {busy} ms a call over {len(kernels) / 20} device events a "
          f"call")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3 / 20
    for name, t in sorted(by_name.items(), key=lambda x: -x[1])[:8]:
        print(f"[profile] device {t} ms a call: {name[:90]}")
    cpu = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    for a in cpu[:10]:
        print(f"[profile] host self {a.self_cpu_time_total / 1e3 / 20} ms a "
              f"call, {a.count / 20} a call: {a.key[:70]}")

    def measures(tag, k):
        for i in range(k):
            rec = bench.measure()
            print(f"[measure {tag} {i + 1}] {rec['value']} rays/s, hit "
                  f"fraction {rec['hit_fraction']}")

    measures("fresh", 3)
    from raytracing_tpu_torch import RenderConfig

    _, _, _, first, times = bench.timed_frames(scene, RenderConfig(), accel,
                                               2)
    print(f"[frames] reference frame {first} s, then {times} s")
    measures("after the frames", 2)
    print(f"[card] {_smi('name,power.limit')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
