"""The port's benchmark command, `python -m raytracing_tpu_torch bench`: the
JAX CLI's `bench` subcommand (`raytracing_tpu/app.py`), the headline
primary rays/s (`measure`).

The record is one JSON line, under the JAX bench's metric name, with the
card it was measured on: `{"metric", "value", "unit", "device",
"power_limit_w", "hit_fraction"}`. The rate is measured fresh on the card;
a run without a card fails, it never falls back to the CPU. Nothing here
is compared with a number of the JAX package; the program's own benchmark
is `rtbench/` (`two_teapots.primary` measures this query per call).

The query is timed with CUDA events over 20 chained calls, best of 3
(`utils.timing.chain_bench`).
"""

from __future__ import annotations

import json

import torch

HIT_GATE = (0.2, 0.9)  # the default scene, as the JAX bench gates it


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
    so it is no warm-up. Compare two readings only within one run."""
    from raytracing_tpu_torch import build_cluster_accel, build_default_scene

    require_card()
    scene = build_default_scene(device="cuda")
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    rate, frac = camera_rate(accel, 800, 800, 4, 20)
    if not HIT_GATE[0] < frac < HIT_GATE[1]:
        raise RuntimeError(f"implausible hit fraction {frac}")
    return {"metric": "primary_rays_per_s_per_chip_teapot", "value": rate,
            "unit": "rays/s", **card(), "hit_fraction": frac}


def main() -> None:
    rec = measure()
    print(json.dumps(rec), flush=True)
