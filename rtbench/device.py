"""The card a run measures: its name, count and power limit, the peak of
device memory, and the check that no JAX module was loaded."""

from __future__ import annotations

import subprocess
import sys

# Top-level module names a run of the port may not load: JAX and the JAX
# package the port was made from. Compared whole, so the port's own
# `raytracing_tpu_torch` is not one of them.
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracing_tpu")


def power_limit(index: int = 0) -> str:
    """The card's power limit as `nvidia-smi` reports it, else "power
    limit unknown" (a frozen copy of the port's
    `utils.profiling.power_limit`)."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "power limit unknown"
    text = smi.stdout.strip()
    if smi.returncode != 0 or not text or "N/A" in text:
        return "power limit unknown"
    return text


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def cards(need: int) -> str:
    """Raise SystemExit unless `need` CUDA cards are visible; returns the
    first card's name."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("rtbench: no CUDA card (torch.cuda.is_available() "
                         "is False); the benchmark measures a card only")
    if torch.cuda.device_count() < need:
        raise SystemExit(f"rtbench: the cell needs {need} cards, "
                         f"{torch.cuda.device_count()} are visible")
    return torch.cuda.get_device_name(0)


def sync(device) -> None:
    """Wait for the work queued on `device` (nothing to wait for on the
    CPU, where the entries' tests drive them)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_probe_ms() -> float:
    """The host's speed: ms of a fixed pure-Python loop (the best of 3),
    the kind of work that sets a host-bound step's pace."""
    import time

    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        acc = 0
        for i in range(200_000):
            acc += i & 7
        best = min(best, time.perf_counter() - t)
    return 1e3 * best


def machine_state(index: int = 0) -> str:
    """The card's SM clock, power draw and temperature, and the host's
    speed: beside each run's numbers, to read a slow run by."""
    import os

    try:
        smi = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=clocks.sm,"
             "power.draw,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = "clocks unknown"
    return (f"card {smi}; host probe {host_probe_ms():.3f} ms, "
            f"{os.cpu_count()} cpus")
