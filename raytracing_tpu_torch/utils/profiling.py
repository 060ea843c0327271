"""Observability: throughput meters, timers, the profiler hook and a
device summary (twin of `raytracing_tpu.utils.profiling`).

`RateMeter` is the once-a-second fps print, generalized; `timed` is a wall
clock that waits for the card's queued work before it stops;
`profile_trace` wraps `torch.profiler` (CPU and CUDA activities) and
writes a Chrome trace in which each hand-written kernel appears under its
own name (`walk_kernel`, `refine_kernel`, ...); `device_summary` names
the card, how many there are and their power limit.
"""

from __future__ import annotations

import contextlib
import logging
import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

import torch

log = logging.getLogger("raytracing_tpu_torch")


@dataclass
class RateMeter:
    """Windowed throughput meter: call tick(units) per frame/batch; emits a
    rate line at most once per `interval` seconds."""

    name: str = "fps"
    interval: float = 1.0
    _count: float = 0.0
    _t0: float = field(default_factory=time.perf_counter)
    last_rate: Optional[float] = None

    def tick(self, units: float = 1.0, emit=print) -> Optional[float]:
        self._count += units
        now = time.perf_counter()
        dt = now - self._t0
        if dt >= self.interval:
            self.last_rate = self._count / dt
            if emit:
                emit(f"{self.name}: {self.last_rate:.6g}")
            self._count = 0.0
            self._t0 = now
            return self.last_rate
        return None


@contextlib.contextmanager
def timed(label: str, sync: bool = True) -> Iterator[dict]:
    """Wall-clock timer; with `sync`, the window ends with
    `torch.cuda.synchronize()` when CUDA is in use, so work the host only
    queued is counted."""
    out: dict = {}
    t0 = time.perf_counter()
    yield out
    if sync and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    log.info("%s: %.4fs", label, out["seconds"])


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]) -> Iterator[None]:
    """`torch.profiler` over the block when a logdir is given (CPU
    activity, and CUDA activity where a card is present), its Chrome
    trace written to `logdir/trace.json`; a no-op otherwise."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def power_limit(index: int = 0) -> str:
    """The card's power limit as `nvidia-smi` reports it, else "power
    limit unknown"."""
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


def device_summary(device="cuda") -> str:
    """'<count> x <name>, <power limit> (cuda)' for a card, e.g. '1 x
    NVIDIA H100 80GB HBM3, 700.00 W (cuda)'; '1 x cpu, <threads> threads
    (cpu)' for the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return f"1 x cpu, {torch.get_num_threads()} threads (cpu)"
    index = dev.index if dev.index is not None else 0
    return (f"{torch.cuda.device_count()} x "
            f"{torch.cuda.get_device_name(index)}, {power_limit(index)} "
            f"({dev.type})")
