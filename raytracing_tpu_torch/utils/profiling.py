"""Observability: throughput meters, timers, the profiler hook, the
port's spans and counters, and a device summary (twin of
`raytracing_tpu.utils.profiling`, which has no spans or counters).

`RateMeter` is the once-a-second fps print, generalized; `timed` is a wall
clock that waits for the card's queued work before it stops;
`profile_trace` wraps `torch.profiler` (CPU and CUDA activities) and
writes a Chrome trace in which each hand-written kernel appears under its
own name (`walk_kernel`, `refine_kernel`, ...) and, since it switches
tracing on, the port's spans; `device_summary` names the card, how many
there are and their power limit.

Spans (`span`, `spanned`, `host_sync`) mark the port's layer boundaries
as `rt.<layer>`: `rt.frame`, `rt.chunk`, `rt.level`, `rt.query`,
`rt.lists`, `rt.walk`, the PyTorch glue (`rt.shade`, `rt.area_light`,
`rt.children`, `rt.bin`, `rt.unsort`, `rt.radiance`, `rt.camera_rays`,
`rt.merge`, `rt.pack`, `rt.tables`, `rt.attrs`) and `rt.sync`; an
inverse fit's `rt.fit`, `rt.backward`, `rt.optim`, `rt.refit` and, in
each backward function, `rt.grad` (kind). Off by default (`tracing`): a
span is then one shared no-op. On, each is a
`torch.profiler.record_function`, so a profiler run shows them beside
the CUDA activity on the same clock, nested by time on the host thread
that opened them: on CUDA tensors autograd runs the backward functions
on a thread of its own, so the `rt.grad` spans sit there, inside the
time of the main thread's `rt.backward`.
`COUNTERS` holds every count (see `Counters`); the device's run only
under `counting(True)`.
"""

from __future__ import annotations

import contextlib
import functools
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
    activity, and CUDA activity where a card is present) with the port's
    spans on, its Chrome trace written to `logdir/trace.json`; a no-op
    otherwise."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was = tracing(True)
    try:
        with profile(activities=acts) as prof:
            yield
    finally:
        tracing(was)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


class _NoSpan:
    """The span while tracing is off: one shared object that does nothing
    on entry or exit."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_TRACING = False


def tracing(on: bool) -> bool:
    """Switch the port's spans on or off; returns the old state."""
    global _TRACING
    was, _TRACING = _TRACING, bool(on)
    return was


def span(name: str, **args):
    """The span `name` around a block (`with span("rt.level", depth=2):`).
    Tracing off: the shared no-op (a flag check: no RecordFunction, no
    device work). On: `torch.profiler.record_function(name)` with `args`
    as "key=value" text."""
    if not _TRACING:
        return _NO_SPAN
    return torch.profiler.record_function(
        name, " ".join(f"{k}={v}" for k, v in args.items()) or None)


def spanned(name: str, key: Optional[str] = None):
    """Decorator: the function runs inside the span `name`, whose args
    name the function, or with `key` the value of that keyword argument
    where the call gives it (a walk wrapper's `entry`)."""

    def deco(fn):
        label = fn.__name__

        @functools.wraps(fn)
        def inner(*a, **kw):
            if not _TRACING:
                return fn(*a, **kw)
            arg = (f"fn={label}" if key is None
                   else f"{key}={kw.get(key, label)}")
            with torch.profiler.record_function(name, arg):
                return fn(*a, **kw)

        return inner

    return deco


class Counters:
    """The port's counts, in one registry.

    launches: the port's own kernel launches by entry
    (`kernels.traverse.LAUNCHES` is this dict and names its keys;
    `kernels.light` adds `light_sample` and `light_fold`).
    host: plain ints, always on: `syncs.<site>` (a host read of a device
    value on a main path: `level`, the Whitted level's children;
    `narrow_lists`; `path_alive`), `rays.level<d>` (the rays of Whitted
    level d), `rays.nearest` / `rays.shadow` (lanes given to the kernel
    path's queries), `rays.area_light` (the area lights' shadow rays:
    rays x lights x samples at each level), `area_light.fused` (those of
    them that csrc/light.cu's kernels prepared: all of them on the card's
    kernel path, else 0), `fit.steps` (inverse-fit steps), `grad.rays`
    (lanes of the nearest queries that carry the backward's planes:
    `kernels.traverse._ShadedWalk`), `refit.slots` (slots and rest rows
    whose geometry `accel.packets.refit_geometry` recomputed).
    device: sums kept where the tensors live, as int64, only while
    `counting(True)` (off by default, so a timed or profiled step never
    runs them): `alive.level<d>`, `alive.nearest` / `alive.shadow` /
    `alive.area_light` (the alive lanes of the same; an area light's
    after the hit and n.l > 0 mask), `walk.visits` (clusters the walk
    launches visited: the kernels' own count on the card; every listed
    one where a plain version or K4 walks, neither of which exits early),
    `walk.listed` (the visits their lists held) and `walk.lane_tests`
    (visits x the launch tile's rays x the cluster size: the (ray,
    triangle) tests the visits issue, dead lanes included), `grad.hit`
    (the lanes a backward scatters a gradient from: hit lanes of
    `_ShadedWalk` and `_LazyT`). `read` reads
    them once, when a step ends."""

    def __init__(self):
        self.launches: dict = {}
        self.host: dict = {}
        self.device: dict = {}
        self.counting = False

    def add(self, name: str, n: int = 1) -> None:
        self.host[name] = self.host.get(name, 0) + n

    def add_device(self, name: str, value) -> None:
        """Add an int or an integer tensor, without a host sync. Callers
        test `counting` first, so that a step that does not count
        computes nothing."""
        self.device[name] = self.device.get(name, 0) + value

    def reset(self) -> None:
        """Zero the launches; drop the host and device counts."""
        for k in self.launches:
            self.launches[k] = 0
        self.host.clear()
        self.device.clear()

    def read(self) -> dict:
        """Every count as an int by name, the launches as
        `launches.<entry>`; the device counts in one read."""
        out = {f"launches.{k}": v for k, v in self.launches.items()}
        out.update(self.host)
        vals = list(self.device.values())
        if vals:
            dev = next((v.device for v in vals
                        if isinstance(v, torch.Tensor)), "cpu")
            out.update(zip(self.device, torch.stack([
                torch.as_tensor(v, dtype=torch.int64, device=dev)
                for v in vals]).tolist()))
        return out


COUNTERS = Counters()


def counting(on: bool) -> bool:
    """Switch the device counts of `COUNTERS` on or off; returns the old
    state."""
    was, COUNTERS.counting = COUNTERS.counting, bool(on)
    return was


def host_sync(site: str):
    """Mark a host sync on a main path, at `site`: counted in
    `syncs.<site>`; the span `rt.sync` goes around the read."""
    COUNTERS.add("syncs." + site)
    return span("rt.sync", site=site)


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
