"""The traced run's reading of the device: `torch.profiler` over a few
steps after the measured window, reduced to device time by layer (the
frozen table of `layers.py`), launches, the busy time (the union of the
device operations' intervals), the device operations that took most time,
and the idle gaps by what the host was doing in them.

The reduction works on plain (name, start us, end us, on_device, thread)
tuples, so a synthetic trace tests it without a card."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import NamedTuple, Optional

from rtbench.layers import KEYS, layer_of

TOP = 10
NAME_CHARS = 160


def short_name(name: str) -> str:
    """A device operation's name without its return type, namespaces the
    eye skips, and past NAME_CHARS characters."""
    for junk in ("void ", "(anonymous namespace)::", "at::native::",
                 "at_cuda_detail::", "at::cuda::detail::"):
        name = name.replace(junk, "")
    return name[:NAME_CHARS]


class Op(NamedTuple):
    name: str
    start: float   # us
    end: float     # us
    device: bool
    thread: int = 0


class Reading(NamedTuple):
    """What the per-layer metrics read. steps: the profiled steps;
    step_s: the unprofiled window's seconds per step (its whole time over
    its steps); busy_s: device-busy seconds of the profiled steps;
    window_s: their host-clock seconds; layer_ms / layer_launches: device
    ms and operations per layer key over the profiled steps."""

    steps: int
    step_s: float
    busy_s: float
    window_s: float
    launches: int
    layer_ms: dict
    layer_launches: dict
    device_ops: list
    idle_gaps: list


def merged(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def host_labels(host: list, points: list) -> list:
    """The innermost host operation open at each time in `points` (the
    busiest host thread's, whose operations nest), or "no host operation"."""
    if not host:
        return ["no host operation"] * len(points)
    by_thread = defaultdict(list)
    for op in host:
        by_thread[op.thread].append(op)
    evs = sorted(max(by_thread.values(), key=len),
                 key=lambda o: (o.start, -o.end))
    order = sorted(range(len(points)), key=lambda i: points[i])
    labels = [None] * len(points)
    stack, j = [], 0
    for i in order:
        m = points[i]
        while j < len(evs) and evs[j].start <= m:
            while stack and stack[-1].end <= evs[j].start:
                stack.pop()
            stack.append(evs[j])
            j += 1
        while stack and stack[-1].end < m:
            stack.pop()
        labels[i] = stack[-1].name if stack else "no host operation"
    return labels


def reduce_ops(ops: list, steps: int, step_s: float,
               window_s: float) -> Reading:
    dev = [o for o in ops if o.device]
    host = [o for o in ops if not o.device]
    layer_us = dict.fromkeys(KEYS, 0.0)
    layer_n = dict.fromkeys(KEYS, 0)
    per_name = defaultdict(float)
    for o in dev:
        key = layer_of(o.name)
        layer_us[key] += o.end - o.start
        layer_n[key] += 1
        per_name[o.name] += o.end - o.start
    busy = merged((o.start, o.end) for o in dev)
    busy_us = sum(e - s for s, e in busy)
    gaps = []
    if host:
        lo = min(o.start for o in host)
        hi = max(o.end for o in host)
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    labels = host_labels(host, [(a + b) / 2 for a, b in gaps])
    idle = defaultdict(float)
    for (a, b), name in zip(gaps, labels):
        idle[name] += (b - a) / 1e6
    top_ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Reading(
        steps=steps, step_s=step_s, busy_s=busy_us / 1e6, window_s=window_s,
        launches=len(dev),
        layer_ms={k: v / 1e3 for k, v in layer_us.items()},
        layer_launches=layer_n,
        device_ops=[[short_name(n), us / 1e6] for n, us in top_ops],
        idle_gaps=[[n, s] for n, s in
                   sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]])


def _ops_of(prof) -> list:
    from torch.autograd import DeviceType

    ops = []
    for e in prof.events():
        on_dev = e.device_type == DeviceType.CUDA
        ops.append(Op(e.name, float(e.time_range.start),
                      float(e.time_range.end), on_dev,
                      0 if on_dev else int(getattr(e, "thread", 0) or 0)))
    return ops


def profile_steps(step, ks, step_s: float) -> Optional[Reading]:
    """Run step(k) for every k in ks under `torch.profiler` (CPU and CUDA
    activity), each step ending in a synchronise; None when the trace
    holds no device operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in ks:
            step(k)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    ops = _ops_of(prof)
    if not any(o.device for o in ops):
        return None
    return reduce_ops(ops, len(ks), step_s, window_s)
