#!/usr/bin/env python3
"""The port's spans and counters in the benchmark's cells, on one CUDA card.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 tools/trace_cells.py [--workload CELL ...] [--seed N]
                                 [--window K] [--cost-steps M]
                                 [--out chiprun_out/trace_cells.jsonl]

Sets each cell of `BENCHMARK.json` up as `rtbench/run.py` does (its entry,
configuration and traffic mix; default: every cell), warms it up, then

1. times `--window` unprofiled steps: `step_s`, their seconds over their
   steps, the harness's window in small;
2. times `--cost-steps` steps with the spans off and as many with them on
   (`utils.profiling.tracing`), in turns, no profiler active: what the
   spans cost when on;
3. profiles the mix's `traced_steps` steps twice with `torch.profiler`
   (CPU and CUDA activity), spans off and then on, and compares the device
   operations a step: the spans launch nothing;
4. runs one step under `counting(True)` and reads `COUNTERS`.

Prints one JSON line a cell, also appended to `--out`: the spans' reading
(`span_reading`: device-idle seconds by the innermost `rt.*` span open in
each gap, host self ms a step by span, launch calls a step by span, the
`rt.sync` ms), the counters a step, and the per-layer numbers they give
under the names a benchmark reader would report them by
(`layer_numbers`). The script imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from rtbench.trace import _ops_of, merged  # noqa: E402

# Spans that only frame others; an idle gap under one of them as the
# innermost span falls between the port's layers.
STRUCTURE = ("rt.frame", "rt.chunk", "rt.level", "rt.query")
# The PyTorch glue's spans (an inverse fit's backward functions, Adam and
# the accel's refit among them).
GLUE = ("rt.shade", "rt.area_light", "rt.children", "rt.bin", "rt.unsort",
        "rt.radiance", "rt.camera_rays", "rt.merge", "rt.pack", "rt.tables",
        "rt.attrs", "rt.grad", "rt.optim", "rt.refit")
NONE = "no span"
# The host's calls that queue device work.
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")


def is_span(name: str) -> bool:
    return name.startswith("rt.")


def split_ops(ops: list):
    """(device operations, host operations, spans) of a trace's Op tuples.
    A span's GPU-side annotation (a device event under the span's name)
    is neither: it launched nothing."""
    dev = [o for o in ops if o.device and not is_span(o.name)]
    host = [o for o in ops if not o.device and not is_span(o.name)]
    spans = [o for o in ops if not o.device and is_span(o.name)]
    return dev, host, spans


def self_us(spans: list) -> dict:
    """Host self time (us) by span name: each span's duration less what
    the spans directly inside it cover (spans nest by time on the host
    thread)."""
    evs = sorted(spans, key=lambda o: (o.thread, o.start, -o.end))
    inner = [0.0] * len(evs)
    out = defaultdict(float)
    stack = []
    for i, o in enumerate(evs):
        while stack and (evs[stack[-1]].thread != o.thread
                         or evs[stack[-1]].end <= o.start):
            stack.pop()
        if stack:
            inner[stack[-1]] += o.end - o.start
        stack.append(i)
    for o, c in zip(evs, inner):
        out[o.name] += (o.end - o.start) - c
    return dict(out)


def innermost(spans: list, points: list) -> list:
    """The innermost span open at each time in `points`, over every host
    thread: of each thread's innermost open span (its spans nest), the
    one opened last; "no host operation" where none is open. Autograd
    runs the backward functions of CUDA tensors on a thread of its own,
    so their spans open inside the main thread's `rt.backward`."""
    by_thread = defaultdict(list)
    for o in spans:
        by_thread[o.thread].append(o)
    best = [None] * len(points)
    for evs in by_thread.values():
        evs = sorted(evs, key=lambda o: (o.start, -o.end))
        order = sorted(range(len(points)), key=lambda i: points[i])
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
            if stack and (best[i] is None or stack[-1].start > best[i].start):
                best[i] = stack[-1]
    return [o.name if o is not None else "no host operation" for o in best]


def idle_gaps(dev: list, host: list) -> list:
    """The device's idle intervals between the first and the last host
    operation, as `rtbench/trace.py`'s reduction takes them."""
    if not host:
        return []
    busy = merged((o.start, o.end) for o in dev)
    lo = min(o.start for o in host)
    hi = max(o.end for o in host)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def idle_under_pct(spans: list, gaps: list, name: str):
    """The share (%) of the idle gaps' seconds whose midpoint lies inside a
    span `name`, at any depth of the spans open there; None without
    idle."""
    total = sum(b - a for a, b in gaps)
    if total <= 0:
        return None
    inside = merged((o.start, o.end) for o in spans if o.name == name)
    starts = [s for s, _ in inside]
    under = 0.0
    for a, b in gaps:
        i = bisect.bisect_right(starts, (a + b) / 2) - 1
        if i >= 0 and (a + b) / 2 < inside[i][1]:
            under += b - a
    return 100.0 * under / total


def busy_under_pct(busy: list, spans: list, name: str):
    """The share (%) of the device's busy seconds (`busy`: disjoint
    intervals) that fall inside a span `name` on the host's clock, at any
    depth; None without busy time."""
    total = sum(e - s for s, e in busy)
    if total <= 0:
        return None
    inside = merged((o.start, o.end) for o in spans if o.name == name)
    under, j = 0.0, 0
    for s, e in busy:
        while j < len(inside) and inside[j][1] <= s:
            j += 1
        k = j
        while k < len(inside) and inside[k][0] < e:
            under += min(e, inside[k][1]) - max(s, inside[k][0])
            k += 1
    return 100.0 * under / total


def span_reading(ops: list, steps: int) -> dict:
    """The spans' reading of `steps` profiled steps: device operations,
    device-busy seconds and spans a step, idle seconds by innermost span,
    host self ms a step by span, the runtime's launch and copy calls a
    step by innermost span, the `rt.sync` ms a step, and the idle
    shares under the glue's spans (`idle_in_glue_pct`) and under a span of
    a layer, one not in STRUCTURE (`idle_in_layer_pct`), both as innermost
    span, and under `rt.area_light` and `rt.backward` at any depth
    (`idle_in_area_light_pct`, `idle_in_backward_pct`), the share of the
    device's busy time inside `rt.backward` (`backward_device_pct`), the
    host ms a step inside `rt.refit` (`refit_ms`), and the longest gaps
    outside every span (us, and us from the first gap's start). The
    innermost span is taken over every host thread (`innermost`)."""
    dev, host, spans = split_ops(ops)
    busy = merged((o.start, o.end) for o in dev)
    gaps = idle_gaps(dev, host)
    labels = (innermost(spans, [(a + b) / 2 for a, b in gaps]) if spans
              else [NONE] * len(gaps))
    idle = defaultdict(float)
    outside = []
    for (a, b), name in zip(gaps, labels):
        if name == "no host operation":
            name = NONE
            outside.append((b - a, a - gaps[0][0]))
        idle[name] += (b - a) / 1e6
    total = sum(idle.values())
    own = self_us(spans)
    calls = [o for o in host if o.name.startswith(LAUNCH_CALLS)]
    by_span = defaultdict(int)
    if spans:
        for name in innermost(spans, [o.start for o in calls]):
            by_span[NONE if name == "no host operation" else name] += 1

    def share(names):
        if total <= 0:
            return None
        return 100.0 * sum(s for n, s in idle.items() if n in names) / total

    layers = [n for n in idle if n != NONE and n not in STRUCTURE]
    per = max(steps, 1)
    return {
        "steps": steps,
        "launches": len(dev) / per,
        "busy_s": sum(e - s for s, e in busy) / 1e6 / per,
        "spans": len(spans) / per,
        "idle_s": total,
        "idle_by_span_s": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "self_ms_by_span": {n: us / 1e3 / per for n, us in
                            sorted(own.items(), key=lambda kv: -kv[1])},
        "launch_calls_by_span": {n: c / per for n, c in
                                 sorted(by_span.items(),
                                        key=lambda kv: -kv[1])},
        "sync_ms": sum(o.end - o.start for o in spans
                       if o.name == "rt.sync") / 1e3 / per,
        "glue_host_ms": sum(own.get(n, 0.0) for n in GLUE) / 1e3 / per,
        "idle_in_glue_pct": share(GLUE),
        "idle_in_layer_pct": share(layers),
        "idle_in_area_light_pct": idle_under_pct(spans, gaps,
                                                 "rt.area_light"),
        "idle_in_backward_pct": idle_under_pct(spans, gaps, "rt.backward"),
        "backward_device_pct": busy_under_pct(busy, spans, "rt.backward"),
        "refit_ms": sum(o.end - o.start for o in spans
                        if o.name == "rt.refit") / 1e3 / per,
        "longest_gaps_outside_spans_us": [[round(d), round(at)] for d, at
                                          in sorted(outside)[::-1][:5]],
    }


def area_light_numbers(reading: dict, counts: dict) -> dict:
    """The area lights' numbers of a frame that has them: the share of
    their shadow rays alive after the hit and n.l > 0 mask, and the idle
    share under `rt.area_light`; nothing for a frame without lights."""
    rays = counts.get("rays.area_light")
    if not rays:
        return {}
    return {
        "area_light_alive_pct.arealight": (
            100.0 * counts.get("alive.area_light", 0) / rays),
        "idle_in_area_light_pct.arealight":
            reading["idle_in_area_light_pct"],
    }


def layer_numbers(kind: str, reading: dict, counts: dict) -> dict:
    """The per-layer numbers of a cell of `kind` ("whitted": frames,
    "primary": calls, "fit": inverse-fit steps) from the spans' reading
    and one counted step's counts."""
    def total(prefix):
        return sum(v for k, v in counts.items() if k.startswith(prefix))

    if kind == "fit":
        rays = counts.get("grad.rays")
        return {
            "backward_device_pct.fit": reading["backward_device_pct"],
            "idle_in_backward_pct.fit": reading["idle_in_backward_pct"],
            "refit_host_ms_per_step.fit": reading["refit_ms"],
            "grad_hit_pct.fit": (100.0 * counts.get("grad.hit", 0) / rays
                                 if rays else None),
            "syncs_per_step.fit": total("syncs."),
            "idle_in_glue_pct.fit": reading["idle_in_glue_pct"],
        }

    if kind == "whitted":
        rays = sum(v for k, v in counts.items()
                   if k.startswith("rays.level") and int(k[10:]) >= 2)
        alive = sum(v for k, v in counts.items()
                    if k.startswith("alive.level") and int(k[11:]) >= 2)
        return {
            "syncs_per_frame.whitted": total("syncs."),
            "sync_wait_ms_per_frame.whitted": reading["sync_ms"],
            "glue_host_ms_per_frame.whitted": reading["glue_host_ms"],
            "idle_in_glue_pct.whitted": reading["idle_in_glue_pct"],
            "bounce_alive_pct.whitted": (100.0 * alive / rays if rays
                                         else None),
            "walk_lane_tests_per_frame.whitted": counts.get(
                "walk.lane_tests"),
            **area_light_numbers(reading, counts),
        }
    return {
        "syncs_per_call.primary": total("syncs."),
        "glue_host_ms_per_call.primary": reading["glue_host_ms"],
        "idle_in_glue_pct.primary": reading["idle_in_glue_pct"],
        "walk_lane_tests_per_call.primary": counts.get("walk.lane_tests"),
    }


def measure(cell, entry, window: int, cost_steps: int) -> dict:
    """Steps 1-4 of the module docstring on a set-up, warmed-up `entry`
    of `cell` (a `rtbench.spec.Cell`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytracing_tpu_torch.utils import profiling as P
    from rtbench.device import sync

    k = 0
    t0 = time.perf_counter()
    for _ in range(window):
        entry.step(k)
        k += 1
    step_s = (time.perf_counter() - t0) / window

    cost = {False: [], True: []}
    for i in range(2 * cost_steps):
        on = bool(i % 2) != bool(i // 2 % 2)  # off, on, on, off, ...
        was = P.tracing(on)
        ts = time.perf_counter()
        entry.step(k)
        cost[on].append(time.perf_counter() - ts)
        P.tracing(was)
        k += 1

    acts = [ProfilerActivity.CPU]
    if entry.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    n = int(cell.traffic["traced_steps"])
    readings = {}
    for on in (False, True):
        was = P.tracing(on)
        sync(entry.device)
        with profile(activities=acts) as prof:
            for _ in range(n):
                entry.step(k)
                k += 1
            sync(entry.device)
        P.tracing(was)
        readings[on] = span_reading(_ops_of(prof), n)

    was = P.counting(True)
    P.COUNTERS.reset()
    entry.step(k)
    counts = P.COUNTERS.read()
    P.counting(was)

    kind = {"camera_primary": "primary",
            "fit_step": "fit"}.get(cell.traffic["entry"], "whitted")
    on = readings[True]
    return {
        "cell": cell.name, "step_s": step_s, "window_steps": window,
        "step_s_spans_off": cost[False], "step_s_spans_on": cost[True],
        "spans_cost": (statistics.median(cost[True])
                       / statistics.median(cost[False]) - 1.0),
        "launches_spans_off": readings[False]["launches"],
        "launches_spans_on": on["launches"],
        "idle_pct": 100.0 * (1.0 - on["busy_s"] / step_s),
        "reading": on,
        "counts": {k_: v for k_, v in counts.items()
                   if not k_.startswith("launches.") or v},
        "layers": layer_numbers(kind, on, counts),
    }


def main(argv=None) -> int:
    import torch

    from rtbench import spec
    from rtbench.device import cards, power_limit

    cells = [w["name"] for w in spec.load_benchmark()["workloads"]]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", nargs="*", default=cells, choices=cells)
    ap.add_argument("--seed", type=int, default=2400000001)
    ap.add_argument("--window", type=int, default=6)
    ap.add_argument("--cost-steps", type=int, default=6)
    ap.add_argument("--out", default="chiprun_out/trace_cells.jsonl")
    args = ap.parse_args(argv)
    cards(1)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for name in args.workload:
        cell = spec.load_cell(name, spec.load_benchmark())
        dev = torch.device("cuda", 0)
        entry = spec.entry(cell.traffic).Entry(cell.config, cell.traffic,
                                               args.seed, dev)
        t0 = time.perf_counter()
        entry.setup()
        entry.warm_up()
        setup_s = time.perf_counter() - t0
        out = measure(cell, entry, args.window, args.cost_steps)
        out.update(seed=args.seed, setup_s=setup_s,
                   device=torch.cuda.get_device_name(0),
                   power_limit=power_limit(0))
        line = json.dumps(out)
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
