"""One run of one cell: set-up, warm-up, the measured window, the traced
steps (`--trace 1`), the check of the window's outputs against the plain
reference, and the result line.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Standard output ends with one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer ones), `device`, with `--trace 1` also `breakdown`, and
last `checks`: each number compared with its limit. Standard error ends
with the same numbers, one line each.
"""

from __future__ import annotations

import argparse
import json
import math
import random
import statistics
import sys
import time

from rtbench import device as devmod
from rtbench import spec
from rtbench.trace import profile_steps


class Reservoir:
    """A uniform sample of `size` of the steps offered, drawn from the
    seed without knowing how many steps will come."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.items = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def parse(argv):
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def within(numbers: dict, limits: dict) -> bool:
    """Every number finite and at or under its limit."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise SystemExit(f"rtbench: the check gave no {missing}")
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)


def judge(per_item: list, limits: dict):
    """(correct, failed items, {name: {"value", "limit"}}) of the checked
    items' numbers: each number is the worst item's."""
    failed = sum(not within(n, limits) for n in per_item)
    checks = {k: {"value": max(float(n[k]) for n in per_item),
                  "limit": float(limits[k])} for k in sorted(limits)}
    return failed == 0 and bool(per_item), failed, checks


def jax_loaded() -> bool:
    """Whether the process holds JAX or the JAX package; says which."""
    found = devmod.forbidden_modules()
    if found:
        print(f"rtbench: JAX modules loaded in the run: {found}",
              file=sys.stderr)
    return bool(found)


def window(entry, seconds: float, reservoir: Reservoir):
    """Closed loop of steps until `seconds` have passed; returns the
    seconds of each step and of the whole window (its first step's start
    to its last step's end)."""
    times = []
    t0 = time.perf_counter()
    k = 0
    while True:
        ts = time.perf_counter()
        out = entry.step(k)
        te = time.perf_counter()
        times.append(te - ts)
        reservoir.offer(entry.keep(k, out))
        k += 1
        if te - t0 >= seconds:
            return times, te - t0


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = spec.load_benchmark()
    cell = spec.load_cell(args.workload, bench)
    kind = devmod.cards(cell.chips)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mod = spec.entry(cell.traffic)
    entry = mod.Entry(cell.config, cell.traffic, args.seed, dev)
    parts = [time.perf_counter()]
    entry.setup()
    parts.append(time.perf_counter())
    entry.warm_up()
    torch.cuda.synchronize()
    parts.append(time.perf_counter())
    setup_s = parts[-1] - t_start
    setup_note = (f"set-up {setup_s} s: start, torch and the card "
                  f"{parts[0] - t_start}, the port, scene and accels "
                  f"{parts[1] - parts[0]}, warm-up {parts[2] - parts[1]}")

    before = devmod.machine_state()
    reservoir = Reservoir(int(cell.traffic["check_steps"]), args.seed)
    times, window_s = window(entry, args.seconds, reservoir)
    notes = [setup_note,
             f"before the window {before}, after {devmod.machine_state()}"]
    memory_peak = int(torch.cuda.max_memory_allocated(dev))
    if jax_loaded():
        return 3
    e2e = entry.end_to_end(times, window_s)
    e2e["setup_s"] = setup_s
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": memory_peak}
    result = {}
    if args.trace:
        n = len(times)
        t = time.perf_counter()
        reading = profile_steps(entry.step, entry.traced_steps(n),
                                window_s / n)
        notes.append(f"traced and read in {time.perf_counter() - t} s")
        if reading is None:
            raise SystemExit("rtbench: the profiler recorded no device "
                             "operation")
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=reading.busy_s, window_s=reading.window_s)
        result["breakdown"] = {"device_ops": reading.device_ops,
                               "idle_gaps": reading.idle_gaps}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    t = time.perf_counter()
    kept = entry.release(reservoir.items)
    correct, failed, checks = judge([entry.check(item) for item in kept],
                                    cell.limits)
    notes.append(f"checked in {time.perf_counter() - t} s")
    if jax_loaded():
        return 3
    q = statistics.quantiles(times, n=4) if len(times) > 1 else times * 3
    print(f"rtbench: {args.workload} seed {args.seed}: {len(times)} steps "
          f"in {window_s} s (min {min(times)}, quartiles {q}, max "
          f"{max(times)} s); {'; '.join(notes)}; "
          f"{kind}, {devmod.power_limit(0)}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    line = {"correct": correct, "attempted": len(times), "failed": failed,
            "metrics": metrics, "device": device, **result,
            "checks": checks}
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0
