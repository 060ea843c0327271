"""The readings a cell's limits are set from, in one process on the card:

    python3 rtbench/calibrate.py --workload <cell> --seeds 12 --controls 3 \
        [--first-seed N] [--steps 4] [--out calib.json]

Set-up once; then, for each program seed, a short window of `--steps`
steps at the cell's own sizes driven as a run drives it, with the run's
sample of kept steps; the program's state freed; every seed's kept
steps checked against the reference (the program's readings: the lower
end of each limit); then for `--controls` of the seeds the reference
computed in bfloat16 put in the program's place (the control's readings:
the upper end). Prints one JSON object with every reading."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import torch  # noqa: E402

from rtbench import spec  # noqa: E402
from rtbench.device import cards, power_limit  # noqa: E402
from rtbench.harness import Reservoir  # noqa: E402

PROGRAM_STATE = ("mesh", "accel", "gi")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    cell = spec.load_cell(a.workload, spec.load_benchmark())
    kind = cards(cell.chips)
    dev = torch.device("cuda", 0)
    mod = spec.entry(cell.traffic)
    seeds = [a.first_seed + 7919 * i for i in range(a.seeds)]
    first = mod.Entry(cell.config, cell.traffic, seeds[0], dev)
    t0 = time.perf_counter()
    first.setup()
    first.warm_up()
    setup_s = time.perf_counter() - t0
    runs = []
    for seed in seeds:
        e = mod.Entry(cell.config, cell.traffic, seed, dev)
        for name in PROGRAM_STATE:
            if hasattr(first, name):
                setattr(e, name, getattr(first, name))
        res = Reservoir(int(cell.traffic["check_steps"]), seed)
        for k in range(a.steps):
            res.offer(e.keep(k, e.step(k)))
        runs.append((seed, e, res.items))
    readings = []
    for seed, e, items in runs:
        kept = e.release(items)
        t = time.perf_counter()
        for item in kept:
            readings.append({"seed": seed, "step": item[0], **e.check(item)})
        readings[-1]["check_s"] = time.perf_counter() - t
        print(json.dumps(readings[-1]), file=sys.stderr, flush=True)
    controls = []
    for seed, e, items in runs[:a.controls]:
        for item in items:
            t = time.perf_counter()
            c = e.control(item[0], torch.bfloat16)
            controls.append({"seed": seed, "step": item[0], **c,
                             "control_s": time.perf_counter() - t})
            print(json.dumps(controls[-1]), file=sys.stderr, flush=True)
    names = sorted(cell.limits)
    out = {"workload": a.workload, "card": kind, "power": power_limit(0),
           "setup_s": setup_s, "program": readings, "control": controls,
           "lower": {n: max(r[n] for r in readings) for n in names},
           "upper": {n: min(r[n] for r in controls) for n in names}}
    text = json.dumps(out)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
