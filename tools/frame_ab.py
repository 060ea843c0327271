#!/usr/bin/env python3
"""Time the reference Whitted frame of two trees on one CUDA card, in
turns: this tree, the other, the other, this.

Run from the root of a checkout, with another commit of the repository
unpacked somewhere (`git archive <commit> | tar -x -C _work/parent`):

    python3 tools/frame_ab.py _work/parent [--frames 3] [--cli]

Each turn is a process of its own that imports the package of its tree
(each tree builds its kernels into its own `raytracing_tpu_torch/_build/`):
it builds the default scene and its CS=16 accel on the card, renders one
800x800x4 spp frame with `RenderConfig()` (the auto-built CS=128 bounce
accel, a fixed seed) to warm up, then `--frames` frames, each synchronised,
and prints their seconds, the frame's mean, and the attribute rows of the
nearest walk launches the frame made (every launch of `walk` with a
nearest query, counted by wrapping `kernels.traverse.walk`). Nothing is
differentiated, so both trees should walk the shading planes only (4 in
the default scene's objid mode). With `--cli` each turn renders the
frame `python -m raytracing_tpu_torch render` renders at its defaults
instead (its configuration, scene and accels from the CLI's own
`_build` of `render`'s default flags: CS 128, chunks of 16,384). The two
trees' images must be equal.
Host-bound frames vary between processes; compare the turns of one run
only. Never imports JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TURN = r"""
import json, sys, time
sys.path.insert(0, TREE)
import torch
from raytracing_tpu_torch import RenderConfig, build_cluster_accel, build_default_scene
from raytracing_tpu_torch.kernels import traverse as T
from raytracing_tpu_torch.models.whitted import render

if CLI:
    from raytracing_tpu_torch import app
    cfg, scene, accel, gi_accel, _ = app._build(
        app.build_parser().parse_args(["render"]))
else:
    scene = build_default_scene(device="cuda")
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    cfg, gi_accel = RenderConfig(), None
widths = []
real = T.walk
def walk(*a, **kw):
    if a[8]:
        widths.append(a[5])
    return real(*a, **kw)
T.walk = walk
def frame():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    img = render(scene, cfg, accel=accel, gi_accel=gi_accel, generator=gen)
    torch.cuda.synchronize()
    return img
img = frame()
counted = sorted(set(widths))
secs = []
for _ in range(FRAMES):
    t0 = time.perf_counter()
    img = frame()
    secs.append(time.perf_counter() - t0)
torch.save(img.cpu(), OUT)
print(json.dumps({"seconds": secs, "mean": float(img.mean()),
                  "nearest_walk_widths": counted,
                  "nearest_walk_launches": len(widths) // (FRAMES + 1)}))
"""


def _turn(tree: str, frames: int, out: str, cli: bool) -> dict:
    code = (f"TREE = {tree!r}\nFRAMES = {frames}\nOUT = {out!r}\n"
            f"CLI = {cli!r}\n" + _TURN)
    res = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise SystemExit(f"{tree}: {res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other tree")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--cli", action="store_true",
                    help="the CLI's render at its defaults")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("frame_ab: needs a CUDA card", file=sys.stderr)
        return 2
    trees = {"this": HERE, "other": os.path.abspath(args.other)}
    runs = {"this": [], "other": []}
    with tempfile.TemporaryDirectory() as tmp:
        for k, who in enumerate(("this", "other", "other", "this")):
            out = os.path.join(tmp, f"frame_{k}.pt")
            r = _turn(trees[who], args.frames, out, args.cli)
            r["image"] = torch.load(out)
            runs[who].append(r)
            print(f"[frame_ab] turn {k + 1}, {who} ({trees[who]}): seconds "
                  f"{r['seconds']}, mean {r['mean']}, nearest walks "
                  f"{r['nearest_walk_launches']} a frame with attribute "
                  f"rows {r['nearest_walk_widths']}")
    imgs = [r["image"] for rs in runs.values() for r in rs]
    equal = all(torch.equal(imgs[0], x) for x in imgs[1:])
    for who, rs in runs.items():
        secs = [s for r in rs for s in r["seconds"]]
        print(f"[frame_ab] {who}: "
              f"{'CLI' if args.cli else 'reference'} frame median "
              f"{statistics.median(secs)} s over {len(secs)} frames")
    print(f"[frame_ab] the trees' images are "
          f"{'bit-equal' if equal else 'DIFFERENT'}")
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
