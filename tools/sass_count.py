#!/usr/bin/env python3
"""Count the machine ops of the walks' and the refinement's inner loops in
the compiled kernels, and reckon the scheduler-slot floor of a launch from
them: every intersector family (pmt, pmto, mt, woop) and form (lane cull,
capped refinement) of them.

Run from the root of a checkout on a machine with the CUDA toolkit:

    python3 tools/sass_count.py [VISITS CS RAYS_PER_TILE ...]
                                [--refine TESTS ...]

Builds the port's kernels (`raytracing_tpu_torch/kernels/cuda.py`), dumps
the walks' machine code with `cuobjdump -sass`, and in each of the pack
walk's 24 `walk_kernel<FAMILY, NEAREST, LANE_CULL, CAPPED>`, the camera
walk's `camera_walk_kernel<R, LANE_CULL>` (R rays a thread), K3's 12
`gstream_kernel<FAMILY, NEAREST, CAPPED>` and K4's 9
`wq_items_kernel<FAMILY, NEAREST, CAPPED>` finds the innermost loop that
holds the
(ray, triangle) tests: the innermost loop with the most reciprocals
(`MUFU.RCP`, one per IEEE division, so one per test in every family: pmt's
and pmto's t, mt's 1 / det, woop's 1 / dLz; the lane cull's divisions
are outside that loop). Prints the loop's
machine ops, its tests, and ops per test: a static count, so the branches
a test mostly skips (the update of a ray's best hit) count in full, and
the floor reckoned from it errs on the high side.
The division's slow path (denormal quotients) is a call out of the loop
and is not counted. In the refinement's two kernels (`refine_kernel`,
`refine_lists_kernel`) the loop is a warp's pass over the candidate
boxes, each against the 4 lanes a thread holds: the innermost loop with
the most `FMNMX`, 12 to a (ray, box) slab test. `--refine` takes test
counts (chip_smoke.py prints each refinement row's, as the bound counts
them: every alive lane of a tile against a candidate no lane enters, one
witness for an entered one) and prints their floors, TESTS / 32 * ops
per test / (132 x 4 x SM clock).

Every machine op of a warp takes one slot of one of the card's 132 x 4
warp schedulers, so a launch that makes `VISITS` cluster visits of `CS`
triangles for tiles of `RAYS_PER_TILE` rays cannot take less than

    VISITS * CS * RAYS_PER_TILE / 32 * ops per test
        / (132 * 4 * SM clock)

seconds, whatever its memory traffic (every kernel variant's floor is
printed; a camera launch with R rays a thread walks tiles of 256 R lanes): the floor the arithmetic's bound of
PERF.md (operations over 67 TFLOP/s, a rate that counts a fused
multiply-add as two operations and that code built with -fmad=false cannot
reach) does not see. Each triple of arguments is one launch to reckon;
the clock is the card's maximum SM clock as `nvidia-smi` reports it. The
full listing goes to chiprun_out/sass_walk.txt. Never imports JAX.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULERS = 132 * 4


def _functions(sass):
    """{mangled name: [(address, text), ...]} of a cuobjdump listing, a
    branch to a label rewritten as a branch to the label's address."""
    out, cur, labels, pending = {}, None, {}, []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*(\.L_\w+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and cur is not None:
            for label in pending:
                labels[(id(cur), label)] = int(m.group(1), 16)
            pending = []
            cur.append((int(m.group(1), 16), m.group(2)))
    for instrs in out.values():
        for i, (a, text) in enumerate(instrs):
            m = re.search(r"`\((\.L_\w+)\)", text)
            if m and (id(instrs), m.group(1)) in labels:
                instrs[i] = (a, text.replace(
                    m.group(0), hex(labels[(id(instrs), m.group(1))])))
    return out


def inner_loop(instrs, marker="MUFU.RCP"):
    """(machine ops, `marker` ops) of the innermost loop (a backward branch
    with no other loop inside it) that holds the most `marker` ops."""
    addr = {a: i for i, (a, _) in enumerate(instrs)}
    loops = []
    for i, (a, text) in enumerate(instrs):
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) < a and int(m.group(1), 16) in addr:
            loops.append((addr[int(m.group(1), 16)], i))
    best = None
    for lo, hi in loops:
        if any((lo, hi) != (l, h) and lo <= l and h <= hi for l, h in loops):
            continue
        rcp = sum(marker in t for _, t in instrs[lo:hi + 1])
        if rcp and (best is None or rcp > best[1]):
            best = (hi + 1 - lo, rcp)
    if best is None:
        raise SystemExit(f"no loop with a {marker} found")
    return best


# walk_core.cuh's Family codes.
FAMILIES = {"0": "pmt", "1": "pmto", "2": "mt", "3": "woop"}
# FMNMX of one (ray, box) slab test: 12, and the cap's in a capped form.
SLAB_FMNMX = {False: 12, True: 13}


def _variant(name):
    """'walk_kernel (mt, nearest)' and the like for a walk kernel's
    mangled name, None for any other function."""
    m = re.search(r"_(walk|gstream|wq)_cu_.*?(walk|gstream|wq_items)_kernel"
                  r"ILi(\d)((?:ELb[01])+)EE", name)
    if m:
        # walk_kernel<F, NEAREST, LANE_CULL, CAPPED>; K3's and K4's
        # <F, NEAREST, CAPPED>.
        flags = re.findall(r"Lb([01])", m.group(4))
        names = (("nearest", "lane cull", "capped") if m.group(2) == "walk"
                 else ("nearest", "capped"))
        on = dict(zip(names, (f == "1" for f in flags)))
        return (f"{m.group(2)}_kernel ({FAMILIES[m.group(3)]}, "
                f"{'nearest' if on['nearest'] else 'occlusion'}"
                f"{', lane cull' if on.get('lane cull') else ''}"
                f"{', capped' if on['capped'] else ''})")
    m = re.search(r"_camera_cu_.*camera_walk_kernelILi(\d)ELb([01])EE", name)
    if m:
        return (f"camera_walk_kernel (pmto, nearest, {m.group(1)} rays a "
                f"thread{', lane cull' if m.group(2) == '1' else ''})")
    m = re.search(r"_refine_cu_.*(refine_lists_kernel|refine_kernel)"
                  r"ILb([01])EE", name)
    if m:
        return (f"{m.group(1)} ({'capped ' if m.group(2) == '1' else ''}"
                f"boxes)")
    return None


def main(argv) -> int:
    sys.path.insert(0, HERE)
    from raytracing_tpu_torch.kernels import cuda

    so = cuda.build().path
    dump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.run([dump, "-sass", so], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"cuobjdump failed: {proc.stderr}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0]
    clock = float(card.split(",")[2].split()[0]) * 1e6
    print(f"[device] {card}")
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    per_test, per_box = {}, {}
    with open(os.path.join(out_dir, "sass_walk.txt"), "w") as f:
        for name, instrs in _functions(proc.stdout).items():
            which = _variant(name)
            if which is None:
                continue
            f.write(f"Function : {name}\n")
            f.writelines(f"  /*{a:04x}*/ {t};\n" for a, t in instrs)
            boxes = which.endswith("boxes)")
            n, marks = inner_loop(instrs, "FMNMX" if boxes else "MUFU.RCP")
            # 12 FMNMX a slab test (13 capped); one RCP a (ray, triangle)
            # test in every family: its one IEEE division.
            tests = marks / SLAB_FMNMX["capped" in which] if boxes else marks
            (per_box if boxes else per_test)[which] = n / tests
            print(f"[sass] {which}: {len(instrs)} machine ops; inner loop "
                  f"{n} ops for {tests} (ray, "
                  f"{'box' if boxes else 'triangle'}) tests -> {n / tests} "
                  f"per test")
    kinds = {w.split(" ")[0] for w in list(per_test) + list(per_box)}
    if kinds != {"walk_kernel", "camera_walk_kernel", "gstream_kernel",
                 "wq_items_kernel", "refine_kernel", "refine_lists_kernel"}:
        raise SystemExit(f"kernels found: {sorted(kinds)}")
    walks, refines = argv[1:], []
    if "--refine" in walks:
        k = walks.index("--refine")
        walks, refines = walks[:k], walks[k + 1:]
    for k in range(0, len(walks) - 2, 3):
        visits, cs, rays = (int(x) for x in walks[k:k + 3])
        for which, n in per_test.items():
            ms = visits * cs * rays / 32 * n / (SCHEDULERS * clock) * 1e3
            print(f"[floor] {visits} visits x {cs} triangles x {rays} rays, "
                  f"{which}: {ms} ms at {clock / 1e6} MHz")
    for tests in refines:
        for which, n in per_box.items():
            ms = float(tests) / 32 * n / (SCHEDULERS * clock) * 1e3
            print(f"[floor] {float(tests)} (ray, box) tests, {which}: {ms} ms "
                  f"at {clock / 1e6} MHz")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
