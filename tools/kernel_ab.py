#!/usr/bin/env python3
"""Time the dense refinement (K5) and extents (K6) kernels of two trees in
one process on one CUDA card.

Run from the root of a checkout, with another commit of the repository
unpacked somewhere (`git archive <commit> | tar -x -C _work/parent`):

    python3 tools/kernel_ab.py _work/parent

Both trees' `raytracing_tpu_torch/csrc/*.cu` are compiled with this tree's
nvcc flags. `rt_refine_dense` and `rt_tile_extents` (their C signatures are
the same in every commit) then run on the same input — the depth-2
wavefront of the reference frame's busiest chunk, 720,896 rays against the
100 clusters of the CS=128 accel — in the order this, other, other, this,
each the median of 5 launches by CUDA events. Prints each kernel's
registers as `ptxas -v` reports them, the four times, and whether the
outputs are equal. Kernel times differ between processes on a shared
machine; only times of one run of this script compare. Never imports JAX.
"""

from __future__ import annotations

import ctypes
import glob
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 20  # the reference frame's busiest chunk of 65,536 primaries


def _build(tree, out):
    from raytracing_tpu_torch.kernels import cuda

    src = sorted(glob.glob(os.path.join(tree, "raytracing_tpu_torch", "csrc",
                                        "*.cu")))
    if not src:
        raise SystemExit(f"no kernel sources under {tree}")
    proc = subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", out, *src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {tree}:\n{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and ("13refine_kernel" in line
                                          or "extents_kernel" in line):
            used = next(l for l in lines[i:] if "Used" in l)
            name = "refine_kernel" if "refine" in line else "extents_kernel"
            print(f"[build] {tree}: {name}: {used.split(':', 1)[1].strip()}")
    lib = ctypes.CDLL(out)
    p, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.rt_refine_dense.argtypes = [p, ll, p, p, i32, p, p, p]
    lib.rt_tile_extents.argtypes = [p, ll, p, p, p]
    return lib


def _wavefront(dev):
    """The ray pack phase 3a of chip_smoke.py gives K5 and K6."""
    import torch

    from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                      build_default_scene)
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.models import whitted
    from raytracing_tpu_torch.models.camera import (block_ray_ids,
                                                    camera_rays_for_ids)

    cfg = RenderConfig()
    scene = build_default_scene(device=dev)
    acc16 = build_cluster_accel(scene.mesh, cluster_size=16)
    acc128 = build_cluster_accel(scene.mesh, cluster_size=128)
    o, d = camera_rays_for_ids(
        block_ray_ids(CHUNK, cfg.chunk_size, cfg, device=dev), cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    ob, db, ab = whitted.bounce_wavefront(
        scene.mesh, acc16, scene.sun, o, d, cfg,
        lambda depth, shape: torch.rand(shape, generator=gen, device=dev))
    bp, _ = T._pad_rays_soa(T.rays_to_soa(ob, db, alive=ab))
    return bp, acc128.cluster_min.contiguous(), acc128.cluster_max.contiguous()


def _median_ms(fn, reps=5):
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"[device] {smi.stdout.strip()}")
    build_dir = os.path.join(HERE, "raytracing_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    libs = {"this": _build(HERE, os.path.join(build_dir, "ab_this.so")),
            "other": _build(os.path.abspath(argv[1]),
                            os.path.join(build_dir, "ab_other.so"))}
    bp, cmin, cmax = _wavefront("cuda")
    n = bp.shape[1]
    nt, c = n // 1024, cmin.shape[0]
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    lo = {k: torch.empty((nt, 8), device="cuda") for k in libs}
    hi = {k: torch.empty((nt, 8), device="cuda") for k in libs}
    bits = {k: torch.empty((nt, c), dtype=torch.int32, device="cuda")
            for k in libs}

    def extents(k):
        rc = libs[k].rt_tile_extents(ptr(bp), n, ptr(lo[k]), ptr(hi[k]),
                                     stream)
        assert rc == 0, rc

    extents("this")
    alive = (hi["this"][:, 7] > 0.0).to(torch.int32).contiguous()

    def refine(k):
        rc = libs[k].rt_refine_dense(ptr(bp), n, ptr(cmin), ptr(cmax), c,
                                     ptr(alive), ptr(bits[k]), stream)
        assert rc == 0, rc

    print(f"[input] {n} rays, {int(alive.sum())} of {nt} tiles alive, "
          f"{c} clusters")
    for name, fn in (("refine", refine), ("extents", extents)):
        order = ("this", "other", "other", "this")
        for k in order * 3:  # the first launches of a process run slower
            fn(k)
        ms = [_median_ms(lambda k=k: fn(k)) for k in order]
        print(f"[{name}] ms, median of 5: "
              + ", ".join(f"{k} {t}" for k, t in zip(order, ms)))
    same = (torch.equal(bits["this"], bits["other"])
            and torch.equal(lo["this"], lo["other"])
            and torch.equal(hi["this"], hi["other"]))
    print(f"[equal] outputs of the two trees equal: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
