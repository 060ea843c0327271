#!/usr/bin/env python3
"""Time kernels of two trees in one process on one CUDA card: the dense
refinement (K5), the extents (K6) and the pack walk (K1/K2, `rt_walk`).

Run from the root of a checkout, with another commit of the repository
unpacked somewhere (`git archive <commit> | tar -x -C _work/parent`):

    python3 tools/kernel_ab.py _work/parent [--sweep]

Both trees' `raytracing_tpu_torch/csrc/*.cu` are compiled with this tree's
nvcc flags. `rt_refine_dense` and `rt_tile_extents` (their C signatures are
the same in every commit) run on the depth-2 wavefront of the reference
frame's busiest chunk, 720,896 rays against the 100 clusters of the CS=128
accel. `rt_walk` runs on the lists phase 3 of chip_smoke.py times it on:
that wavefront's refined lists over the combined table (the `_walk_dma`
entry, nearest with attributes), the chunk's area-light shadow query over
the CS=16 table (the `_walk_groups` entry, occlusion under a per-ray limit,
~200 listed clusters per tile), the chunk's primaries (short lists), and
the whole frame's 2,560,000 primaries over the subdivided teapot's 6,320 x
64 and 12,640 x 128 tables (coherent rays: the early exit decides the
work). A tree whose `rt_walk` splits a tile's list over blocks takes a
segment size and merge scratch; one that gives a tile one block does not:
each tree is bound by its own signature. Every kernel runs in the order
this, other, other, this, each the median of 5 launches by CUDA events.
Prints the kernels' registers as `ptxas -v` reports them, the four times,
and whether the outputs are equal (the walk's on alive lanes: a dead lane
does not vote on the early exit, so its result is meaningless). With
`--sweep` this tree's walk is then timed on every input at segments of 256
to 2,048 triangles and at 16, 64 and 256 blocks per tile at most. Kernel
times differ between processes on a shared machine; only times of one run
of this script compare. Never imports JAX.
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
        name = next((k for k in ("13refine_kernel", "extents_kernel",
                                 "walk_kernel") if k in line), None)
        if "Compiling entry" in line and name and "camera" not in line:
            used = next(l for l in lines[i:] if "Used" in l)
            spill = next(l for l in lines[i:] if "spill" in l)
            print(f"[build] {tree}: {name.lstrip('13')}: "
                  f"{used.split(':', 1)[1].strip()}; {spill.strip()}")
    lib = ctypes.CDLL(out)
    p, ll, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float)
    lib.rt_refine_dense.argtypes = [p, ll, p, p, i32, p, p, p]
    lib.rt_tile_extents.argtypes = [p, ll, p, p, p]
    with open(os.path.join(tree, "raytracing_tpu_torch", "csrc",
                           "walk.cu")) as f:
        lib.split_walk = "int* finished" in f.read()
    head = [p, ll, p, p, p, p, i32]
    tail = [p, p, ll, p, ll, i32, i32, f32, f32, i32, i32, i32, i32]
    lib.rt_walk.argtypes = (head + [i32] * 2 + tail + [p] * 7
                            if lib.split_walk else head + tail + [p] * 5)
    return lib


def _call_walk(lib, args, kw, out):
    """`rt_walk` of one tree on `walk(*args, **kw)`'s arguments."""
    from raytracing_tpu_torch.kernels import traverse as T

    rp, ids, cnt, geo, attr, n_attrs, cs, eps, nearest, t_max, pmto, row = args
    early = kw.get("tnear") is not None and nearest
    ptr = T._ptr
    head = [ptr(rp), rp.shape[1], ptr(row), ptr(ids), ptr(cnt),
            ptr(kw["tnear"] if early else None), ids.shape[1]]
    tail = [ptr(kw["bbox"] if early else None), ptr(geo), geo.stride(0),
            ptr(attr), attr.stride(0) if attr is not None else 0, n_attrs,
            cs, float(eps), float(t_max), int(nearest), int(early),
            int(kw["ee_batch"]), int(pmto)]
    outs = [ptr(out["t"]), ptr(out["s"]), ptr(out["a"]), ptr(out["visits"]),
            T._stream()]
    if lib.split_walk:
        seg = T._walk_segment(cs)
        rc = lib.rt_walk(*head, seg,
                         T._walk_grid("walk", rp.shape[1] // 1024,
                                      ids.shape[1], seg, T._MAX_TILE_BLOCKS),
                         *tail, ptr(out["keys"]), ptr(out["finished"]), *outs)
    else:
        rc = lib.rt_walk(*head, *tail, *outs)
    assert rc == 0, rc


def _walk_outputs(args):
    import torch

    rp, n_attrs = args[0], args[5]
    n, dev = rp.shape[1], rp.device
    return dict(t=torch.empty((1, n), device=dev),
                s=torch.empty((1, n), dtype=torch.int32, device=dev),
                a=torch.empty((max(n_attrs, 1), n), device=dev),
                keys=torch.empty(n, dtype=torch.int64, device=dev),
                finished=torch.empty(n // 1024, dtype=torch.int32,
                                     device=dev),
                visits=torch.zeros(n // 1024, dtype=torch.int32, device=dev))


def _inputs(dev):
    """The depth-2 wavefront phase 3a of chip_smoke.py gives K5 and K6 with
    the CS=128 boxes, and phase 3's `rt_walk` launches as (args, kw) of
    `traverse.walk`: its `_walk_dma` row, its K1 light-shadow row (3d) and
    its K1 primary row."""
    import torch

    import chip_smoke
    from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                      build_default_scene)
    from raytracing_tpu_torch.geometry.scene import subdivided_teapot_mesh
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.models import whitted
    from raytracing_tpu_torch.models.camera import (block_ray_ids,
                                                    camera_rays_for_ids)
    from raytracing_tpu_torch.ops.intersect import INF

    cfg = RenderConfig()
    scene = build_default_scene(device=dev)
    acc16 = build_cluster_accel(scene.mesh, cluster_size=16)
    acc128 = build_cluster_accel(scene.mesh, cluster_size=128)
    na = acc16.attr_blocks.shape[1]
    o, d = camera_rays_for_ids(
        block_ray_ids(CHUNK, cfg.chunk_size, cfg, device=dev), cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    ob, db, ab = whitted.bounce_wavefront(
        scene.mesh, acc16, scene.sun, o, d, cfg,
        lambda depth, shape: torch.rand(shape, generator=gen, device=dev))
    bp, _ = T._pad_rays_soa(T.rays_to_soa(ob, db, alive=ab))
    walks = {"walk_dma, 720,896 bounce rays, 100x128, nearest+attrs":
             T._dma_walk_args(acc128, bp, cfg.eps, True, INF, na,
                              early_exit=True if cfg.gi_early_exit else None)}
    rp = T.rays_to_soa(o, d)
    pargs, pkw = T._groups_walk_args(acc16, rp, cfg.eps, True, INF, na)
    walks["walk, 65,536 primaries, 790x16, nearest+attrs"] = (pargs, pkw)
    t, _, a = T._merge_rest_nearest(acc16, rp, *T.walk(*pargs, **pkw),
                                    cfg.eps, na)
    hit = torch.isfinite(t[0])
    n = a[0:3].T
    pos = o + torch.where(hit, t[0], 1.0)[:, None] * d + n * cfg.normal_offset
    gen.manual_seed(3)
    w_dir, _, l_alive, t_stop = whitted.light_shadow_rays(
        whitted.light_cone(chip_smoke._light(dev), 0, pos), pos, n, hit,
        torch.rand((pos.shape[0], 2), generator=gen, device=dev))
    walks["walk, 65,536 light-shadow rays, 790x16, occlusion under "
          "tmax_row"] = T._groups_walk_args(
        acc16, T.rays_to_soa(pos, w_dir, alive=l_alive), cfg.eps, False, INF,
        0, tmax_row=t_stop[None].contiguous())
    # Coherent rays over big tables, where the early exit decides the work:
    # the whole frame's primaries (origin folded) against the subdivided
    # teapot, each table in one `_walk_groups` launch.
    _, _, frame, _ = chip_smoke._reference_camera(dev)
    for levels, cs in ((3, 64), (4, 128)):
        acc = build_cluster_accel(
            subdivided_teapot_mesh(levels=levels, device=dev),
            cluster_size=cs, variants=("pmt",))
        walks[f"walk, 2,560,000 primaries, {acc.num_clusters}x{cs}, "
              f"nearest+attrs, pmto"] = T._groups_walk_args(
            acc, frame, cfg.eps, True, INF, na,
            shared_origin=torch.zeros(3, device=dev))
    return (bp, acc128.cluster_min.contiguous(),
            acc128.cluster_max.contiguous(), walks)


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
    sweep = "--sweep" in argv
    argv = [a for a in argv if a != "--sweep"]
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
    bp, cmin, cmax, walks = _inputs("cuda")
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
    order = ("this", "other", "other", "this")
    for name, fn in (("refine", refine), ("extents", extents)):
        for k in order * 3:  # the first launches of a process run slower
            fn(k)
        ms = [_median_ms(lambda k=k: fn(k)) for k in order]
        print(f"[{name}] ms, median of 5: "
              + ", ".join(f"{k} {t}" for k, t in zip(order, ms)))
    same = (torch.equal(bits["this"], bits["other"])
            and torch.equal(lo["this"], lo["other"])
            and torch.equal(hi["this"], hi["other"]))
    for name, (args, kw) in walks.items():
        args = args[:2] + (args[2].to(torch.int32).contiguous(),) + args[3:]
        out = {k: _walk_outputs(args) for k in libs}
        for k in order * 3:
            _call_walk(libs[k], args, kw, out[k])
        ms = [_median_ms(lambda k=k: _call_walk(libs[k], args, kw, out[k]))
              for k in order]
        print(f"[{name}] ms, median of 5: "
              + ", ".join(f"{k} {t}" for k, t in zip(order, ms)))
        m = args[0][7] != 0
        a, b = out["this"], out["other"]
        eq = all(torch.equal(a[k][..., m], b[k][..., m])
                 for k in (("t", "s", "a") if args[8] else ("t", "s")))
        print(f"[{name}] visits this {int(a['visits'].sum())}, other "
              f"{int(b['visits'].sum())} of {int(args[2].sum())} listed; "
              f"outputs equal on alive lanes: {eq}")
        same = same and eq
    print(f"[equal] outputs of the two trees equal: {same}")
    if sweep:
        _sweep(libs["this"], walks)
    return 0 if same else 1


def _sweep(lib, walks):
    """This tree's split walk at other segment sizes and other caps on a
    tile's blocks than `kernels/traverse.py` sets, two rounds."""
    from raytracing_tpu_torch.kernels import traverse as T

    import torch

    seg0, cap0 = T._SEGMENT_TRIANGLES, T._MAX_TILE_BLOCKS
    try:
        for name, (args, kw) in walks.items():
            args = (args[:2] + (args[2].to(torch.int32).contiguous(),)
                    + args[3:])
            out = _walk_outputs(args)
            for seg, cap in ((256, 64), (512, 64), (1024, 64), (2048, 64),
                             (256, 16), (256, 256)) * 2:
                T._SEGMENT_TRIANGLES, T._MAX_TILE_BLOCKS = seg, cap
                ms = _median_ms(lambda: _call_walk(lib, args, kw, out))
                print(f"[sweep] {name}: {seg} triangles a segment, at most "
                      f"{cap} blocks a tile: {ms} ms, "
                      f"{int(out['visits'].sum())} visits")
    finally:
        T._SEGMENT_TRIANGLES, T._MAX_TILE_BLOCKS = seg0, cap0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
