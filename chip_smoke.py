#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`raytracing_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device — require CUDA; print `nvidia-smi`'s name and power limit;
  2. build  — compile the CUDA kernels from `raytracing_tpu_torch/csrc`
     and the host library from `csrc/raytracing_native.cpp`; print every
     kernel's registers, shared memory and spills as `ptxas -v` reports
     them, and refuse a spill in the split walks (`walk.cu`, `camera.cu`,
     `gstream.cu`) and the refinement (`refine.cu`);
  3. kernels against their plain PyTorch versions, on the card, at the
     main paths' shapes; median time of 5 runs each:
     a. the reference frame's busiest 65,536-ray chunk of camera rays
        (CS=16 accel, the `_walk_groups` entry, with the default and the
        origin-folded intersector) and that chunk's binned depth-2
        wavefront of 720,896 rays (CS=128 bounce accel: the extents, the
        dense refinement with tile-alive flags given, the dense query in
        one launch as `_refined_lists` makes it, and the `_walk_dma`
        entry);
     b. camera mode on the whole reference frame (2,500 tiles of 1,024
        rays), CS=16 (`walk_camera`) and CS=128 (`walk_camera_dma`),
        against the plain version lane by lane and against the pack path
        under `shared_origin=0` on all 2,560,000 rays; phase 7 repeats
        this on every large scene, with its pooled lists held against the
        direct ones, and the `walk_camera_dma` row is the 1.6M launch
        (launched 10 times, equal every time); phase 5 times
        `walk_camera` at the frame's own shape (one chunk of 64 tiles, as
        the camera-mode frame launches it, 10 times equal);
     c. the gathered refinement (`refine_lists`) and the `_walk_dma` entry
        on the depth-2 wavefront of the 404k-triangle subdivided teapot
        (3,160 bounce clusters); phase 7 times `refine_lists` again at the
        1.6M Whitted frame's busiest launch (12,640 clusters), with the
        spread of listed candidates and alive lanes over the tiles;
     d. per-ray t_max: the busiest chunk's area-light shadow query (one
        spherical light, centre (1, 8, 7), radius 1.5) through the
        `_walk_groups` entry (CS=16) and the `_walk_dma` entry (CS=128),
        kernel against plain, and timed beside a scalar t_max;
     e. the streamed-groups walk (`walk_gstream`, K3), run in phase 7 on
        the 1.6M-triangle scene (12,640 x 128: 4 groups of 4,096 clusters
        at the 32 MiB budget) on all 2,560,000 pack-path rays: against its
        plain version lane by lane, and against the group loop with K1
        (t, slots, attributes, occlusion flags; early exit on and off);
        its time beside the loop's, at budgets of 16 and 64 MiB, and
        beside one K1 launch over the whole table, lists included, and 10
        launches equal; then at the frame's own shape: the two launches of
        the 1.6M Whitted frame's chunk 12 (65,536 rays, primary
        nearest+attrs and sun-shadow occlusion) as the renderer made them,
        and at 6.4M triangles (13 groups) on all 2,560,000 rays;
     f. the work-queue walk (`walk_wq`, K4) on the depth-2 wavefront of
        3a, the very lists the `_walk_dma` row is timed on: against its
        plain version and bit-equal on alive lanes to that entry (nearest
        with attributes; occlusion under a scalar and a per-ray t_max; a
        tile with no visits);
     g. the split pack walk (`walk`, K1/K2) under its racing early exit:
        the `_walk_dma` launch of 3a, the primary launch with the exit
        forced and a nearest query with the exit forced over 3d's long
        lists, each launched 10 times, t, slots and attributes equal
        every time on alive lanes, the visits made printed as min-max;
        its time with and without the exit beside K4's; a tile with no
        visits through both entries;
  4. frame parity — a 64x64 1-spp frame on the card against the same frame
     through the plain CPU path, same uniforms, with pack-path and with
     camera-mode primaries;
  5. the reference frame — 800x800 at 4 spp, default config: one frame
     with launch counts reset, then 2 timed frames (3 before the script
     grew phases 8 and 9); the same with `primary_shared_origin=True`
     (camera-mode primaries), its chunk-20 `walk_camera` launch kept
     for 3b;
  6. headline — `nearest_hit_camera_soa` at 800x800x4 on the default
     scene, CS=16, the offsets perturbed by each call's result: primary
     rays/s, gated on a plausible hit fraction;
  7. large scenes — the same query on the subdivided teapot at 404k
     (CS=64), 1.6M and 6.4M (CS=128) triangles, with mesh-generation and
     accel-build seconds, the pack-path query `nearest_hit_soa` at 1.6M and
     6.4M (it runs K3), and one Whitted frame each of the 1.6M scene (its
     primary and sun-shadow queries run K3; chunk 12's two launches kept
     for 3e) and the 404k scene;
  8. the path-traced frame — 800x800, 64 spp, 4 bounces, chunks of 131,072
     pixels, CS=16 plus the auto-built CS=128 bounce accel: a 64x64 2-spp
     frame on the card against the plain CPU path with the same uniforms,
     then one counted and one timed full frame;
  9. the area-light frame — the reference frame with the light of 3d and
     4 shadow samples: one counted frame, one timed; and the same frame
     with `_WQ_IMPL = "grid"` (bounce queries through K4) against the
     default from the same seed, bit-equal.

Each main path (5, 5 with camera mode, 7's 1.6M camera and pack-path
queries, 7's Whitted frame, 8, 9, 9's "grid" frame)
runs with the launch counts set to 0 just before and read just after. A
plain version that takes seconds is timed once, by the run that checks the
kernel. The last two lines are the kernel table and the result, each one
JSON object. The script never imports JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FRAME_PARITY_ATOL = 1e-4  # torch's CUDA and CPU sin/cos differ by ulps
SKY_ATOL = 1e-3
# Phase 3 traces chunk 20 of the reference frame: the busiest one (48,518
# of its 65,536 primaries hit a teapot, the rest the ground); the frame's
# first 16 chunks are all sky and would leave the bounce level empty.
KERNEL_CHUNK = 20
# The subdivided teapot sits above the camera axis: chunk 12 (pixel rows
# 240-271) crosses its body.
LARGE_KERNEL_CHUNK = 12
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "walk": ("raytracing_tpu_torch/csrc/walk.cu",
             "raytracing_tpu/kernels/traverse.py:972"),
    "walk_dma": ("raytracing_tpu_torch/csrc/walk.cu",
                 "raytracing_tpu/kernels/traverse.py:1819"),
    "refine_extents": ("raytracing_tpu_torch/csrc/refine.cu",
                       "raytracing_tpu/kernels/traverse.py:498"),
    "extents": ("raytracing_tpu_torch/csrc/extents.cu",
                "raytracing_tpu/kernels/traverse.py:163"),
    "walk_camera": ("raytracing_tpu_torch/csrc/camera.cu",
                    "raytracing_tpu/kernels/traverse.py:922"),
    "walk_camera_dma": ("raytracing_tpu_torch/csrc/camera.cu",
                        "raytracing_tpu/kernels/traverse.py:3676"),
    "refine_lists": ("raytracing_tpu_torch/csrc/refine.cu",
                     "raytracing_tpu/kernels/traverse.py:648"),
    "refine_lists_1m6": ("raytracing_tpu_torch/csrc/refine.cu",
                         "raytracing_tpu/kernels/traverse.py:648"),
    "walk_gstream": ("raytracing_tpu_torch/csrc/gstream.cu",
                     "raytracing_tpu/kernels/traverse.py:1414"),
    "walk_wq": ("raytracing_tpu_torch/csrc/wq.cu",
                "raytracing_tpu/kernels/traverse.py:2063"),
}
LIGHT = ((1.0, 8.0, 7.0), 1.5, (1.5, 1.5, 1.5))  # centre, radius, emission
# Published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside
# the tensor cores, and device memory.
PEAK_FP32 = 67e12
PEAK_HBM = 3.35e12
# Floating-point operations per (ray, triangle) test, comparisons and the
# (t, slot) update included, as counted in csrc/walk_core.cuh; per
# (ray, box) slab test in csrc/refine.cu; per ray in csrc/extents.cu.
OPS_PMT, OPS_PMTO, OPS_SLAB, OPS_EXTENTS = 40, 30, 30, 16
HIT_GATE = (0.2, 0.9)         # default scene, as the JAX benchmark gates it
HIT_GATE_LARGE = (0.05, 0.95)  # subdivided teapot


class SmokeFailure(RuntimeError):
    pass


def _require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _median_ms(fn, reps=5):
    import torch

    fn()  # warm-up
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


def _bound(ops, nbytes):
    """The least time the card could take, in ms, and what bounds it."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_HBM * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes"))


def _walk_bound(visits, alive_per_tile, cnt, geo, attr, n_attrs, cs, n_rays,
                pack_bytes, ops_per_test, early):
    """Bound of one walk launch from what this run's data needed: every
    alive lane of a tile against every triangle of the clusters the tile
    visited (the kernel reports them; the early exit is exact); each input
    read once (pack or offsets, the listed ids and entry bounds, both
    tables) and each output written once."""
    ops = float((visits.double() * alive_per_tile.double()).sum()) \
        * cs * ops_per_test
    listed = float(cnt.sum())
    tables = geo.shape[0] * cs * 4 * (12 + n_attrs)
    nbytes = (pack_bytes + listed * (8 if early else 4) + cnt.numel() * 4
              + tables + n_rays * (8 + 4 * n_attrs))
    return _bound(ops, nbytes)


def _timed_once(fn):
    """(fn(), its one run's ms by CUDA events): for the plain versions of
    the big launches, which take seconds and need no warm-up."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def _row(rows, name, err, kernel_fn, plain_fn, bound, shape, plain_reps=5,
         plain_ms=None):
    """Time a kernel (median of 5) and its plain version (median of
    `plain_reps`, or `plain_ms` as timed already) into rows[name]."""
    ms = _median_ms(kernel_fn)
    if plain_ms is None:
        plain_ms = _median_ms(plain_fn, reps=plain_reps)
    rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound[0], bound_by=bound[1], shape=shape)
    print(f"[kernels] time {name}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound[0]:.5f} ms by {bound[1]} "
          f"({shape})")


def phase_device():
    import torch

    _require(torch.cuda.is_available(),
             "torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    _require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}")
    return card


def phase_build():
    from raytracing_tpu_torch.kernels import cuda

    res = cuda.build()
    lines = res.log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        # '_ZN2rt..._7_walk_cu_...11walk_kernelILb0EE...': file and kernel
        mangled = line.split("'")[1]
        kernel = next((k for k in ("walk_fill", "camera_walk", "gstream",
                                   "wq_items", "wq_finish", "walk",
                                   "refine_lists", "refine", "extents")
                       if k + "_kernel" in mangled), mangled)
        variant = mangled.split(kernel + "_kernel")[-1].split("Ev")[0]
        used = next(l for l in lines[i:] if "Used" in l).split(":", 1)[1]
        spill = next(l for l in lines[i:] if "spill" in l).strip()
        print(f"[build] {kernel}_kernel {variant}:{used}; {spill}")
        _require(not any(f"_{src}_cu_" in mangled
                         for src in ("walk", "camera", "gstream", "refine"))
                 or " 0 bytes spill stores, 0 bytes spill loads"
                 in " " + spill, f"{kernel}_kernel {variant} spills "
                 f"registers: {spill}")
    cuda.library()
    print(f"[build] {res.seconds:.2f} s -> {os.path.relpath(res.path, HERE)}")
    from raytracing_tpu_torch.geometry import native

    t0 = time.perf_counter()
    _require(native.available(),
             "the host library (csrc/raytracing_native.cpp) did not build: "
             "the large scenes need it")
    print(f"[build] host library {time.perf_counter() - t0:.2f} s")
    return res.seconds


def _compare_walk(tag, kern, plain, alive, nearest):
    """Kernel vs plain walk outputs on alive lanes: slots / hit flags equal,
    t and attrs bit-equal. Returns the max abs t/attr difference."""
    import torch

    (kt, ks, ka), (pt, ps, pa) = kern, plain
    m = alive
    _require(torch.equal(ks[0][m], ps[0][m]),
             f"{tag}: {'slots' if nearest else 'hit flags'} differ on "
             f"{int((ks[0][m] != ps[0][m]).sum())} lanes")
    _require(torch.equal(kt[0][m], pt[0][m]),
             f"{tag}: t differs on {int((kt[0][m] != pt[0][m]).sum())} lanes")
    err = 0.0
    fin = m & torch.isfinite(pt[0])
    if fin.any():
        err = float((kt[0][fin] - pt[0][fin]).abs().max())
    if nearest and pa is not None:
        _require(torch.equal(ka[:, m], pa[:, m]), f"{tag}: attrs differ")
        if m.any():
            err = max(err, float((ka[:, m] - pa[:, m]).abs().max()))
    hits = int((pt[0][m] < float("inf")).sum())
    print(f"[kernels] {tag}: {int(m.sum())} alive lanes, {hits} hits, "
          f"equal (max abs err {err})")
    return err


def _capture_calls(name, picks, run):
    """Run `run()` with `kernels.traverse.<name>` wrapped, and return the
    (args, kw) of its calls numbered `picks` (from 0, in launch order; None:
    every call), as the renderer made them."""
    from raytracing_tpu_torch.kernels import traverse as T

    fn = getattr(T, name)
    seen, calls = [0], {}

    def wrapped(*args, **kw):
        if picks is None or seen[0] in picks:
            calls[seen[0]] = (args, dict(kw))
        seen[0] += 1
        return fn(*args, **kw)

    setattr(T, name, wrapped)
    try:
        run()
    finally:
        setattr(T, name, fn)
    picks = range(seen[0]) if picks is None else picks
    _require(len(calls) == len(picks),
             f"{name}: calls {list(picks)} asked for, {seen[0]} made")
    return [calls[k] for k in picks]


def _tile_alive_lanes(pack, ray_tile=1024):
    return (pack[7] != 0).reshape(-1, ray_tile).sum(dim=1)


def _list_stats(cnt, alive_lanes):
    """The spread of a refinement's work over its tiles: listed candidates
    per tile (max, mean, 99th percentile) and alive lanes per tile (min,
    mean, max, tiles with 1-31), over the tiles with an alive lane."""
    import torch

    live = alive_lanes > 0
    c = cnt[live].double()
    a = alive_lanes[live].double()
    if not bool(live.any()):
        return "no tile has an alive lane"
    return (f"{int(live.sum())} of {cnt.numel()} tiles alive; listed per "
            f"tile max {int(c.max())}, mean {float(c.mean()):.1f}, p99 "
            f"{float(torch.quantile(c, 0.99)):.1f}, total {int(c.sum())}; "
            f"alive lanes per tile min {int(a.min())}, mean "
            f"{float(a.mean()):.1f}, max {int(a.max())}, "
            f"{int(((a > 0) & (a < 32)).sum())} tiles with 1-31")


def _timed_walk(rows, name, tag, T, args, kw, alive, ops_per_test, shape,
                nearest=True, plain_reps=5, kernel="walk"):
    """Compare one pack walk launch (`walk`, `walk_gstream` or `walk_wq`)
    with its plain version, then time both and reckon the launch's bound
    from the visits it made. Returns the kernel's result."""
    import torch

    fn, plain = getattr(T, kernel), getattr(T, kernel + "_plain")
    rp, ids, cnt, geo, attr, n_attrs, cs = args[:7]
    if kernel == "walk_wq":  # no early exit: every listed visit is made
        visits, tile_visits, out = cnt, cnt, fn(*args, **kw)
    else:
        visits = torch.zeros(cnt.shape, dtype=torch.int32, device=rp.device)
        out = fn(*args, **kw, visits=visits)
        # K3 lists per (group, tile): a tile's visits are its groups' sum.
        tile_visits = visits if visits.dim() == 1 else visits.sum(dim=0)
    want, plain_ms = _timed_once(lambda: plain(*args))
    err = _compare_walk(tag, out, want, alive, nearest)
    del want
    tr = args[-1]  # the per-ray limit row, read once
    bound = _walk_bound(tile_visits, _tile_alive_lanes(rp), cnt, geo, attr,
                        n_attrs if nearest else 0, cs, rp.shape[1],
                        rp.numel() * 4 + (0 if tr is None else tr.numel() * 4),
                        ops_per_test, kw.get("tnear") is not None)
    _row(rows, name, err, lambda: fn(*args, **kw), lambda: plain(*args),
         bound,
         f"{shape}, {int(visits.sum())} of {int(cnt.sum())} listed visits",
         plain_reps=plain_reps, plain_ms=plain_ms if plain_reps == 1 else None)
    return out


def _check_repeats(tag, fn, args, kw, alive, reps=10):
    """One launch of a split walk (`walk`, `walk_camera` or
    `walk_gstream`) `reps` times: t, slots and attributes equal on alive
    lanes every time, though the segments race on the early exit and the
    visits they make may differ (a dead lane does not vote, so its result
    is meaningless)."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T

    camera = fn is T.walk_camera
    cnt, cs = (args[5], args[9]) if camera else (args[2], args[6])
    first, made = None, []
    for _ in range(reps):
        visits = torch.zeros(cnt.shape, dtype=torch.int32, device=cnt.device)
        t, s, a = fn(*args, **kw, visits=visits)
        made.append(int(visits.sum()))
        out = (t[0][alive], s[0][alive]) + (() if a is None
                                            else (a[:, alive],))
        first = first or out
        _require(all(torch.equal(x, y) for x, y in zip(out, first)),
                 f"{tag}: launch {len(made)} differs from the first")
    if camera:
        seg = T._camera_grid(args[3], args[1].ray_tile, args[4].shape[1],
                             cs)[0]
    elif fn is T.walk_gstream:
        seg = T._gstream_grid(cnt.shape[1], *args[1].shape[::2], cs)[0]
    else:
        seg = T._walk_segment(cs)
    split = int((cnt > seg).sum())
    print(f"[kernels] {tag}: {reps} launches equal (t, slots"
          f"{'' if a is None else ', attributes'} on {int(alive.sum())} "
          f"alive lanes); {split} of {cnt.numel()} lists split over blocks; "
          f"visits made {min(made)}-{max(made)} of {int(cnt.sum())} listed")


def phase_kernels():
    import torch

    from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                      build_default_scene)
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.models import whitted
    from raytracing_tpu_torch.models.camera import (block_ray_ids,
                                                    camera_rays_for_ids)
    from raytracing_tpu_torch.ops.intersect import INF
    from raytracing_tpu_torch.ops.linalg import dot, normalize

    dev = "cuda"
    cfg = RenderConfig()
    scene = build_default_scene(device=dev)
    acc16 = build_cluster_accel(scene.mesh, cluster_size=16)
    acc128 = build_cluster_accel(scene.mesh, cluster_size=128)
    eps = cfg.eps
    na = acc16.attr_blocks.shape[1]
    rows = {}

    # Primary chunk through the `_walk_groups` entry (K1), with the very
    # lists, tables and early-exit settings the renderer launches.
    o, d = camera_rays_for_ids(
        block_ray_ids(KERNEL_CHUNK, cfg.chunk_size, cfg, device=dev), cfg)
    rp = T.rays_to_soa(o, d)
    args, kw = T._groups_walk_args(acc16, rp, eps, True, INF, na)
    _timed_walk(rows, "walk", "walk (K1) primary nearest+attrs", T, args, kw,
                rp[7] != 0, OPS_PMT,
                f"{rp.shape[1]} rays, {acc16.num_clusters}x16")
    # The same chunk with the origin folded into the table (pmto).
    pargs, pkw = T._groups_walk_args(
        acc16, rp, eps, True, INF, na,
        shared_origin=torch.zeros(3, device=dev))
    _timed_walk(rows, "walk_pmto", "walk (K1) primary, origin-folded", T,
                pargs, pkw, rp[7] != 0, OPS_PMTO,
                f"{rp.shape[1]} rays, {acc16.num_clusters}x16, pmto")

    # Primary sun shadows (occlusion) through the same entry.
    t, s, a = T._merge_rest_nearest(acc16, rp, *T.walk(*args, **kw), eps, na)
    hit = torch.isfinite(t[0])
    n = a[0:3].T
    pos = o + torch.where(hit, t[0], 1.0)[:, None] * d + n * cfg.normal_offset
    sun_dir = normalize(scene.sun - pos, eps=1e-20)
    sh = T.rays_to_soa(pos, sun_dir, alive=hit & (dot(n, sun_dir) > 0.0))
    sargs, skw = T._groups_walk_args(acc16, sh, eps, False, INF, 0)
    _compare_walk("walk (K1) primary shadows", T.walk(*sargs, **skw),
                  T.walk_plain(*sargs), sh[7] != 0, False)

    # The chunk's depth-2 wavefront: K6, K5 and the `_walk_dma` entry (K2).
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    ob, db, ab = whitted.bounce_wavefront(
        scene.mesh, acc16, scene.sun, o, d, cfg,
        lambda depth, shape: torch.rand(shape, generator=gen, device=dev))
    bp, nb = T._pad_rays_soa(T.rays_to_soa(ob, db, alive=ab))
    print(f"[kernels] depth-2 wavefront: {nb} rays, {int(ab.sum())} alive")
    lo, hi = T.tile_extents(bp)
    plo, phi = T.tile_extents_plain(bp)
    _require(torch.equal(lo, plo) and torch.equal(hi, phi),
             "extents (K6): lo/hi differ")
    live = phi[:, 7] > 0
    err = float(torch.cat([(lo - plo)[live], (hi - phi)[live]]).abs().max()
                ) if live.any() else 0.0
    nt = bp.shape[1] // T.RAY_TILE
    print(f"[kernels] extents (K6): {nt} tiles, equal")
    _row(rows, "extents", err, lambda: T.tile_extents(bp),
         lambda: T.tile_extents_plain(bp),
         _bound(OPS_EXTENTS * bp.shape[1], bp.numel() * 4 + nt * 64),
         f"{bp.shape[1]} rays")
    tile_alive = hi[:, 7] > 0.0
    c128 = acc128.num_clusters
    rargs = (bp, acc128.cluster_min, acc128.cluster_max)
    pent = T.refine_dense_plain(*rargs, tile_alive=tile_alive)
    ms, by, tests = _refine_bound(
        _tile_alive_lanes(bp), torch.full_like(tile_alive, c128,
                                               dtype=torch.int32) * tile_alive,
        pent.sum(dim=1), bp, c128, c128)
    ent = T.refine_dense(*rargs, tile_alive=tile_alive)
    bad = int((ent != pent).sum())
    _require(bad == 0, f"refine (K5): {bad} entered bits differ")
    spread = _list_stats(tile_alive * c128, _tile_alive_lanes(bp))
    print(f"[kernels] refine (K5 dense): {int(pent.sum())} of {pent.numel()} "
          f"bits set, equal; {spread}; (ray, box) tests the bound counts: "
          f"{tests}")
    _row(rows, "refine", float(bad),
         lambda: T.refine_dense(*rargs, tile_alive=tile_alive),
         lambda: T.refine_dense_plain(*rargs, tile_alive=tile_alive),
         (ms, by), f"{bp.shape[1]} rays, {c128} clusters, tile-alive flags "
         f"given")
    # The dense query as `_refined_lists` launches it: K6's extents and the
    # entered bits in one launch, the tile-alive flag from its own extents.
    flo, fhi, fent = T.refine_dense_extents(*rargs)
    _require(torch.equal(flo, plo) and torch.equal(fhi, phi)
             and torch.equal(fent, pent),
             "refine_dense_extents (K5 dense + K6): extents or bits differ "
             "from tile_extents_plain / refine_dense_plain")
    print("[kernels] refine_dense_extents (K5 dense + K6): extents and bits "
          "equal")
    _row(rows, "refine_extents", err, lambda: T.refine_dense_extents(*rargs),
         lambda: T.refine_dense_extents_plain(*rargs),
         _bound(OPS_SLAB * tests + OPS_EXTENTS * bp.shape[1],
                bp.numel() * 4 + c128 * 24 + nt * 64 + nt * c128 * 4),
         f"{bp.shape[1]} rays, {c128} clusters, the extents and the bits")
    balive = bp[7] != 0
    early = True if cfg.gi_early_exit else None  # as render_rays asks
    dargs, dkw = T._dma_walk_args(acc128, bp, eps, True, INF, na,
                                  early_exit=early)
    _timed_walk(rows, "walk_dma", "walk_dma (K2) bounce nearest+attrs", T,
                dargs, dkw, balive, OPS_PMT,
                f"{bp.shape[1]} rays, {c128}x128")
    # The wavefront's own rays as an occlusion query through K2.
    oargs, okw = T._dma_walk_args(acc128, bp, eps, False, INF, 0)
    k2_occ = T.walk(*oargs, **okw)
    _compare_walk("walk_dma (K2) bounce occlusion", k2_occ,
                  T.walk_plain(*oargs), balive, False)

    # 3d. Per-ray t_max: the chunk's area-light shadow query (one sample of
    # `area_light_term` at the primary hits) through both pack entries.
    lights = _light(dev)
    gen.manual_seed(3)
    w_dir, ndl, l_alive, t_stop = whitted.light_shadow_rays(
        whitted.light_cone(lights, 0, pos), pos, n, hit,
        torch.rand((pos.shape[0], 2), generator=gen, device=dev))
    lp = T.rays_to_soa(pos, w_dir, alive=l_alive)
    row = t_stop[None].contiguous()
    for name, make, acc in (("walk_tmax", T._groups_walk_args, acc16),
                            ("walk_dma_tmax", T._dma_walk_args, acc128)):
        largs, lkw = make(acc, lp, eps, False, INF, 0, tmax_row=row)
        occ = _timed_walk(
            rows, name, f"{lkw['entry']} light shadows, per-ray t_max", T,
            largs, lkw, lp[7] != 0, OPS_PMT,
            f"{lp.shape[1]} rays, {acc.num_clusters}x{acc.cluster_size}, "
            f"occlusion under tmax_row", nearest=False)
        # What the row costs: the same lists under the scalar limit (no
        # row is read; neither launch can exit early).
        scalar = largs[:-1] + (None,)
        print(f"[kernels] {lkw['entry']} light shadows on the same lists "
              f"under a scalar t_max: "
              f"{_median_ms(lambda: T.walk(*scalar, **lkw)):.4f} ms "
              f"(under the row: "
              f"{_median_ms(lambda: T.walk(*largs, **lkw)):.4f} ms)")
        # Nothing lies beyond this light, so its limits hide no occluder;
        # limits cut to a random share of themselves do, and the kernel
        # still equals its plain version.
        cut = (row * torch.rand(row.shape, generator=gen, device=dev)
               ).contiguous()
        cargs, ckw = make(acc, lp, eps, False, INF, 0, tmax_row=cut)
        occ_cut = T.walk(*cargs, **ckw)
        _compare_walk(f"{lkw['entry']} light shadows, limits cut short",
                      occ_cut, T.walk_plain(*cargs), lp[7] != 0, False)
        n_lim, n_cut = (int(x[1][0][lp[7] != 0].sum()) for x in (occ, occ_cut))
        _require(0 < n_cut < n_lim, f"{name}: {n_lim} occluded under the "
                 f"light's limits, {n_cut} under the cut ones")

    # 3f. K4 on the very lists the walk_dma row is timed on.
    wargs, wkw = T._wq_walk_args(acc128, bp, eps, True, INF, na)
    _require(torch.equal(wargs[1], dargs[1]) and torch.equal(wargs[2],
                                                             dargs[2]),
             "walk_wq (K4): not the lists of the walk_dma row")
    k4 = _timed_walk(rows, "walk_wq", "walk_wq (K4) bounce nearest+attrs", T,
                     wargs, wkw, balive, OPS_PMT,
                     f"{bp.shape[1]} rays, {c128}x128, {wkw['u']} visits per "
                     f"work item", plain_reps=1, kernel="walk_wq")
    _compare_walk("walk_wq (K4) vs walk_dma (K2), nearest+attrs", k4,
                  T.walk(*dargs, **dkw), balive, True)
    noexit = dict(dkw, tnear=None, bbox=None)
    print(f"[kernels] walk_dma (K2) on the same lists: "
          f"{_median_ms(lambda: T.walk(*dargs, **dkw)):.4f} ms with its "
          f"early exit, {_median_ms(lambda: T.walk(*dargs, **noexit)):.4f} "
          f"ms without, walk_wq (K4) "
          f"{_median_ms(lambda: T.walk_wq(*wargs, **wkw)):.4f} ms")
    # 3g. The racing exit: the same bits at every launch.
    _require(dkw["tnear"] is not None, "the walk_dma row runs without exit")
    _check_repeats("walk_dma (K2) bounce nearest+attrs", T.walk, dargs, dkw,
                   balive)
    fargs, fkw = T._groups_walk_args(acc16, rp, eps, True, INF, na,
                                     early_exit=True)
    _check_repeats("walk (K1) primary nearest+attrs, exit forced", T.walk,
                   fargs, fkw, rp[7] != 0)
    fargs, fkw = T._groups_walk_args(acc16, lp, eps, True, INF, na,
                                     early_exit=True)
    _require(fkw["tnear"] is not None
             and int(fargs[2].max()) > 2 * T._walk_segment(16),
             "the long-list query does not split its lists")
    _compare_walk("walk (K1) nearest over the light-shadow lists, exit "
                  "forced", T.walk(*fargs, **fkw), T.walk_plain(*fargs),
                  lp[7] != 0, True)
    _check_repeats("walk (K1) nearest over the light-shadow lists, exit "
                   "forced", T.walk, fargs, fkw, lp[7] != 0)
    fnoexit = dict(fkw, tnear=None, bbox=None)
    print(f"[kernels] walk (K1) on those lists: "
          f"{_median_ms(lambda: T.walk(*fargs, **fkw)):.4f} ms with the "
          f"exit, {_median_ms(lambda: T.walk(*fargs, **fnoexit)):.4f} ms "
          f"without")
    brow = torch.linspace(0.5, 30.0, bp.shape[1], device=dev)[None]
    for tag, trow in (("scalar t_max", None), ("per-ray t_max", brow)):
        a4, k4kw = T._wq_walk_args(acc128, bp, eps, False, 30.0, 0,
                                   tmax_row=trow)
        a2, k2kw = T._dma_walk_args(acc128, bp, eps, False, 30.0, 0,
                                    tmax_row=trow)
        k4o = T.walk_wq(*a4, **k4kw)
        _compare_walk(f"walk_wq (K4) occlusion, {tag}, vs plain", k4o,
                      T.walk_wq_plain(*a4), balive, False)
        _compare_walk(f"walk_wq (K4) occlusion, {tag}, vs walk_dma (K2)",
                      k4o, T.walk(*a2, **k2kw), balive, False)
    # A tile with no visits reads miss / not occluded.
    bp0 = bp.clone()
    bp0[7, -T.RAY_TILE:] = 0.0
    dead = slice(bp0.shape[1] - T.RAY_TILE, bp0.shape[1])
    z4, zkw = T._wq_walk_args(acc128, bp0, eps, True, INF, na)
    _require(int(z4[2][-1]) == 0, "walk_wq (K4): the dead tile lists visits")
    zt, zs, za = T.walk_wq(*z4, **zkw)
    zo = T.walk_wq(*T._wq_walk_args(acc128, bp0, eps, False, INF, 0)[0])
    _require(bool(torch.isinf(zt[0, dead]).all())
             and bool((zs[0, dead] == 2 ** 30).all())
             and not bool(za[:, dead].any()) and not bool(zo[1][0, dead].any()),
             "walk_wq (K4): a tile with no visits does not read miss / not "
             "occluded")
    print("[kernels] walk_wq (K4): a tile with no visits reads miss / not "
          "occluded")
    for entry, make, acc in (("walk", T._groups_walk_args, acc16),
                             ("walk_dma", T._dma_walk_args, acc128)):
        zargs, zkw = make(acc, bp0, eps, True, INF, na)
        _require(int(zargs[2][-1]) == 0, f"{entry}: the dead tile lists "
                 "visits")
        zt, zs, za = T.walk(*zargs, **zkw)
        oargs0, okw0 = make(acc, bp0, eps, False, INF, 0)
        zo = T.walk(*oargs0, **okw0)
        _require(bool(torch.isinf(zt[0, dead]).all())
                 and bool((zs[0, dead] == 2 ** 30).all())
                 and not bool(za[:, dead].any())
                 and not bool(zo[1][0, dead].any()),
                 f"{entry}: a tile with no visits does not read miss / not "
                 "occluded")
        print(f"[kernels] {entry}: a tile with no visits reads miss / not "
              f"occluded")
    return rows


def _light(dev):
    import torch

    from raytracing_tpu_torch import SphereLight

    c, r, e = LIGHT
    return SphereLight(torch.tensor([c]), torch.tensor([r]),
                       torch.tensor([e])).to(dev)


def _refine_bound(alive_lanes, listed, entered, pack, width, n_clusters):
    """Bound of one refinement launch: a candidate that no lane enters
    needs every alive lane tested, an entered one a single witness; the
    pack, the lists and the AABB table read once, the bits written once.
    Returns (ms, what bounds it, the (ray, box) tests counted)."""
    tests = float(((listed - entered).double() * alive_lanes.double()
                   + entered.double()).sum())
    nbytes = (pack.numel() * 4 + float(listed.sum()) * 4 + listed.numel() * 4
              + n_clusters * 24 + listed.numel() * width * 4)
    return _bound(OPS_SLAB * tests, nbytes) + (tests,)


def _listed(ids, cnt, n_clusters):
    """[nt, C] bool: the clusters each tile lists."""
    import torch

    listed = torch.arange(ids.shape[1], device=ids.device)[None] < cnt[:, None]
    out = torch.zeros((ids.shape[0], n_clusters), dtype=torch.bool,
                      device=ids.device)
    return out.scatter_(1, ids.long(), listed)


def _reference_camera(dev):
    """The reference frame's camera, offsets and materialised ray pack."""
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.models.camera import (block_ray_ids,
                                                    camera_rays_for_ids)
    from raytracing_tpu_torch.ops.sampling import stratified_offsets

    cfg = RenderConfig()
    w, h, spp = cfg.width, cfg.height, cfg.samples_per_pixel
    o, d = camera_rays_for_ids(
        block_ray_ids(0, spp * h * w, cfg, device=dev), cfg)
    return (T.Camera(w, h, spp, cfg.scale, 16, 16),
            stratified_offsets(spp, device=dev), T.rays_to_soa(o, d), cfg.eps)


def _timed_camera(rows, row, args, kw, shape):
    """Compare one camera walk launch with its plain version on every lane,
    time both, and reckon its bound from the visits it made."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T

    offs, cam, _, n_tiles, ids, cnt, geo, attr, na, cs = args[:10]
    visits = torch.zeros(n_tiles, dtype=torch.int32, device=cnt.device)
    kern = T.walk_camera(*args, **kw, visits=visits)
    want, plain_ms = _timed_once(lambda: T.walk_camera_plain(*args))
    every = torch.ones(kern[0].shape[1], dtype=torch.bool, device=cnt.device)
    err = _compare_walk(f"{row} vs plain", kern, want, every, True)
    del want
    full = torch.full((n_tiles,), cam.ray_tile, device=cnt.device)
    bound = _walk_bound(visits, full, cnt, geo, attr, na, cs,
                        n_tiles * cam.ray_tile, offs.numel() * 4, OPS_PMTO,
                        kw["tnear"] is not None)
    _row(rows, row, err, lambda: T.walk_camera(*args, **kw), None, bound,
         f"{shape}, lists {ids.shape[1]} wide, {int(visits.sum())} of "
         f"{int(cnt.sum())} listed visits", plain_ms=plain_ms)
    return err


def _check_camera_frame(rows, row, entry, acc, camera, with_attrs,
                        repeats=False):
    """Camera mode over the whole 800x800x4 frame on `acc`, with the lists
    and tables `nearest_hit_camera_soa` launches: pooled lists against the
    direct ones as sets, the kernel against its plain version lane by lane
    (timed into rows[row]), with `repeats` ten launches equal, and the
    public query against the pack path under shared_origin=0 on all
    2,560,000 rays."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T

    cam, offs, rp, eps = camera
    dev = offs.device
    cs, c = acc.cluster_size, acc.num_clusters
    n_tiles = cam.grid[0] * cam.grid[1]
    na = acc.attr_blocks.shape[1] if with_attrs else 0
    args, kw = T._camera_walk_args(acc, offs, cam, 0, n_tiles, na, eps)
    _require(kw["entry"] == entry, f"{row}: CS {cs} took entry {kw['entry']}")
    ids, cnt = args[4:6]
    if c > T._SUPERTILE_MIN_C:
        d_ids, _, d_cnt = T._visit_lists_from_extents(
            *T._camera_tile_extents(n_tiles, offs, cam), acc.cluster_min,
            acc.cluster_max)
        diff = int((_listed(ids, cnt, c) != _listed(d_ids, d_cnt, c)).sum())
        _require(diff == 0 and torch.equal(cnt, d_cnt),
                 f"{row}: pooled lists differ from the direct ones in "
                 f"{diff} (tile, cluster) entries")
        print(f"[kernels] {row}: pooled lists {tuple(ids.shape)} hold the "
              f"direct lists' {int(cnt.sum())} entries, as sets")
        del d_ids, d_cnt
    _timed_camera(rows, row, args, kw,
                  f"{n_tiles} tiles x {cam.ray_tile} rays, {c}x{cs}")
    if repeats:
        _check_repeats(f"{row} whole frame", T.walk_camera, args, kw,
                       torch.ones(n_tiles * cam.ray_tile, dtype=torch.bool,
                                  device=dev))
    del args, kw
    # The public query against the pack path with the folded origin.
    zero3 = torch.zeros(3, device=dev)
    query = dict(width=cam.width, height=cam.height, spp=cam.spp,
                 scale=cam.scale, eps=eps)
    if with_attrs:
        got = T.nearest_hit_camera_soa(acc, offs, with_attrs=True, **query)
        want = T.nearest_hit_attrs_soa(acc, rp, eps, wq=cs % 128 == 0,
                                       shared_origin=zero3)
    else:  # the pack query names original triangles: map the slots
        t, slot = T.nearest_hit_camera_soa(acc, offs, **query)
        hit = torch.isfinite(t)
        tri = acc.order_ext[torch.where(hit, slot, 0).long()]
        got = (t, torch.where(hit, tri, 0))
        want = T.nearest_hit_soa(acc, rp, eps, shared_origin=zero3)
    bad = [int((g != w_).sum()) for g, w_ in zip(got, want)]
    _require(not any(bad),
             f"{row}: camera mode differs from the pack path under "
             f"shared_origin on {bad} (t, id, attrs) lanes")
    print(f"[kernels] {row}: equal to the pack path under shared_origin=0 "
          f"on {got[0].shape[0]} rays ({int(torch.isfinite(got[0]).sum())} "
          f"hits)")


def phase_kernels_camera(rows):
    """Camera mode on the whole reference frame of the default scene, with
    attributes, through both entries (`_check_camera_frame`)."""
    from raytracing_tpu_torch import build_cluster_accel, build_default_scene

    dev = "cuda"
    scene = build_default_scene(device=dev)
    camera = _reference_camera(dev)
    for row, entry, cs in (("walk_camera", "walk_camera", 16),
                           ("walk_camera_dma_100", "walk_camera_dma", 128)):
        acc = build_cluster_accel(scene.mesh, cluster_size=cs)
        _check_camera_frame(rows, row, entry, acc, camera, True)


def refine_lists_404k(bp, acc128):
    """The gathered refinement's arguments on a 404k wavefront, as
    `_refined_lists` launches it: the narrowed frustum lists over the
    CS=128 accel."""
    from raytracing_tpu_torch.kernels import traverse as T

    ids, _, cnt = T._narrow_lists(*T._tile_visit_lists_soa(
        bp, acc128.cluster_min, acc128.cluster_max))
    return bp, ids, cnt, acc128.cluster_min, acc128.cluster_max


def _timed_refine_lists(rows, name, rargs, what):
    """The gathered refinement (K5) on `rargs` against its plain version:
    bits equal, the spread of its work over the tiles, both timed, the
    bound reckoned from the candidates the plain version keeps."""
    from raytracing_tpu_torch.kernels import traverse as T

    bp, ids, cnt, cmin = rargs[:4]
    c = cmin.shape[0]
    keep = T.refine_lists(*rargs)
    pkeep, plain_ms = _timed_once(lambda: T.refine_lists_plain(*rargs))
    bad = int((keep != pkeep).sum())
    _require(bad == 0, f"{name} (K5 gathered): {bad} bits differ")
    alive = _tile_alive_lanes(bp)
    print(f"[kernels] {name} (K5 gathered), {what}: {c} clusters, lists "
          f"{tuple(ids.shape)}: {int(pkeep.sum())} of {int(cnt.sum())} "
          f"candidates kept, equal; {_list_stats(cnt, alive)}")
    bound = _refine_bound(alive, cnt, pkeep.sum(dim=1), bp, ids.shape[1], c)
    print(f"[kernels] {name}: (ray, box) tests the bound counts: "
          f"{bound[2]}")
    _row(rows, name, float(bad), lambda: T.refine_lists(*rargs), None,
         bound[:2], f"{bp.shape[1]} rays, {c} clusters, lists "
         f"{ids.shape[1]} wide", plain_ms=plain_ms)


def _wavefront_404k(scene, acc64):
    """The depth-2 wavefront of chunk LARGE_KERNEL_CHUNK of the 404k
    scene's Whitted frame (seeded), padded to whole tiles: (pack, rays,
    alive rays)."""
    import torch

    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.models import whitted
    from raytracing_tpu_torch.models.camera import (block_ray_ids,
                                                    camera_rays_for_ids)

    cfg = RenderConfig()
    dev = scene.mesh.verts.device
    o, d = camera_rays_for_ids(
        block_ray_ids(LARGE_KERNEL_CHUNK, cfg.chunk_size, cfg, device=dev),
        cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    ob, db, ab = whitted.bounce_wavefront(
        scene.mesh, acc64, scene.sun, o, d, cfg,
        lambda depth, shape: torch.rand(shape, generator=gen, device=dev))
    bp, nb = T._pad_rays_soa(T.rays_to_soa(ob, db, alive=ab))
    n_alive = int(ab.sum())
    _require(n_alive > nb // 4,
             f"404k depth-2 wavefront: only {n_alive} of {nb} alive")
    return bp, nb, n_alive


def phase_kernels_large(rows):
    """The gathered refinement and the `_walk_dma` entry above 512
    clusters: the busiest chunk's depth-2 wavefront of the 404k-triangle
    subdivided teapot against its CS=128 bounce accel. Returns the scene
    and its accels for the later phases, with their build times."""
    from raytracing_tpu_torch import RenderConfig, build_cluster_accel
    from raytracing_tpu_torch.geometry.mesh import Scene
    from raytracing_tpu_torch.geometry.scene import (subdivided_teapot_mesh,
                                                     sun_position)
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.ops.intersect import INF

    dev = "cuda"
    cfg = RenderConfig()
    t0 = time.perf_counter()
    mesh = subdivided_teapot_mesh(levels=3, device=dev)
    t1 = time.perf_counter()
    acc64 = build_cluster_accel(mesh, cluster_size=64, variants=("pmt",))
    t2 = time.perf_counter()
    acc128 = build_cluster_accel(mesh, cluster_size=128, variants=("pmt",))
    t3 = time.perf_counter()
    built = dict(tris=mesh.num_triangles, mesh_s=t1 - t0, accel_s=t2 - t1,
                 gi_accel_s=t3 - t2)
    print(f"[large] 404k: {mesh.num_triangles} triangles, mesh {t1 - t0} s, "
          f"CS 64 accel ({acc64.num_clusters} clusters) {t2 - t1} s, CS 128 "
          f"accel ({acc128.num_clusters} clusters) {t3 - t2} s")
    scene = Scene(mesh=mesh, sun=sun_position(0.0).to(dev))
    bp, nb, n_alive = _wavefront_404k(scene, acc64)
    c = acc128.num_clusters
    _timed_refine_lists(rows, "refine_lists", refine_lists_404k(bp, acc128),
                        f"the 404k wavefront ({n_alive} of {nb} rays alive)")
    na = acc128.attr_blocks.shape[1]
    dargs, dkw = T._dma_walk_args(acc128, bp, cfg.eps, True, INF, na,
                                  early_exit=True)
    _timed_walk(rows, "walk_dma_404k", "walk_dma (K2) 404k bounce", T, dargs,
                dkw, bp[7] != 0, OPS_PMT, f"{bp.shape[1]} rays, {c}x128",
                plain_reps=1)
    return scene, acc64, acc128, built


def phase_frame_parity():
    import torch

    from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                      build_default_scene)
    from raytracing_tpu_torch.models.whitted import render

    base = RenderConfig(width=64, height=64, samples_per_pixel=1)
    draws = {}

    def uniforms(i, depth, shape):
        if (i, depth) not in draws:
            g = torch.Generator().manual_seed(1000 * i + depth)
            draws[(i, depth)] = torch.rand(shape, generator=g)
        return draws[(i, depth)]

    accs = {}
    for dev in ("cuda", "cpu"):
        scene = build_default_scene(device=dev)
        accs[dev] = (scene, build_cluster_accel(scene.mesh, cluster_size=16))
    for tag, cfg in (("pack-path primaries", base),
                     ("camera-mode primaries",
                      base.replace(primary_shared_origin=True))):
        imgs = []
        for dev, (scene, acc) in accs.items():
            imgs.append(render(scene, cfg, accel=acc, uniforms=lambda i, k, s:
                               uniforms(i, k, s).to(dev)).cpu())
        err = float((imgs[0] - imgs[1]).abs().max())
        _require(torch.isfinite(imgs[0]).all(), "64x64 frame is not finite")
        _require(err <= FRAME_PARITY_ATOL,
                 f"64x64 frame, {tag}: card vs CPU max abs {err} > "
                 f"{FRAME_PARITY_ATOL}")
        print(f"[parity] 64x64x1spp full depth, {tag}: card vs CPU plain "
              f"path max abs {err} (limit {FRAME_PARITY_ATOL})")


def _timed_frames(scene, cfg, accel, reps, gi_accel=None, pt=None):
    """One frame with the launch counts reset and the queries counted, then
    `reps` timed frames: the Whitted renderer, or with `pt` (a
    PathTracerConfig) the path tracer. The alive lanes are summed on the
    device, without a host sync, so the counted frame runs as any other.
    Returns (img, launches, counts, first, times)."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.models import path_tracer, whitted

    sync = torch.cuda.synchronize
    queried = {"nearest": 0, "shadow": 0}
    alive_sums = {"nearest": torch.zeros((), dtype=torch.int64, device="cuda"),
                  "shadow": torch.zeros((), dtype=torch.int64, device="cuda")}
    nearest, any_hit = whitted.nearest_hit_shaded, whitted.any_hit
    camera = whitted.nearest_hit_shaded_camera

    def count(kind, n, alive):
        queried[kind] += n
        alive_sums[kind] += n if alive is None else alive.sum()

    def counted_nearest(acc, o, d, config, alive=None, **kw):
        count("nearest", o.shape[0], alive)
        return nearest(acc, o, d, config, alive=alive, **kw)

    def counted_camera(acc, offs, config, tile_base, tiles, bh, bw):
        count("nearest", tiles * config.samples_per_pixel * bh * bw, None)
        return camera(acc, offs, config, tile_base, tiles, bh, bw)

    def counted_any(acc, o, d, config, alive=None, **kw):
        count("shadow", o.shape[0], alive)
        return any_hit(acc, o, d, config, alive=alive, **kw)

    def frame():
        if pt is not None:
            return path_tracer.render(scene, cfg, pt, accel=accel,
                                      gi_accel=gi_accel)
        return whitted.render(scene, cfg, accel=accel, gi_accel=gi_accel)

    whitted.nearest_hit_shaded, whitted.any_hit = counted_nearest, counted_any
    whitted.nearest_hit_shaded_camera = counted_camera
    path_tracer.nearest_hit_shaded = counted_nearest
    try:
        sync()
        T.reset_launches()
        t0 = time.perf_counter()
        img = frame()
        sync()
        first = time.perf_counter() - t0
        launches = dict(T.LAUNCHES)
        counts = dict(queried)
        for kind, total in alive_sums.items():
            counts[kind + "_alive"] = int(total)
    finally:
        whitted.nearest_hit_shaded, whitted.any_hit = nearest, any_hit
        whitted.nearest_hit_shaded_camera = camera
        path_tracer.nearest_hit_shaded = nearest
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        img = frame()
        sync()
        times.append(time.perf_counter() - t0)
    _require(img.shape == (cfg.height, cfg.width, 3), f"shape {img.shape}")
    _require(bool(torch.isfinite(img).all()), "frame not finite")
    return img, launches, counts, first, times


def _print_frame(tag, cfg, img, launches, counts, first, times):
    spf = statistics.median(times) if times else first
    alive = counts["nearest_alive"] + counts["shadow_alive"]
    lanes = counts["nearest"] + counts["shadow"]
    print(f"[frame] {tag} {cfg.width}x{cfg.height}x{cfg.samples_per_pixel}"
          f"spp: first frame {first} s, then "
          f"{', '.join(map(str, times)) or 'none'} s (median {spf} s)")
    # Dead lanes (rays that left the scene) cost almost nothing, so the
    # rate counts alive rays only.
    print(f"[frame] {tag} alive ray queries per frame: {alive} "
          f"({counts['nearest_alive']} nearest + {counts['shadow_alive']} "
          f"shadow) -> {alive / spf} alive queries/s; lanes submitted, dead "
          f"included: {lanes} ({counts['nearest']} nearest + "
          f"{counts['shadow']} shadow)")
    print(f"[frame] {tag} launches per frame: {launches}; mean "
          f"{float(img.mean())}")


def phase_reference_frame(rows):
    """The default reference frame (pack-path primaries), then the same
    frame with camera-mode primaries, whose `walk_camera` launch of chunk
    KERNEL_CHUNK (64 tiles) is then timed at that shape (rows
    "walk_camera_chunk") and launched 10 times. Returns both launch
    counts."""
    import torch

    from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                      build_default_scene)
    from raytracing_tpu_torch.kernels import traverse as T

    cfg = RenderConfig()
    scene = build_default_scene(device="cuda")
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    sky = torch.tensor([0x87, 0xCE, 0xEB], dtype=torch.float32) / 255.0
    sky = sky ** (1 / 2.2)
    out = []
    imgs = []
    for tag, c, need in (
            ("reference frame", cfg,
             ("walk", "walk_dma", "refine_extents", "extents")),
            ("reference frame, camera-mode primaries",
             cfg.replace(primary_shared_origin=True),
             ("walk_camera", "walk", "walk_dma", "refine_extents",
              "extents"))):
        camera_mode = c.primary_shared_origin
        frame = []
        chunk = _capture_calls(
            "walk_camera", [KERNEL_CHUNK] if camera_mode else [],
            lambda: frame.append(_timed_frames(scene, c, accel, 2)))
        img, launches, counts, first, times = frame[0]
        err = float((img[2, 2].cpu() - sky).abs().max())
        _require(err <= SKY_ATOL, f"{tag}: sky pixel off by {err}")
        for k in need:
            _require(launches[k] > 0,
                     f"kernel {k} was not launched by the {tag}")
        _print_frame(tag, c, img, launches, counts, first, times)
        out.append(launches)
        imgs.append(img)
    (cargs, ckw), = chunk
    _timed_camera(rows, "walk_camera_chunk", cargs, ckw,
                  f"the camera-mode frame's chunk {KERNEL_CHUNK}: "
                  f"{cargs[3]} tiles x {cargs[1].ray_tile} rays, "
                  f"{accel.num_clusters}x16, A = {cargs[8]}")
    _check_repeats("walk_camera (K1 camera), the frame's chunk",
                   T.walk_camera, cargs, ckw,
                   torch.ones(cargs[3] * cargs[1].ray_tile, dtype=torch.bool,
                              device="cuda"))
    del chunk, cargs, ckw
    diff = (imgs[0] - imgs[1]).abs()
    print(f"[frame] camera-mode vs pack-path primaries (pmto vs pmt, other "
          f"uniforms): {int((diff.amax(dim=2) > 1e-3).sum())} of "
          f"{diff.shape[0] * diff.shape[1]} pixels differ by more than 1e-3")
    return out


def _camera_rate(accel, w, h, spp, gate, iters, tag):
    """Primary rays/s of `nearest_hit_camera_soa`: `iters` calls chained
    through the offsets (each call's result perturbs the next one's, as
    the JAX benchmark chains them), CUDA events, best of 3."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.ops.sampling import stratified_offsets

    offs0 = stratified_offsets(spp, device="cuda")
    n = w * h * spp

    def frame(state):
        t, _ = T.nearest_hit_camera_soa(accel, offs0 + state * 1e-12,
                                        width=w, height=h, spp=spp)
        hit = torch.isfinite(t)
        return torch.where(hit, t, 0.0).sum() * 1e-20, hit.sum()

    state, hits = frame(torch.zeros((), device="cuda"))
    frac = int(hits) / n
    _require(gate[0] < frac < gate[1],
             f"{tag}: implausible hit fraction {frac}")
    best = float("inf")
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        st = state
        a.record()
        for _ in range(iters):
            st, _ = frame(st)
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / 1e3 / iters)
    print(f"[{tag}] {w}x{h}x{spp}spp, {accel.num_clusters} clusters of "
          f"{accel.cluster_size}: hit fraction {frac}, {best} s per call "
          f"(best of 3 x {iters}) -> {n / best} primary rays/s")
    return n / best


def phase_headline():
    from raytracing_tpu_torch import build_cluster_accel, build_default_scene

    scene = build_default_scene(device="cuda")
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    return _camera_rate(accel, 800, 800, 4, HIT_GATE, 20, "headline")


def phase_large_scenes(rows, scene404, acc64, gi128, built404):
    """Camera-mode primary rays/s at 404k (CS 64), 1.6M and 6.4M (CS 128)
    triangles, each held first against its plain version and the pack path
    at that very shape (`_check_camera_frame`; the 1.6M launch is the
    `walk_camera_dma` row), one Whitted frame of the 1.6M scene (its
    chunk-12 K3 launches and its busiest gathered refinement, the
    `refine_lists_1m6` row, kept and timed) and one of the 404k scene.
    Returns the launches of the 1.6M camera query, of the 404k frame, of
    the 1.6M pack query and of the 1.6M frame."""
    import torch

    from raytracing_tpu_torch import RenderConfig, build_cluster_accel
    from raytracing_tpu_torch.geometry.mesh import Scene
    from raytracing_tpu_torch.geometry.scene import (subdivided_teapot_mesh,
                                                     sun_position)
    from raytracing_tpu_torch.kernels import traverse as T

    print(f"[large] 404k: mesh_gen {built404['mesh_s']} s, accel_build "
          f"{built404['accel_s']} s")
    camera = _reference_camera("cuda")
    _check_camera_frame(rows, "walk_camera_404k", "walk_camera", acc64,
                        camera, False)
    _camera_rate(acc64, 800, 800, 4, HIT_GATE_LARGE, 10, "large 404k")

    rate_launches = gstream_launches = frame_launches = None
    for levels, tag, iters in ((4, "1m6", 10), (5, "6m4", 5)):
        t0 = time.perf_counter()
        mesh = subdivided_teapot_mesh(levels=levels, device="cuda")
        t1 = time.perf_counter()
        acc = build_cluster_accel(mesh, cluster_size=128, variants=("pmt",))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"[large] {tag}: {mesh.num_triangles} triangles, mesh_gen "
              f"{t1 - t0} s, accel_build {t2 - t1} s "
              f"({acc.num_clusters} clusters)")
        _check_camera_frame(rows, "walk_camera_dma" if levels == 4
                            else f"walk_camera_dma_{tag}", "walk_camera_dma",
                            acc, camera, False, repeats=levels == 4)
        # The pack-path query of that check, as a main path of K3.
        T.reset_launches()
        t_pack, _ = T.nearest_hit_soa(acc, camera[2], camera[3],
                                      shared_origin=torch.zeros(3,
                                                                device="cuda"))
        groups = -(-acc.num_clusters // T._group_clusters(acc, 0))
        _require(T.LAUNCHES["walk_gstream"] == 1 and T.LAUNCHES["walk"] == 0,
                 f"the {tag} pack-path query did not run K3: {T.LAUNCHES}")
        print(f"[large {tag}] pack-path query nearest_hit_soa: walk_gstream "
              f"(K3) over {groups} groups, "
              f"{int(torch.isfinite(t_pack).sum())} hits")
        if levels == 5:
            zero3 = torch.zeros(3, device="cuda")
            na = acc.attr_blocks.shape[1]
            args, kw = T._gstream_walk_args(acc, camera[2], camera[3], True,
                                            T.INF, na, shared_origin=zero3)
            _timed_walk(rows, "walk_gstream_6m4",
                        "walk_gstream (K3) 6.4M nearest+attrs", T, args, kw,
                        torch.ones(camera[2].shape[1], dtype=torch.bool,
                                   device="cuda"), OPS_PMTO,
                        f"{camera[2].shape[1]} rays, {acc.num_clusters}x128 "
                        f"in {args[1].shape[0]} groups of {args[7]}, A = "
                        f"{na}, pmto", plain_reps=1, kernel="walk_gstream")
            del args, kw
        if levels == 4:
            gstream_launches = dict(T.LAUNCHES)
            _check_gstream(rows, acc, camera)
            # K3 inside a frame: the primary nearest (4 groups) and sun
            # shadow (3 groups) queries of every chunk.
            k = 2 * LARGE_KERNEL_CHUNK  # each chunk: primary, sun shadow
            frame, refines = [], []
            chunk = _capture_calls("walk_gstream", [k, k + 1], lambda:
                                   refines.extend(_capture_calls(
                                       "refine_lists", None, lambda:
                                       frame.append(_timed_frames(
                                           Scene(mesh=mesh, sun=sun_position(
                                               0.0).to("cuda")),
                                           RenderConfig(), acc, 0)))))
            frame = frame[0]
            _require(frame[1]["walk_gstream"] > 0 and frame[1]["walk"] == 0
                     and frame[1]["refine_lists"] > 0,
                     f"the 1.6M Whitted frame's launches: {frame[1]}")
            _print_frame("1.6M Whitted frame", RenderConfig(), *frame)
            frame_launches = frame[1]
            _check_gstream_chunk(rows, chunk)
            # The frame's gathered refinements: the spread of their work,
            # and the busiest launch (most listed candidates) as a row.
            cnt = torch.cat([a[2] for a, _ in refines])
            print(f"[kernels] the 1.6M frame's {len(refines)} refine_lists "
                  f"launches: " + _list_stats(cnt, torch.cat(
                      [_tile_alive_lanes(a[0]) for a, _ in refines])))
            busiest = max(refines, key=lambda call: int(call[0][2].sum()))
            del chunk, refines, cnt
            _timed_refine_lists(rows, "refine_lists_1m6", busiest[0],
                                "the 1.6M frame's busiest launch")
            del busiest
        torch.cuda.reset_peak_memory_stats()
        T.reset_launches()
        _camera_rate(acc, 800, 800, 4, HIT_GATE_LARGE, iters, f"large {tag}")
        print(f"[large {tag}] peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30} GiB")
        _require(T.LAUNCHES["walk_camera_dma"] > 0,
                 f"the {tag} query did not launch walk_camera_dma")
        rate_launches = rate_launches or dict(T.LAUNCHES)
        del acc, mesh

    cfg = RenderConfig()
    img, launches, counts, first, times = _timed_frames(
        scene404, cfg, acc64, 0, gi_accel=gi128)
    for k in ("refine_lists", "walk_dma", "walk", "extents"):
        _require(launches[k] > 0,
                 f"kernel {k} was not launched by the 404k Whitted frame")
    _print_frame("404k Whitted frame", cfg, img, launches, counts, first,
                 times)
    return rate_launches, launches, gstream_launches, frame_launches


def _check_gstream(rows, acc, camera):
    """3e. K3 at the 1.6M-triangle scene on all 2,560,000 pack-path rays
    (the origin folded, as phase 7's pack-path query walks them): the
    kernel against its plain version lane by lane (nearest with the 4
    attribute rows: 4 groups), against the group loop with K1 — t, slots,
    attributes and occlusion flags, with the early exit on and off — and
    its time beside the loop's launches, and at other budgets."""
    import torch

    from raytracing_tpu_torch.accel import packets
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.ops.intersect import INF

    _, _, rp, eps = camera
    dev = rp.device
    zero3 = torch.zeros(3, device=dev)
    na = acc.attr_blocks.shape[1]
    every = torch.ones(rp.shape[1], dtype=torch.bool, device=dev)
    query = (acc, rp, eps, True, INF, na)
    args, kw = T._gstream_walk_args(*query, shared_origin=zero3)
    ng, gsz = args[1].shape[0], args[7]
    print(f"[kernels] walk_gstream (K3): {acc.num_clusters} clusters of "
          f"{acc.cluster_size} with {na} attribute rows at a budget of "
          f"{packets._GROUP_BLOCK_BUDGET_BYTES / 2 ** 20} MiB: {ng} groups "
          f"of {gsz}, early exit {kw['tnear'] is not None}")
    _require(ng == 4 and gsz == 4096, f"1.6M scene: {ng} groups of {gsz}")
    _timed_walk(rows, "walk_gstream", "walk_gstream (K3) 1.6M nearest+attrs",
                T, args, kw, every, OPS_PMTO,
                f"{rp.shape[1]} rays, {acc.num_clusters}x128 in {ng} groups "
                f"of {gsz}, A = {na}, pmto", plain_reps=1,
                kernel="walk_gstream")
    _check_repeats("walk_gstream (K3) 1.6M nearest+attrs", T.walk_gstream,
                   args, kw, every)
    del args, kw
    streamed = T.STREAM_GROUPS
    try:
        for early in (True, False):
            res = {}
            for flag in (True, False):
                T.STREAM_GROUPS = flag
                T.reset_launches()
                res[flag] = T._walk_groups(*query, early_exit=early,
                                           shared_origin=zero3)
                which = "walk_gstream" if flag else "walk"
                _require(T.LAUNCHES[which] == (1 if flag else ng),
                         f"STREAM_GROUPS={flag}: launches {T.LAUNCHES}")
            _compare_walk(f"walk_gstream (K3) vs the K1 group loop, early "
                          f"exit {early}", res[True], res[False], every, True)
        occ = {}
        for flag in (True, False):
            T.STREAM_GROUPS = flag
            occ[flag] = T._walk_groups(acc, rp, eps, False, INF, 0,
                                       shared_origin=zero3)
        _compare_walk("walk_gstream (K3) vs the K1 group loop, occlusion",
                      occ[True], occ[False], every, False)
        del res, occ
        # Times: the whole query either way (extents, lists, launches), and
        # the loop's K1 launches alone beside the one K3 launch.
        for flag in (True, False):
            T.STREAM_GROUPS = flag
            ms = _median_ms(lambda: T._walk_groups(*query,
                                                   shared_origin=zero3))
            print(f"[kernels] 1.6M nearest+attrs query through "
                  f"{'K3' if flag else 'the K1 group loop'}, lists included: "
                  f"{ms:.4f} ms")
        loop = [T._groups_walk_args(*query, shared_origin=zero3,
                                    clusters=(lo, min(lo + gsz,
                                                      acc.num_clusters)))
                for lo in range(0, acc.num_clusters, gsz)]
        ms = _median_ms(lambda: [T.walk(*a, **k) for a, k in loop])
        print(f"[kernels] the K1 group loop's {len(loop)} walk launches "
              f"alone: {ms:.4f} ms (walk_gstream: "
              f"{rows['walk_gstream']['ms']:.4f} ms)")
        # The loop's groups cannot exit on a hit another group found.
        seen = torch.zeros(rp.shape[1] // 1024, dtype=torch.int32, device=dev)
        visited = 0
        for a, k in loop:
            T.walk(*a, visits=seen, **k)
            visited += int(seen.sum())
        print(f"[kernels] the K1 group loop visited {visited} clusters "
              f"({rows['walk_gstream']['shape']})")
        del loop
    finally:
        T.STREAM_GROUPS = streamed
    budget = packets._GROUP_BLOCK_BUDGET_BYTES
    try:
        for mib in (16, 64, 1024):
            packets._GROUP_BLOCK_BUDGET_BYTES = mib * 2 ** 20
            if mib == 1024:  # the whole table in one piece: K1
                a, k = T._groups_walk_args(*query, shared_origin=zero3)
                ms = _median_ms(lambda: T.walk(*a, **k))
                print(f"[kernels] 1.6M, no groups (K1 over the whole "
                      f"table): walk {ms:.4f} ms")
                T.reset_launches()
                one = T._walk_groups(*query, shared_origin=zero3)
                _require(T.LAUNCHES["walk"] == 1
                         and T.LAUNCHES["walk_gstream"] == 0,
                         f"no groups: launches {T.LAUNCHES}")
                ms = _median_ms(lambda: T._walk_groups(*query,
                                                       shared_origin=zero3))
                packets._GROUP_BLOCK_BUDGET_BYTES = budget
                _compare_walk("walk_gstream (K3) vs one K1 launch over the "
                              "whole table",
                              T._walk_groups(*query, shared_origin=zero3),
                              one, every, True)
                k3 = _median_ms(lambda: T._walk_groups(*query,
                                                       shared_origin=zero3))
                print(f"[kernels] 1.6M nearest+attrs query, lists included: "
                      f"one K1 launch over the whole table {ms:.4f} ms, "
                      f"K3 {k3:.4f} ms")
                del one
            else:
                a, k = T._gstream_walk_args(*query, shared_origin=zero3)
                ms = _median_ms(lambda: T.walk_gstream(*a, **k))
                print(f"[kernels] 1.6M at a budget of {mib} MiB: "
                      f"{a[1].shape[0]} groups of {a[7]}, walk_gstream "
                      f"{ms:.4f} ms")
            del a, k
    finally:
        packets._GROUP_BLOCK_BUDGET_BYTES = budget


def _check_gstream_chunk(rows, chunk):
    """K3 at the 1.6M Whitted frame's own shape: the two launches of
    chunk LARGE_KERNEL_CHUNK as the renderer made them (65,536 rays: the
    primary nearest+attrs query, the sun-shadow query) against their plain
    versions, timed, the primary launched 10 times."""
    from raytracing_tpu_torch.kernels import traverse as T

    for (args, kw), row in zip(chunk, ("walk_gstream_chunk",
                                       "walk_gstream_chunk_shadow")):
        rp, nearest, pmto = args[0], args[9], args[11]
        what = "nearest+attrs" if nearest else "sun-shadow occlusion"
        _timed_walk(rows, row, f"walk_gstream (K3), the 1.6M frame's chunk "
                    f"{LARGE_KERNEL_CHUNK}, {what}", T, args, kw, rp[7] != 0,
                    OPS_PMTO if pmto else OPS_PMT,
                    f"{rp.shape[1]} rays, {args[3].shape[0]}x128 in "
                    f"{args[1].shape[0]} groups of {args[7]}, {what}"
                    f"{', pmto' if pmto else ''}", nearest=nearest,
                    plain_reps=1, kernel="walk_gstream")
        if nearest:
            _check_repeats(f"walk_gstream (K3), the 1.6M frame's chunk "
                           f"{LARGE_KERNEL_CHUNK}", T.walk_gstream, args, kw,
                           rp[7] != 0)


def phase_path_traced_frame():
    """8. BASELINE config 3 on the default scene: parity of a small frame
    with the CPU plain path, then one timed full frame (800x800, 64 spp, 4
    bounces) after the counted one. Returns its launches."""
    import torch

    from raytracing_tpu_torch import (PathTracerConfig, RenderConfig,
                                      build_cluster_accel, build_default_scene)
    from raytracing_tpu_torch.models import path_tracer

    small = RenderConfig(width=64, height=64, chunk_size=131072)
    pt_small = PathTracerConfig(max_bounces=4, samples_per_pixel=2)
    draws = {}

    def uniforms(i, s, tag, shape):
        key = (i, s, tag)
        if key not in draws:
            g = torch.Generator().manual_seed(
                100000 * i + 1000 * s + 10 * tag[1] + (tag[0] == "scatter"))
            draws[key] = torch.rand(shape, generator=g)
        return draws[key]

    imgs = []
    for dev in ("cuda", "cpu"):
        scene = build_default_scene(device=dev)
        acc = build_cluster_accel(scene.mesh, cluster_size=16)
        imgs.append(path_tracer.render(
            scene, small, pt_small, accel=acc,
            uniforms=lambda i, s, tag, shape, dev=dev:
            uniforms(i, s, tag, shape).to(dev)).cpu())
    err = float((imgs[0] - imgs[1]).abs().max())
    _require(bool(torch.isfinite(imgs[0]).all()), "64x64 path-traced frame "
             "is not finite")
    _require(err <= FRAME_PARITY_ATOL, f"64x64 path-traced frame: card vs "
             f"CPU max abs {err} > {FRAME_PARITY_ATOL}")
    print(f"[parity] path tracer 64x64, 2 spp, 4 bounces: card vs CPU plain "
          f"path max abs {err} (limit {FRAME_PARITY_ATOL})")

    cfg = RenderConfig(width=800, height=800, chunk_size=131072)
    pt = PathTracerConfig(max_bounces=4, samples_per_pixel=64)
    scene = build_default_scene(device="cuda")
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    img, launches, counts, first, times = _timed_frames(scene, cfg, accel, 1,
                                                        pt=pt)
    sky = (torch.tensor([0x87, 0xCE, 0xEB]) / 255.0) ** (1 / 2.2)
    err = float((img[2, 2].cpu() - sky).abs().max())
    _require(err <= SKY_ATOL, f"path-traced frame: sky pixel off by {err}")
    for k in ("walk", "walk_dma", "refine_extents", "extents"):
        _require(launches[k] > 0,
                 f"kernel {k} was not launched by the path-traced frame")
    paths = cfg.width * cfg.height * pt.samples_per_pixel
    _print_frame(f"path-traced frame, {pt.max_bounces} bounces,",
                 cfg.replace(samples_per_pixel=pt.samples_per_pixel), img,
                 launches, counts, first, times)
    print(f"[frame] path-traced frame: {paths} paths in {times[0]} s (the "
          f"frame after the counted one) -> {paths / times[0]} paths/s")
    return launches


def phase_area_light_frame():
    """9. The reference Whitted frame with one spherical light and 4
    shadow samples (per-ray t_max through the K1 and K2 entries), and the
    same frame with its bounce queries through K4 (`_WQ_IMPL = "grid"`)
    against the default, same seed. Returns the launches of the frame and of
    the K4 frame."""
    import torch

    from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                      build_default_scene)
    from raytracing_tpu_torch.geometry.mesh import Scene
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.models import whitted

    base = build_default_scene(device="cuda")
    scene = Scene(base.mesh, base.sun, _light("cuda"))
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    cfg = RenderConfig(light_samples=4)
    img, launches, counts, first, times = _timed_frames(scene, cfg, accel, 1)
    dark = whitted.render(base, cfg, accel=accel)
    _require(bool((img.mean() > dark.mean())),
             "the light adds no radiance to the frame")
    for k in ("walk", "walk_dma", "refine_extents", "extents"):
        _require(launches[k] > 0,
                 f"kernel {k} was not launched by the area-light frame")
    _print_frame("area-light reference frame", cfg, img, launches, counts,
                 first, times)
    print(f"[frame] area-light frame mean {float(img.mean())} against "
          f"{float(dark.mean())} without the light")

    impl = T._WQ_IMPL
    imgs, secs = {}, {}
    try:
        for which in ("dma", "grid"):
            T._WQ_IMPL = which
            T.reset_launches()
            gen = torch.Generator(device="cuda")
            gen.manual_seed(5)
            t0 = time.perf_counter()
            imgs[which] = whitted.render(scene, cfg, accel=accel,
                                         generator=gen)
            torch.cuda.synchronize()
            secs[which] = time.perf_counter() - t0
            if which == "grid":
                grid_launches = dict(T.LAUNCHES)
            else:
                dma_launches = dict(T.LAUNCHES)
    finally:
        T._WQ_IMPL = impl
    # Every bounce query of the frame goes through K4 and none through K2.
    _require(grid_launches["walk_wq"] == dma_launches["walk_dma"] > 0
             and grid_launches["walk_dma"] == 0,
             f"the grid frame's launches: {grid_launches}")
    bad = int((imgs["grid"] != imgs["dma"]).sum())
    _require(bad == 0, f"area-light reference frame: grid and dma images "
             f"differ in {bad} values")
    print(f"[frame] area-light reference frame, _WQ_IMPL grid vs dma: images "
          f"bit-equal; dma {secs['dma']} s, grid {secs['grid']} s (the grid "
          f"frame is its first); grid launches {grid_launches}")
    return launches, grid_launches


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "raytracing_tpu_torch")):
        print("chip_smoke: raytracing_tpu_torch/ is not beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    t_start = time.perf_counter()
    card = phase_device()
    build_s = phase_build()
    rows = phase_kernels()
    phase_kernels_camera(rows)
    large = phase_kernels_large(rows)
    phase_frame_parity()
    ref_launches, cam_launches = phase_reference_frame(rows)
    phase_headline()
    (rate_launches, big_launches, gstream_launches,
     frame_1m6_launches) = phase_large_scenes(rows, *large)
    pt_launches = phase_path_traced_frame()
    light_launches, grid_launches = phase_area_light_frame()
    if "jax" in sys.modules:
        raise SmokeFailure("jax was imported")
    # Each kernel's launches on the main path that runs it.
    launches = dict(ref_launches)
    launches["walk_camera"] = cam_launches["walk_camera"]
    launches["walk_camera_dma"] = rate_launches["walk_camera_dma"]
    launches["refine_lists"] = big_launches["refine_lists"]
    launches["refine_lists_1m6"] = frame_1m6_launches["refine_lists"]
    launches["walk_gstream"] = gstream_launches["walk_gstream"]
    launches["walk_wq"] = grid_launches["walk_wq"]
    print(f"[done] launches of the path-traced frame {pt_launches}; of the "
          f"area-light frame {light_launches}")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        _require(launches[name] > 0, f"kernel {name} ran on no main path")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": None})
    print(f"[done] build {build_s:.2f} s, total "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
