#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`raytracing_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device — require CUDA; print `nvidia-smi`'s name and power limit;
  2. build  — compile the CUDA kernels from `raytracing_tpu_torch/csrc`
     and the port's host library from
     `raytracing_tpu_torch/native/raytracing_native.cpp`; print every
     kernel's registers, shared memory and spills as `ptxas -v` reports
     them, and refuse a spill in any instance of the split walks
     (`walk.cu`: every intersector family, with and without the lane
     cull; `camera.cu`, `gstream.cu`) and the refinement (`refine.cu`,
     capped or not);
  3. kernels against their plain PyTorch versions, on the card, at the
     main paths' shapes; median time of 5 runs each (K6 also read
     steadily: 200 launches of its entry in one pair of CUDA events
     over copies of its pack in turns, beside the graphed PyTorch
     composite):
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
     h. the walks of a differentiated render: K1 on 3a's chunk and K2 on
        its wavefront carrying the backward's 11 planes beside the
        shading planes (A = 15, rows walk_both_chunk and
        walk_dma_both_chunk; and A = 20 with a color per triangle),
        against their plain versions and against the shading walk (the
        rows of the kernel table come from phase 10's own launches);
     g. the split pack walk (`walk`, K1/K2) under its racing early exit:
        the `_walk_dma` launch of 3a, the primary launch with the exit
        forced and a nearest query with the exit forced over 3d's long
        lists, each launched 10 times, t, slots and attributes equal
        every time on alive lanes, the visits made printed as min-max;
        its time with and without the exit beside K4's; a tile with no
        visits through both entries;
     i. the off-main-path forms (`phase_variants`), each against its
        plain version bit for bit on alive lanes and timed beside the main
        path's form at the same shape: K1 mt and woop on 3a's chunk (CS
        16), K2 mt and K4 mt on 3a's wavefront (CS 128), K3 mt and woop on
        the chunk over the CS 16 table in 4 groups, the capped K2 walk and
        capped K5 dense query on the wavefront under the reference frame's
        cap, the K1 lane-cull walk on the wavefront; then the reference
        frame with gi_cap_frac 0.1 equal to the default frame, and a
        gi_wq=False frame equal with gi_lane_cull on and off;
  4. frame parity — a 64x64 1-spp frame on the card against the same frame
     through the plain CPU path, same uniforms, with pack-path and with
     camera-mode primaries;
  5. the reference frame — 800x800 at 4 spp, default config: one frame
     with launch counts reset, then 2 timed frames (3 before the script
     grew phases 8 and 9); the same with `primary_shared_origin=True`
     (camera-mode primaries), its chunk-20 `walk_camera` launch kept
     for 3b;
  6. headline — `python -m raytracing_tpu_torch bench` in process
     (`raytracing_tpu_torch/bench.py`, which also times the frames, the
     large scenes and the backward of phases 5 and 7-10):
     `nearest_hit_camera_soa` at 800x800x4 on the default scene, CS=16,
     the offsets perturbed by each call's result: primary rays/s, gated
     on a plausible hit fraction;
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
     default from the same seed, bit-equal;
 10. the backward at full width (`bench_suite.py:80-130`): the 262,144
     camera rays of blocks 90-105 of the reference frame through
     `render_rays`, loss sum(rgb^2), gradients for verts, colors and
     materials, on the CS 16 accel, with one area light, and with the CS
     128 bounce accel: forward and forward + backward ms (median of 3),
     their ratio, launches, peak device GiB, every gradient finite and
     nonzero; the K1 primary and first-bounce launches of the CS 16 run
     (rows walk_both and walk_both_bounce) and the first K2 bounce launch
     of the CS 128 run (row walk_dma_both), as the renderer made them,
     against their plain versions and timed;
 11. card against CPU gradients: one `render_rays` over the 1,024 rays of
     a 32x32 frame, each table within GRAD_PARITY_RTOL of its largest
     magnitude;
 12. the inverse fit at `cmd_fit`'s defaults: 20 steps of 4,096 rays,
     Adam at lr 1e-2, from colors x 0.5 toward the port's own 800x800x4
     render; the held-out loss falls, a checkpoint saved at step 10
     loads back bit for bit;
 13. the command line (`python -m raytracing_tpu_torch`) in process at
     full width: `render` of the reference frame through an accel cache,
     built then loaded (the cache equal to a fresh build, both PNGs equal
     to `render()` in u8 bit for bit), `render` at the CLI's defaults
     (its launches are the kernel table's "per CLI render" column; its
     PNG has the sky's colour and the reference frame's mean; its busiest
     K1 and K2 launches and its K5+K6 and K6 launches with the most alive
     lanes, captured, against their plain versions: rows walk_cli,
     walk_dma_cli, refine_extents_cli, extents_cli),
     `render --profile` (the trace names the walk and refinement
     kernels), `fit` at its defaults for 20 steps, then for 60 with a
     checkpoint (the step-50 snapshot holds the live params) and
     `--resume` for 5,
     `animate --frames 3`;
 14. recovery on the card: `device_alive()`, `with_retry` past a real
     out-of-memory error, a retried fit step bit-equal to a clean one;
 15. multi-device and multi-process (`raytracing_tpu_torch/parallel`) at
     full width: `render_sharded` over the card and 4 virtual shards
     against `render()`, 2 processes sharing the card in a gloo group
     (`render --num-processes 2 --assemble`) against one process of 2
     shards, the train step's all_reduce in a one-rank NCCL group, the
     train step over 2 shards at the backward cell's 262,144 rays against
     one `Fitter` step, `dryrun_multichip(1)` and `(2)`, and the
     brute-force and cluster backends at 64x64 against the kernel path
     (`phase_multi_device`).

Each main path (5, 5 with camera mode, 3i's family queries and frames, 7's
1.6M camera and pack-path queries, 7's Whitted frame, 8, 9, 9's "grid"
frame, each configuration of 10, 12's steps, 13's default render, 15's
sharded frames) runs with the launch counts set to 0 just before and read
just after. A
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
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FRAME_PARITY_ATOL = 1e-4  # torch's CUDA and CPU sin/cos differ by ulps
SKY_ATOL = 1e-3
# The CLI's default frame against the reference frame: the same scene and
# camera, other samples (another cluster size and other chunks): the
# means of 640,000 pixels, in u8 counts, agree within the samples' noise,
# which averages far below half a count; a kernel that lost or misplaced
# hits would move whole regions.
CLI_MEAN_ATOL = 0.5
# Phase 15: a sharded, 2-process or plain-backend frame against the frame
# it must equal (the same rays through the same kernels or the same math:
# only the shards, chunks and bins differ).
MULTI_ATOL = 1e-5
# Phase 15d: the sharded train step's gradients against one unsharded
# Fitter step at 262,144 rays, in units of each table's largest magnitude,
# both under deterministic algorithms (two Fitter steps then read 0.0).
# Each entry sums the contributions of up to 2.9M rays in f32, and the two
# steps sum them in another order: the sharded step sums each shard's
# half, then the two halves. On an H100 80GB HBM3 (700 W) that order alone
# read 2.07e-5 (verts), 1.52e-5 (colors) and 9.4e-6 (materials), above
# GRAD_PARITY_RTOL (1e-5, held at 1,024 rays). The bar is the one the CPU
# tests hold a fit step to against JAX's (rtol 1e-4); a lost or doubled
# shard moves a gradient by half of itself.
TRAIN_STEP_RTOL = 1e-4
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
    "walk_both": ("raytracing_tpu_torch/csrc/walk.cu",
                  "raytracing_tpu/kernels/traverse.py:972"),
    "walk_both_bounce": ("raytracing_tpu_torch/csrc/walk.cu",
                         "raytracing_tpu/kernels/traverse.py:972"),
    "walk_dma_both": ("raytracing_tpu_torch/csrc/walk.cu",
                      "raytracing_tpu/kernels/traverse.py:1819"),
    # The launches of `render` at the CLI's defaults (phase 13).
    "walk_cli": ("raytracing_tpu_torch/csrc/walk.cu",
                 "raytracing_tpu/kernels/traverse.py:972"),
    "walk_dma_cli": ("raytracing_tpu_torch/csrc/walk.cu",
                     "raytracing_tpu/kernels/traverse.py:1819"),
    "refine_extents_cli": ("raytracing_tpu_torch/csrc/refine.cu",
                           "raytracing_tpu/kernels/traverse.py:498"),
    "extents_cli": ("raytracing_tpu_torch/csrc/extents.cu",
                    "raytracing_tpu/kernels/traverse.py:163"),
    # The launches of the reference frame sharded over 4 virtual shards of
    # the card (phase 15a): raster-order chunks of a shard's rays.
    "walk_sharded": ("raytracing_tpu_torch/csrc/walk.cu",
                     "raytracing_tpu/kernels/traverse.py:972"),
    "walk_dma_sharded": ("raytracing_tpu_torch/csrc/walk.cu",
                         "raytracing_tpu/kernels/traverse.py:1819"),
    "refine_extents_sharded": ("raytracing_tpu_torch/csrc/refine.cu",
                               "raytracing_tpu/kernels/traverse.py:498"),
    "extents_sharded": ("raytracing_tpu_torch/csrc/extents.cu",
                        "raytracing_tpu/kernels/traverse.py:163"),
    # The off-main-path forms (phase 3i): the intersector families, the
    # two-phase query's capped walk and refinement, the lane cull.
    "walk_mt": ("raytracing_tpu_torch/csrc/walk.cu",
                "raytracing_tpu/kernels/traverse.py:972"),
    "walk_woop": ("raytracing_tpu_torch/csrc/walk.cu",
                  "raytracing_tpu/kernels/traverse.py:972"),
    "walk_dma_mt": ("raytracing_tpu_torch/csrc/walk.cu",
                    "raytracing_tpu/kernels/traverse.py:1819"),
    "walk_gstream_mt": ("raytracing_tpu_torch/csrc/gstream.cu",
                        "raytracing_tpu/kernels/traverse.py:1414"),
    "walk_gstream_woop": ("raytracing_tpu_torch/csrc/gstream.cu",
                          "raytracing_tpu/kernels/traverse.py:1414"),
    "walk_wq_mt": ("raytracing_tpu_torch/csrc/wq.cu",
                   "raytracing_tpu/kernels/traverse.py:2063"),
    "walk_dma_capped": ("raytracing_tpu_torch/csrc/walk.cu",
                        "raytracing_tpu/kernels/traverse.py:1819"),
    "refine_extents_capped": ("raytracing_tpu_torch/csrc/refine.cu",
                              "raytracing_tpu/kernels/traverse.py:498"),
    "walk_lc": ("raytracing_tpu_torch/csrc/walk.cu",
                "raytracing_tpu/kernels/traverse.py:972"),
}
# Published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside
# the tensor cores, and device memory.
PEAK_FP32 = 67e12
PEAK_HBM = 3.35e12
# Floating-point operations per (ray, triangle) test, comparisons and the
# (t, slot) update included, as counted in csrc/walk_core.cuh; per
# (ray, box) slab test in csrc/refine.cu; per ray in csrc/extents.cu.
OPS_PMT, OPS_PMTO, OPS_SLAB, OPS_EXTENTS = 40, 30, 30, 16
# ... and of the other intersector families' tests, counted the same way:
# mt's cross products, determinant, reciprocal and three dots; woop's six
# transform rows and its epilogue.
OPS_MT, OPS_WOOP = 55, 51
# Phase 3i's two-phase cap: the renderer's gi_cap_frac of the frame.
CAP_FRAC = 0.1
# K6's steady reading: back-to-back launches in one pair of CUDA events,
# over copies of its 23 MB pack that together exceed the card's 50 MB L2.
STEADY_LAUNCHES = 200
L2_COPIES = 4


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
                pack_bytes, ops_per_test, early, geo_rows=12):
    """Bound of one walk launch from what this run's data needed: every
    alive lane of a tile against every triangle of the clusters the tile
    visited (the kernel reports them; the early exit is exact); each input
    read once (pack or offsets, the listed ids and entry bounds, both
    tables) and each output written once."""
    ops = float((visits.double() * alive_per_tile.double()).sum()) \
        * cs * ops_per_test
    listed = float(cnt.sum())
    tables = geo.shape[0] * cs * 4 * (geo_rows + n_attrs)
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


def _extents_row(rows, name, bp):
    """K6 (`tile_extents`) on the pack `bp` against its plain version, bit
    for bit, timed into rows[name]. Returns the plain (lo, hi)."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T

    lo, hi = T.tile_extents(bp)
    plo, phi = T.tile_extents_plain(bp)
    _require(torch.equal(lo, plo) and torch.equal(hi, phi),
             f"{name} (K6): lo/hi differ")
    live = phi[:, 7] > 0
    err = float(torch.cat([(lo - plo)[live], (hi - phi)[live]]).abs().max()
                ) if live.any() else 0.0
    nt = bp.shape[1] // T.RAY_TILE
    print(f"[kernels] {name} (K6): {nt} tiles, {int(live.sum())} alive, "
          f"equal")
    _row(rows, name, err, lambda: T.tile_extents(bp),
         lambda: T.tile_extents_plain(bp),
         _bound(OPS_EXTENTS * bp.shape[1], bp.numel() * 4 + nt * 64),
         f"{bp.shape[1]} rays")
    return plo, phi


def _refine_extents_row(rows, name, rargs, shape):
    """K5 dense with K6's extents (`refine_dense_extents`) on (pack, boxes)
    `rargs` against its plain version, extents and bits bit for bit,
    timed into rows[name] with its bound from this data's entered bits."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T

    bp = rargs[0]
    flo, fhi, fent = T.refine_dense_extents(*rargs)
    plo, phi, pent = T.refine_dense_extents_plain(*rargs)
    _require(torch.equal(flo, plo) and torch.equal(fhi, phi)
             and torch.equal(fent, pent),
             f"{name} (K5 dense + K6): extents or bits differ from "
             f"tile_extents_plain / refine_dense_plain")
    live = phi[:, 7] > 0
    err = float(torch.cat([(flo - plo)[live], (fhi - phi)[live]]).abs().max()
                ) if live.any() else 0.0
    c, nt = rargs[1].shape[0], bp.shape[1] // T.RAY_TILE
    _, _, tests = _refine_bound(_tile_alive_lanes(bp),
                                live.to(torch.int32) * c, pent.sum(dim=1),
                                bp, c, c)
    print(f"[kernels] {name} (K5 dense + K6): extents and bits equal; "
          f"{int(pent.sum())} of {pent.numel()} bits set; "
          f"{_list_stats(live * c, _tile_alive_lanes(bp))}")
    _row(rows, name, err, lambda: T.refine_dense_extents(*rargs),
         lambda: T.refine_dense_extents_plain(*rargs),
         _bound(OPS_SLAB * tests + OPS_EXTENTS * bp.shape[1],
                bp.numel() * 4 + c * 24 + nt * 64 + nt * c * 4), shape)


def _steady_ms(fn, n=STEADY_LAUNCHES):
    """ms per call of `fn` over `n` back-to-back calls in one pair of CUDA
    events, after 10 warm-up calls: a launch of 10-50 us, which the median
    of 5 single calls cannot resolve."""
    import torch

    for _ in range(10):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _steady_extents(rows, bp, plo, phi):
    """K6 read steadily at the wavefront's shape: its kernel's entry called
    directly (no wrapper in the loop) STEADY_LAUNCHES times in one pair of
    CUDA events, in turns on L2_COPIES copies of the pack, so each launch
    reads its pack from device memory as the bound counts; beside it the
    plain PyTorch composite (`where`, `amin`, `amax` and the transposes of
    `tile_extents_plain`) on the copies in turns, replayed from a CUDA
    graph so that its time is the card's and not the host's. The row's ms
    becomes the entry's reading."""
    import itertools

    import torch

    from raytracing_tpu_torch.kernels import cuda
    from raytracing_tpu_torch.kernels import traverse as T

    nt = bp.shape[1] // T.RAY_TILE
    lib = cuda.library()
    stream = torch.cuda.current_stream().cuda_stream
    packs = [bp] + [bp.clone() for _ in range(L2_COPIES - 1)]
    outs = [(torch.empty((nt, 8), device="cuda"),
             torch.empty((nt, 8), device="cuda")) for _ in packs]
    calls = [(p.data_ptr(), p.shape[1], lo.data_ptr(), hi.data_ptr(), stream)
             for p, (lo, hi) in zip(packs, outs)]
    for args in calls:
        cuda.check(lib.rt_tile_extents(*args), "extents")
    _require(all(torch.equal(lo, plo) and torch.equal(hi, phi)
                 for lo, hi in outs),
             "extents (K6), entry called directly: lo/hi differ")
    turns = itertools.cycle(calls)
    entry = _steady_ms(lambda: lib.rt_tile_extents(*next(turns)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for p in packs:
            T.tile_extents_plain(p)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        graphed = [T.tile_extents_plain(p) for p in packs]
    graph.replay()
    _require(all(torch.equal(lo, plo) and torch.equal(hi, phi)
                 for lo, hi in graphed),
             "extents: the graphed composite differs from the plain version")
    composite = _steady_ms(graph.replay) / len(packs)
    del graph, graphed, packs
    row = rows["extents"]
    bound = row["bound_ms"]
    print(f"[kernels] extents (K6) steady, {STEADY_LAUNCHES} launches in one "
          f"pair of events: entry {entry} ms over {L2_COPIES} packs in turns "
          f"({bound / entry} of its {bound} ms bound by {row['bound_by']}); "
          f"the PyTorch composite (graphed, packs in turns) {composite} ms, "
          f"{composite / entry}x the entry; median of 5 wrapper calls "
          f"{row['ms']} ms")
    row["ms"] = entry


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
             "the host library (raytracing_tpu_torch/native/"
             "raytracing_native.cpp) did not build: the large scenes need "
             "it")
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


def _capture_calls(name, picks, run, entry=None):
    """Run `run()` with `kernels.traverse.<name>` wrapped, and return the
    (args, kw) of its calls numbered `picks` (from 0, in launch order; None:
    every call), as the renderer made them; with `entry`, only the calls
    that count as that entry are numbered."""
    from raytracing_tpu_torch.kernels import traverse as T

    fn = getattr(T, name)
    seen, calls = [0], {}

    def wrapped(*args, **kw):
        if entry is not None and kw.get("entry") != entry:
            return fn(*args, **kw)
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
                nearest=True, plain_reps=5, kernel="walk", bound_visits=None):
    """Compare one pack walk launch (`walk`, `walk_gstream` or `walk_wq`)
    with its plain version, then time both and reckon the launch's bound
    from the visits it made (or `bound_visits` per tile: the lane cull's
    kernel reports the visits it staged, not those it tested). The
    geometry rows the bound reads are the intersector family's. Returns
    the kernel's result."""
    import functools

    import torch

    fn, plain = getattr(T, kernel), getattr(T, kernel + "_plain")
    if kw.get("lane_bounds") is not None:
        plain = functools.partial(plain, lane_bounds=kw["lane_bounds"])
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
    bound = _walk_bound(tile_visits if bound_visits is None else bound_visits,
                        _tile_alive_lanes(rp), cnt, geo, attr,
                        n_attrs if nearest else 0, cs, rp.shape[1],
                        rp.numel() * 4 + (0 if tr is None else tr.numel() * 4),
                        ops_per_test, kw.get("tnear") is not None,
                        T._FAMILY_ROWS[int(args[-2])])
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

    from raytracing_tpu_torch import (RenderConfig, bench,
                                      build_cluster_accel, build_default_scene)
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
    plo, phi = _extents_row(rows, "extents", bp)
    _steady_extents(rows, bp, plo, phi)
    tile_alive = phi[:, 7] > 0.0
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
    _refine_extents_row(rows, "refine_extents", rargs,
                        f"{bp.shape[1]} rays, {c128} clusters, the extents "
                        f"and the bits")
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

    # 3h. The walks of a differentiated render: the same chunk (K1) and
    # wavefront (K2) carrying the backward's 11 planes beside the shading
    # planes, A = 15 here (objid mode) and 20 with a color per triangle.
    _both_rows(rows, rp, bp, scene.mesh, acc16, acc128, eps, early)

    # 3d. Per-ray t_max: the chunk's area-light shadow query (one sample of
    # `area_light_term` at the primary hits) through both pack entries.
    lights = bench.sphere_light(dev)
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


def _full_mode(mesh):
    """The mesh with a color per triangle: the accel's full mode, 9
    shading planes instead of objid mode's 4."""
    import torch

    tri = torch.arange(mesh.colors.shape[0], dtype=torch.float32,
                       device=mesh.colors.device)[:, None]
    return mesh._replace(colors=(mesh.colors * (0.5 + 0.5 * torch.cos(tri)))
                         .clamp(0, 1).contiguous())


def _both_rows(rows, rp, bp, mesh, acc16, acc128, eps, early):
    """3h. K1 on the primary chunk and K2 on its wavefront with attr_kind
    "both" (rows walk_both_chunk, walk_dma_both_chunk; A = 15) and in full
    mode (rows walk_both_chunk_full, walk_dma_both_chunk_full; A = 20):
    against their plain versions, and against the shading walk in t, slots
    and the shading planes. Phase 10 times the launches of the kernel
    table."""
    import torch

    from raytracing_tpu_torch import build_cluster_accel
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.ops.intersect import INF

    full = _full_mode(mesh)
    modes = (("", acc16, acc128),
             ("_full", build_cluster_accel(full, cluster_size=16),
              build_cluster_accel(full, cluster_size=128)))
    for suffix, a16, a128 in modes:
        for name, make, acc, pack, extra in (
                ("walk_both", T._groups_walk_args, a16, rp, {}),
                ("walk_dma_both", T._dma_walk_args, a128, bp,
                 dict(early_exit=early))):
            na = acc.attr_blocks.shape[1]
            nb = T._n_attrs(acc, "both")
            _require(nb == na + 11 and na == (9 if suffix else 4),
                     f"{name}{suffix}: {na} shading planes, {nb} in all")
            args, kw = make(acc, pack, eps, True, INF, nb, attr_kind="both",
                            **extra)
            _require(kw["entry"] == name, f"{name}: entry {kw['entry']}")
            alive = pack[7] != 0
            out = _timed_walk(
                rows, f"{name}_chunk{suffix}",
                f"{name} (K{1 if name == 'walk_both' else 2}"
                f") nearest, shading + backward planes, A = {nb}", T, args,
                kw, alive, OPS_PMT,
                f"{pack.shape[1]} rays, {acc.num_clusters}x"
                f"{acc.cluster_size}, A = {nb}", plain_reps=1)
            sargs, skw = make(acc, pack, eps, True, INF, na, **extra)
            t, sl, a = T.walk(*sargs, **skw)
            _require(torch.equal(out[0][0][alive], t[0][alive])
                     and torch.equal(out[1][0][alive], sl[0][alive])
                     and torch.equal(out[2][:na, alive], a[:, alive]),
                     f"{name}{suffix}: t, slots or shading planes differ "
                     f"from the shading walk's")
            print(f"[kernels] {name}_chunk{suffix}: t, slots and the {na} "
                  f"shading planes equal the shading walk's (A = {na}: "
                  f"{_median_ms(lambda: T.walk(*sargs, **skw)):.4f} ms)")
            del out, t, sl, a


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


def _variant_row(rows, name, tag, T, args, kw, alive, ops, shape, base,
                 kernel="walk", bound_visits=None):
    """One off-main-path form (phase 3i) against its plain version, timed
    with its bound, and `base` = (args, kw) of the main path's form at the
    same shape timed beside it in the same turns (row key "pmt_ms")."""
    fn = getattr(T, kernel)
    _timed_walk(rows, name, tag, T, args, kw, alive, ops, shape,
                kernel=kernel, bound_visits=bound_visits,
                plain_reps=5 if args[0].shape[1] <= 65536 else 1)
    bargs, bkw = base
    rows[name]["pmt_ms"] = _median_ms(lambda: fn(*bargs, **bkw))
    print(f"[variants] {name}: {rows[name]['ms']:.4f} ms beside the main "
          f"path's form at the same shape {rows[name]['pmt_ms']:.4f} ms "
          f"({shape})")


def _query_launches(run, key):
    """LAUNCHES[key] over one query through the public entry."""
    from raytracing_tpu_torch.kernels import traverse as T

    T.reset_launches()
    run()
    n = T.LAUNCHES.get(key, 0)
    _require(n > 0, f"{key}: the query launched no such kernel "
             f"({ {k: v for k, v in T.LAUNCHES.items() if v} })")
    return n


def _lane_cull_visits(args, kw):
    """Per tile, the listed visits some alive lane of the tile enters (the
    per-tile vote of `_lane_cull_keep`): the visits the lane-cull walk's
    bound counts (its warps, voting apart, test no more)."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T

    rp, ids, cnt = args[:3]
    pack = rp.reshape(8, -1, 1, T.RAY_TILE)
    kept = torch.zeros(cnt.shape, dtype=torch.int64, device=rp.device)
    for j in range(int(cnt.max())):
        act = torch.nonzero(cnt > j).squeeze(1)
        keep = T._lane_cull_keep(pack, act, ids[act, j], kw["lane_bounds"])
        kept[act] += keep.long()
    return kept


def phase_variants(rows):
    """3i. The forms no default path runs, on the card against their plain
    versions at the main paths' shapes, bit for bit on alive lanes, each
    timed beside the main path's form at the same shape: K1 mt and woop
    on 3a's 65,536-ray chunk at CS 16; K2 mt and K4 mt on 3a's 720,896-ray
    wavefront at CS 128; K3 mt and woop on the chunk with the CS 16 table
    split into 4 groups of 256 (the group budget patched, as 3e does); the
    capped K2 walk and the capped K5 dense query on the wavefront under
    the reference frame's cap (gi_cap_frac 0.1 of its cluster-box
    diagonal); the K1 lane-cull walk on the wavefront (the walk of a
    gi_wq=False frame's bounce level). The launches of each family's row
    are counted over a query through `nearest_hit_attrs_soa(variant=)`.
    Then the reference frame with gi_cap_frac 0.1 against the default
    frame, and a gi_wq=False frame with gi_lane_cull on and off: the
    images equal, the times side by side; the capped and lane-cull rows'
    launches are those frames'. Returns the rows' launches."""
    import torch

    from raytracing_tpu_torch import (RenderConfig, bench,
                                      build_cluster_accel, build_default_scene)
    from raytracing_tpu_torch.accel import packets
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.models import whitted
    from raytracing_tpu_torch.models.camera import (block_ray_ids,
                                                    camera_rays_for_ids)
    from raytracing_tpu_torch.ops.intersect import INF

    dev = "cuda"
    cfg = RenderConfig()
    scene = build_default_scene(device=dev)
    acc16 = build_cluster_accel(scene.mesh, cluster_size=16)
    acc128 = build_cluster_accel(scene.mesh, cluster_size=128)
    _require(all(getattr(a, f) is not None for a in (acc16, acc128)
                 for f in ("tri_blocks", "pmt_t_blocks", "woop_blocks")),
             "the default scene's accels lack a family's table")
    eps, na = cfg.eps, acc16.attr_blocks.shape[1]
    early = True if cfg.gi_early_exit else None
    launches = {}
    o, d = camera_rays_for_ids(
        block_ray_ids(KERNEL_CHUNK, cfg.chunk_size, cfg, device=dev), cfg)
    rp = T.rays_to_soa(o, d)
    alive = rp[7] != 0
    chunk = f"{rp.shape[1]} rays, {acc16.num_clusters}x16"
    base = T._groups_walk_args(acc16, rp, eps, True, INF, na)
    for v, ops in (("mt", OPS_MT), ("woop", OPS_WOOP)):
        args, kw = T._groups_walk_args(acc16, rp, eps, True, INF, na,
                                       variant=v)
        _variant_row(rows, f"walk_{v}", f"walk (K1) primary nearest+attrs, "
                     f"{v}", T, args, kw, alive, ops, f"{chunk}, {v}", base)
        launches[f"walk_{v}"] = _query_launches(
            lambda: T.nearest_hit_attrs_soa(acc16, rp, variant=v), f"walk_{v}")
        # Another family, the same winners: its t may differ in the last
        # bits (another rounding path), its slots and attributes not.
        kt, ks, _ = T.walk(*args, **kw)
        pt, ps, _ = T.walk(*base[0], **base[1])
        hit = alive & torch.isfinite(pt[0])
        print(f"[variants] walk (K1) {v} vs pmt on the chunk: "
              f"{int((ks[0][alive] != ps[0][alive]).sum())} of "
              f"{int(alive.sum())} alive lanes' slots differ; max |t "
              f"difference| {float((kt - pt)[0][hit].abs().max())}")

    # The chunk's depth-2 wavefront, as 3a makes it.
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    ob, db, ab = whitted.bounce_wavefront(
        scene.mesh, acc16, scene.sun, o, d, cfg,
        lambda depth, shape: torch.rand(shape, generator=gen, device=dev))
    bp, _ = T._pad_rays_soa(T.rays_to_soa(ob, db, alive=ab))
    balive = bp[7] != 0
    wave = f"{bp.shape[1]} rays, {acc128.num_clusters}x128"
    dbase = T._dma_walk_args(acc128, bp, eps, True, INF, na, early_exit=early)
    args, kw = T._dma_walk_args(acc128, bp, eps, True, INF, na,
                                early_exit=early, variant="mt")
    _variant_row(rows, "walk_dma_mt", "walk_dma (K2) bounce nearest+attrs, "
                 "mt", T, args, kw, balive, OPS_MT, f"{wave}, mt", dbase)
    k2_mt = T.walk(*args, **kw)
    launches["walk_dma_mt"] = _query_launches(
        lambda: T.nearest_hit_attrs_soa(acc128, bp, early_exit=early, wq=True,
                                        variant="mt"), "walk_dma_mt")
    wargs, wkw = T._wq_walk_args(acc128, bp, eps, True, INF, na,
                                 variant="mt")
    _variant_row(rows, "walk_wq_mt", "walk_wq (K4) bounce nearest+attrs, mt",
                 T, wargs, wkw, balive, OPS_MT, f"{wave}, mt, {wkw['u']} "
                 f"visits per work item",
                 T._wq_walk_args(acc128, bp, eps, True, INF, na),
                 kernel="walk_wq")
    _compare_walk("walk_wq (K4) mt vs walk_dma (K2) mt", T.walk_wq(*wargs,
                                                                   **wkw),
                  k2_mt, balive, True)
    impl = T._WQ_IMPL
    T._WQ_IMPL = "grid"
    try:
        launches["walk_wq_mt"] = _query_launches(
            lambda: T.nearest_hit_attrs_soa(acc128, bp, wq=True,
                                            variant="mt"), "walk_wq_mt")
    finally:
        T._WQ_IMPL = impl

    # K3: the CS 16 table in 4 groups of 256 clusters.
    budget = packets._GROUP_BLOCK_BUDGET_BYTES
    packets._GROUP_BLOCK_BUDGET_BYTES = 1
    try:
        gbase = T._gstream_walk_args(acc16, rp, eps, True, INF, na)
        _require(gbase[0][1].shape[0] == 4, "K3: not 4 groups")
        for v, ops in (("mt", OPS_MT), ("woop", OPS_WOOP)):
            args, kw = T._gstream_walk_args(acc16, rp, eps, True, INF, na,
                                            variant=v)
            _variant_row(rows, f"walk_gstream_{v}", f"walk_gstream (K3) "
                         f"primary nearest+attrs, {v}", T, args, kw, alive,
                         ops, f"{chunk} in 4 groups of 256, {v}", gbase,
                         kernel="walk_gstream")
            _compare_walk(f"walk_gstream (K3) {v} vs walk (K1) {v}",
                          T.walk_gstream(*args, **kw),
                          T.walk(*T._groups_walk_args(
                              acc16, rp, eps, True, INF, na, variant=v)[0]),
                          alive, True)
            launches[f"walk_gstream_{v}"] = _query_launches(
                lambda: T.nearest_hit_attrs_soa(acc16, rp, variant=v),
                f"walk_gstream_{v}")
    finally:
        packets._GROUP_BLOCK_BUDGET_BYTES = budget

    # The two-phase query's first phase on the wavefront, under the frame's
    # cap: the capped K2 walk and the capped dense K5 query.
    cap = whitted.bounce_cap(acc16, cfg.replace(gi_cap_frac=CAP_FRAC))
    print(f"[variants] the reference frame's cap at gi_cap_frac {CAP_FRAC}: "
          f"{cap}")
    cargs, ckw = T._dma_walk_args(acc128, bp, eps, True, cap, na,
                                  early_exit=early)
    _variant_row(rows, "walk_dma_capped", "walk_dma (K2) bounce "
                 "nearest+attrs under the cap", T, cargs, ckw, balive,
                 OPS_PMT, f"{wave}, t < {cap}", dbase)
    rargs = (bp, acc128.cluster_min, acc128.cluster_max)
    flo, fhi, fent = T.refine_dense_extents(*rargs, cap)
    plo, phi, pent = T.refine_dense_extents_plain(*rargs, cap)
    _require(torch.equal(flo, plo) and torch.equal(fhi, phi)
             and torch.equal(fent, pent),
             "refine_extents_capped (K5 dense + K6 under the cap): differs "
             "from its plain version")
    _, _, uent = T.refine_dense_extents(*rargs)
    _require(bool((fent <= uent).all()),
             "refine_extents_capped: a bit set the uncapped query clears")
    c = acc128.num_clusters
    nt = bp.shape[1] // T.RAY_TILE
    live = phi[:, 7] > 0
    _, _, tests = _refine_bound(_tile_alive_lanes(bp),
                                live.to(torch.int32) * c, pent.sum(dim=1),
                                bp, c, c)
    print(f"[variants] refine_extents_capped: {int(pent.sum())} of "
          f"{int(uent.sum())} uncapped bits set, equal to plain; (ray, box) "
          f"tests the bound counts: {tests}")
    _row(rows, "refine_extents_capped", 0.0,
         lambda: T.refine_dense_extents(*rargs, cap),
         lambda: T.refine_dense_extents_plain(*rargs, cap),
         _bound(OPS_SLAB * tests + OPS_EXTENTS * bp.shape[1],
                bp.numel() * 4 + c * 24 + nt * 64 + nt * c * 4),
         f"{bp.shape[1]} rays, {c} clusters, under the cap {cap}")
    rows["refine_extents_capped"]["pmt_ms"] = _median_ms(
        lambda: T.refine_dense_extents(*rargs))
    print(f"[variants] refine_extents_capped "
          f"{rows['refine_extents_capped']['ms']:.4f} ms beside the "
          f"uncapped query {rows['refine_extents_capped']['pmt_ms']:.4f} ms")
    full = T.nearest_hit_attrs_soa(acc128, bp, early_exit=early, wq=True)
    two = T.nearest_hit_attrs_soa(acc128, bp, early_exit=early, wq=True,
                                  t_cap=cap)
    _require(all(torch.equal(x[..., balive], y[..., balive])
                 for x, y in zip(two, full)),
             "the two-phase query differs from the uncapped one")
    print("[variants] the two-phase query on the wavefront equals the "
          "uncapped one (t, slots, attributes on alive lanes)")

    # The lane cull: K1 on the wavefront as a gi_wq=False frame walks it.
    largs, lkw = T._groups_walk_args(acc128, bp, eps, True, INF, na,
                                     early_exit=early, lane_cull=True)
    kept = _lane_cull_visits(largs, lkw)
    print(f"[variants] walk_lc: {int(kept.sum())} of {int(largs[2].sum())} "
          f"listed visits entered by some alive lane of their tile")
    _variant_row(rows, "walk_lc", "walk (K1) bounce nearest+attrs, lane "
                 "cull", T, largs, lkw, balive, OPS_PMT, f"{wave}, lane cull",
                 T._groups_walk_args(acc128, bp, eps, True, INF, na,
                                     early_exit=early), bound_visits=kept)

    # Frames: the cap, and the lane cull on against off.
    frames = {}
    for tag, c in (("default", cfg),
                   ("gi_cap_frac 0.1", cfg.replace(gi_cap_frac=CAP_FRAC)),
                   ("gi_wq False, lane cull", cfg.replace(gi_wq=False)),
                   ("gi_wq False, no lane cull",
                    cfg.replace(gi_wq=False, gi_lane_cull=False))):
        img, fl, _, first, times = bench.timed_frames(scene, c, acc16, 1)
        frames[tag] = (img, fl)
        print(f"[variants] reference frame, {tag}: {first:.3f} s counted, "
              f"{times[0]:.3f} s timed; launches "
              f"{ {k: v for k, v in fl.items() if v} }")
    for a, b in (("gi_cap_frac 0.1", "default"),
                 ("gi_wq False, lane cull", "gi_wq False, no lane cull")):
        _require(torch.equal(frames[a][0], frames[b][0]),
                 f"the reference frame, {a}, differs from {b}")
        print(f"[variants] reference frame, {a}: equal to {b}")
    launches["walk_dma_capped"] = frames["gi_cap_frac 0.1"][1].get(
        "walk_dma_capped", 0)
    launches["refine_extents_capped"] = frames["gi_cap_frac 0.1"][1].get(
        "refine_extents_capped", 0)
    launches["walk_lc"] = frames["gi_wq False, lane cull"][1].get("walk_lc", 0)
    _require(not frames["gi_wq False, no lane cull"][1].get("walk_lc", 0),
             "the frame without lane cull launched the lane-cull walk")
    return launches


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

    from raytracing_tpu_torch import (RenderConfig, bench,
                                      build_cluster_accel, build_default_scene)
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
            lambda: frame.append(bench.timed_frames(scene, c, accel, 2)))
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
    """Primary rays/s of `nearest_hit_camera_soa` (`bench.camera_rate`:
    `iters` chained calls in CUDA events, best of 3), gated on the hit
    fraction."""
    from raytracing_tpu_torch import bench

    rate, frac = bench.camera_rate(accel, w, h, spp, iters)
    _require(gate[0] < frac < gate[1],
             f"{tag}: implausible hit fraction {frac}")
    print(f"[{tag}] {w}x{h}x{spp}spp, {accel.num_clusters} clusters of "
          f"{accel.cluster_size}: hit fraction {frac}, {w * h * spp / rate} "
          f"s per call (best of 3 x {iters}) -> {rate} primary rays/s")
    return rate


def phase_headline():
    """6. The headline through the CLI, `python -m raytracing_tpu_torch
    bench` (`bench.measure`), in process: its JSON line names the card
    and passes the hit gate."""
    import torch

    from raytracing_tpu_torch import bench

    out = _cli(["bench"])
    rec = json.loads(out.strip().splitlines()[-1])
    _require(rec["metric"] == "primary_rays_per_s_per_chip_teapot"
             and rec["unit"] == "rays/s" and rec["value"] > 0
             and rec["device"] == torch.cuda.get_device_name(0),
             f"bench: record {rec}")
    frac = rec["hit_fraction"]
    _require(bench.HIT_GATE[0] < frac < bench.HIT_GATE[1],
             f"bench: implausible hit fraction {frac}")
    print(f"[headline] bench: {rec['value']} primary rays/s, hit fraction "
          f"{frac}")
    return rec["value"]


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

    from raytracing_tpu_torch import RenderConfig, bench, build_cluster_accel
    from raytracing_tpu_torch.geometry.mesh import Scene
    from raytracing_tpu_torch.geometry.scene import (subdivided_teapot_mesh,
                                                     sun_position)
    from raytracing_tpu_torch.kernels import traverse as T

    print(f"[large] 404k: mesh_gen {built404['mesh_s']} s, accel_build "
          f"{built404['accel_s']} s")
    camera = _reference_camera("cuda")
    _check_camera_frame(rows, "walk_camera_404k", "walk_camera", acc64,
                        camera, False)
    _camera_rate(acc64, 800, 800, 4, bench.HIT_GATE_LARGE, 10,
                 "large 404k")

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
                                       frame.append(bench.timed_frames(
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
        _camera_rate(acc, 800, 800, 4, bench.HIT_GATE_LARGE, iters,
                     f"large {tag}")
        print(f"[large {tag}] peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30} GiB")
        _require(T.LAUNCHES["walk_camera_dma"] > 0,
                 f"the {tag} query did not launch walk_camera_dma")
        rate_launches = rate_launches or dict(T.LAUNCHES)
        del acc, mesh

    cfg = RenderConfig()
    img, launches, counts, first, times = bench.timed_frames(
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
    from tools.group_loop import walk_groups_loop

    for early in (True, False):
        T.reset_launches()
        streamed = T._walk_groups(*query, early_exit=early,
                                  shared_origin=zero3)
        loop = walk_groups_loop(*query, early_exit=early,
                                shared_origin=zero3)
        _require(T.LAUNCHES["walk_gstream"] == 1 and T.LAUNCHES["walk"] == ng,
                 f"K3 and the K1 group loop: launches {T.LAUNCHES}")
        _compare_walk(f"walk_gstream (K3) vs the K1 group loop, early exit "
                      f"{early}", streamed, loop, every, True)
    _compare_walk("walk_gstream (K3) vs the K1 group loop, occlusion",
                  T._walk_groups(acc, rp, eps, False, INF, 0,
                                 shared_origin=zero3),
                  walk_groups_loop(acc, rp, eps, False, INF, 0,
                                   shared_origin=zero3), every, False)
    del streamed, loop
    # Times: the whole query either way (extents, lists, launches), and the
    # loop's K1 launches alone beside the one K3 launch.
    for tag, fn in (("K3", T._walk_groups),
                    ("the K1 group loop", walk_groups_loop)):
        ms = _median_ms(lambda: fn(*query, shared_origin=zero3))
        print(f"[kernels] 1.6M nearest+attrs query through {tag}, lists "
              f"included: {ms:.4f} ms")
    loop = [T._groups_walk_args(*query, shared_origin=zero3,
                                clusters=(lo, min(lo + gsz,
                                                  acc.num_clusters)))
            for lo in range(0, acc.num_clusters, gsz)]
    ms = _median_ms(lambda: [T.walk(*a, **k) for a, k in loop])
    print(f"[kernels] the K1 group loop's {len(loop)} walk launches alone: "
          f"{ms:.4f} ms (walk_gstream: {rows['walk_gstream']['ms']:.4f} ms)")
    # The loop's groups cannot exit on a hit another group found.
    seen = torch.zeros(rp.shape[1] // 1024, dtype=torch.int32, device=dev)
    visited = 0
    for a, k in loop:
        T.walk(*a, visits=seen, **k)
        visited += int(seen.sum())
    print(f"[kernels] the K1 group loop visited {visited} clusters "
          f"({rows['walk_gstream']['shape']})")
    del loop
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

    from raytracing_tpu_torch import (PathTracerConfig, RenderConfig, bench,
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
    img, launches, counts, first, times = bench.timed_frames(
        scene, cfg, accel, 1, pt=pt)
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

    from raytracing_tpu_torch import (RenderConfig, bench,
                                      build_cluster_accel, build_default_scene)
    from raytracing_tpu_torch.geometry.mesh import Scene
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.models import whitted

    base = build_default_scene(device="cuda")
    scene = Scene(base.mesh, base.sun, bench.sphere_light("cuda"))
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    cfg = RenderConfig(light_samples=4)
    img, launches, counts, first, times = bench.timed_frames(
        scene, cfg, accel, 1)
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


# Card against CPU gradients (11): each table within this share of its
# largest magnitude on the CPU; the backward's scatter-adds are atomics on
# the card, so sums come in another order, and the sampler's sin/cos differ
# by ulps between the devices. An H100 80GB HBM3 at 700 W read 7.6e-8 to
# 7.0e-7 over two runs (PERF.md).
GRAD_PARITY_RTOL = 1e-5


def _backward_262k(tag, scene, accel, gi_accel=None, lights=None,
                   keep=None):
    """(b) One configuration of `bench_suite.py:80-130`'s backward, timed
    by `bench.backward_262k` (forward without grad, forward + backward,
    each a median of 3 after a warm-up; one counted forward + backward),
    gated here: the same loss under grad, every gradient finite and
    nonzero, the walks launched. `keep` = (entry, picks): the `walk`
    launches of that entry, numbered from 0 in the counted run, to keep.
    Returns (its launches, the kept (args, kw))."""
    from raytracing_tpu_torch import bench

    kept = []

    def around(run):
        kept.extend(_capture_calls("walk", keep[1], run, entry=keep[0]))

    b = bench.backward_262k(scene, accel, gi_accel=gi_accel, lights=lights,
                            around_counted=None if keep is None else around)
    loss_f, loss_b, grads = b["loss_f"], b["loss_b"], b["grads"]
    launches, fwd, bwd = b["launches"], b["fwd_ms"], b["bwd_ms"]
    _require(bool(loss_f == loss_b), f"backward {tag}: the forward under "
             f"grad gives another loss ({float(loss_b)} against "
             f"{float(loss_f)})")
    for k, g in grads.items():
        _require(g is not None and bool(g.isfinite().all())
                 and float(g.abs().max()) > 0,
                 f"backward {tag}: the {k} gradient is not finite and "
                 f"nonzero")
    need = ["walk_both"] + (["walk_dma_both", "refine_extents"]
                            if gi_accel is not None else [])
    for k in need:
        _require(launches[k] > 0, f"backward {tag}: {k} not launched")
    tf, tb = statistics.median(fwd), statistics.median(bwd)
    print(f"[backward] {tag}: 262,144 rays, loss {float(loss_b)}; forward "
          f"(no grad) {fwd} ms, median {tf} ms; forward + backward {bwd} ms, "
          f"median {tb} ms; ratio {tb / tf}; peak device "
          f"{b['peak_gib']} GiB; launches {launches}; max |grad| "
          + ", ".join(f"{k} {float(g.abs().max())}"
                      for k, g in grads.items()))
    return launches, kept


def _backward_rows(rows, calls):
    """The kernel rows of the differentiated walk: each kept launch of
    phase 10, as the renderer made it, against its plain version (t,
    slots and the A = 15 planes bit-equal on alive lanes) and timed, its
    bound from the visits it made."""
    from raytracing_tpu_torch.kernels import traverse as T

    for row, what, (args, kw) in calls:
        rp, n_attrs, cs, pmto = args[0], args[5], args[6], args[10]
        _timed_walk(rows, row, f"{row} ({what}) nearest, shading + backward "
                    f"planes, A = {n_attrs}", T, args, kw, rp[7] != 0,
                    OPS_PMTO if pmto else OPS_PMT,
                    f"{what}: {rp.shape[1]} rays, {args[3].shape[0]}x{cs}, "
                    f"A = {n_attrs}, early exit "
                    f"{'on' if kw.get('tnear') is not None else 'off'}",
                    plain_reps=1)


def phase_backward(rows):
    """(b) Gradients at full width, three configurations: the CS 16 accel
    alone (as bench_suite.py runs it), the same with one area light
    (bench_suite.py:544-546), and with the reference frame's CS 128 bounce
    accel (so K2 and K5 dense run under grad). The first's primary and
    first-bounce K1 launches and the third's first K2 launch become the
    rows walk_both, walk_both_bounce and walk_dma_both. Returns the
    launches of the first and the third."""
    from raytracing_tpu_torch import (bench, build_cluster_accel,
                                      build_default_scene)

    scene = build_default_scene(device="cuda")
    acc16 = build_cluster_accel(scene.mesh, cluster_size=16)
    first, k1 = _backward_262k("CS 16", scene, acc16,
                               keep=("walk_both", [0, 1]))
    _backward_262k("CS 16, one area light", scene, acc16,
                   lights=bench.sphere_light("cuda"))
    third, k2 = _backward_262k(
        "CS 16 + CS 128 bounce accel", scene, acc16,
        gi_accel=build_cluster_accel(scene.mesh, cluster_size=128),
        keep=("walk_dma_both", [0]))
    _backward_rows(rows, [
        ("walk_both", "K1, the CS 16 run's primaries", k1[0]),
        ("walk_both_bounce", "K1, the CS 16 run's first bounce", k1[1]),
        ("walk_dma_both", "K2, the CS 128 bounce accel's first bounce",
         k2[0])])
    return first, third


def phase_grad_parity():
    """(c) The gradients of one render_rays over the 1,024 block-ordered
    rays of a 32x32 1-spp frame of the reference scene (CS 16 with the CS
    128 bounce accel, full depth), loss sum(rgb^2), on the card against
    the CPU port on the same rays and uniforms: each table within
    GRAD_PARITY_RTOL of its largest magnitude."""
    import torch

    from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                      build_default_scene)
    from raytracing_tpu_torch.models.camera import (block_ray_ids,
                                                    camera_rays_for_ids)
    from raytracing_tpu_torch.models.whitted import render_rays

    cfg = RenderConfig(width=32, height=32, samples_per_pixel=1)
    draws = {}

    def uniforms(tag, shape):
        if tag not in draws:
            draws[tag] = torch.rand(shape, generator=torch.Generator()
                                    .manual_seed(len(draws) + 11))
        return draws[tag]

    names = ("verts", "normals", "colors", "materials")
    grads = []
    for dev in ("cuda", "cpu"):
        scene = build_default_scene(device=dev)
        acc = build_cluster_accel(scene.mesh, cluster_size=16)
        gi = build_cluster_accel(scene.mesh, cluster_size=128)
        ids = block_ray_ids(0, 1024, cfg, 16, 16, device=dev)
        o, d = camera_rays_for_ids(ids, cfg)
        tables = {k: getattr(scene.mesh, k).clone().requires_grad_()
                  for k in names}
        t0 = time.perf_counter()
        rgb = render_rays(scene.mesh._replace(**tables), acc, scene.sun, o,
                          d, cfg, lambda tag, shape: uniforms(tag, shape)
                          .to(dev), gi_accel=gi)
        (rgb * rgb).sum().backward()
        print(f"[grad parity] {dev}: forward + backward "
              f"{time.perf_counter() - t0:.2f} s")
        grads.append({k: v.grad.cpu() for k, v in tables.items()})
    for k in names:
        card, cpu = grads[0][k], grads[1][k]
        scale = float(cpu.abs().max())
        err = float((card - cpu).abs().max()) / scale
        _require(bool(torch.isfinite(card).all()) and scale > 0,
                 f"grad parity: {k} is not finite and nonzero")
        _require(err <= GRAD_PARITY_RTOL, f"grad parity: {k} card vs CPU "
                 f"{err} of its largest magnitude > {GRAD_PARITY_RTOL}")
        print(f"[grad parity] {k}: max |card - CPU| / max |CPU| = {err} "
              f"(limit {GRAD_PARITY_RTOL}; largest {scale})")


def phase_fit():
    """(d) The inverse fit at `cmd_fit`'s defaults (raytracing_tpu/app.py:
    221-243, 319-322): the CS 128 accel, the target the port's own
    800x800x4 render, colors x 0.5, 4,096 rays a step, Adam at lr 1e-2, 20
    steps. Gates: the loss on one fixed held-out batch of 4,096 rays falls,
    and a checkpoint saved at step 10 loads back bit for bit. Returns the
    steps' launches."""
    import torch

    from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                      build_default_scene)
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.models import inverse
    from raytracing_tpu_torch.models.whitted import render
    from raytracing_tpu_torch.utils import checkpoint as ckpt

    cfg = RenderConfig(chunk_size=16384)
    scene = build_default_scene(device="cuda")
    accel = build_cluster_accel(scene.mesh, cluster_size=128)
    t0 = time.perf_counter()
    target = render(scene, cfg, accel=accel)
    torch.cuda.synchronize()
    print(f"[fit] target: 800x800x4 render {time.perf_counter() - t0:.2f} s")
    fitter = inverse.Fitter(scene, target,
                            {"colors": scene.mesh.colors * 0.5}, cfg,
                            accel=accel, learning_rate=1e-2)

    def draws(seed):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        return gen, (lambda tag, shape: torch.rand(shape, generator=gen,
                                                   device="cuda"))

    held_gen, _ = draws(123)
    held = torch.randint(0, fitter.n_rays, (4096,), generator=held_gen,
                         device="cuda")

    def held_loss():
        with torch.no_grad():
            return float(fitter.loss(held, draws(77)[1]))

    before = held_loss()
    gen, uniforms = draws(0)
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "fit_step10.npz")
    T.reset_launches()
    losses, ms = [], []
    for i in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = torch.randint(0, fitter.n_rays, (4096,), generator=gen,
                            device="cuda")
        losses.append(fitter.step(idx, uniforms))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        print(f"[fit] step {i + 1}: loss {losses[-1]}, {ms[-1]:.2f} ms")
        if i + 1 == 10:
            st = fitter.state(10)
            ckpt.save(path, st["params"], st["opt_state"], step=10)
            snap = {"params": {k: v.clone() for k, v in st["params"].items()},
                    "state": {j: {n: v.clone() for n, v in e.items()}
                              for j, e in st["opt_state"]["state"].items()},
                    "groups": st["opt_state"]["param_groups"]}
    launches = dict(T.LAUNCHES)
    after = held_loss()
    print(f"[fit] 20 steps of 4,096 rays: median {statistics.median(ms)} ms "
          f"a step; held-out loss {before} -> {after}; launches {launches}")
    _require(all(map(lambda x: x == x and abs(x) < float("inf"), losses)),
             "fit: a step's loss is not finite")
    _require(after < before, f"fit: the held-out loss did not fall "
             f"({before} -> {after})")
    params, opt_state, step, _ = ckpt.load(path, snap["params"],
                                           fitter.optimizer.state_dict())
    same = step == 10 and opt_state["param_groups"] == snap["groups"]
    same = same and all(torch.equal(params[k], v)
                        for k, v in snap["params"].items())
    same = same and all(torch.equal(opt_state["state"][j][n], v)
                        for j, e in snap["state"].items()
                        for n, v in e.items())
    tmp.cleanup()
    _require(same, "fit: the step-10 checkpoint does not load back bit for "
             "bit")
    print("[fit] the step-10 checkpoint loads back bit for bit (params, "
          "Adam's moments and step)")
    for k in ("walk_both", "walk_dma_both"):
        _require(launches[k] > 0, f"fit: {k} not launched")
    return launches


def _cli(argv):
    """`python -m raytracing_tpu_torch <argv>` in this process (the kernel
    library is built already): its standard output, echoed line by line.
    A failing command raises, and the smoke test with it."""
    import contextlib
    import io

    from raytracing_tpu_torch import app

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        app.main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"[cli] {line}")
    return out


PATH_KERNELS = ("walk", "refine_dense_extents", "tile_extents")


def _capture_path(run, names=PATH_KERNELS):
    """Run `run()` with every launch of each of `names` captured
    (`_capture_calls`): {name: [(args, kw), ...]}."""
    calls = {}

    def captured(rest):
        if not rest:
            run()
            return
        calls[rest[0]] = _capture_calls(rest[0], None,
                                        lambda: captured(rest[1:]))

    captured(tuple(names))
    return calls


def _path_rows(rows, calls, suffix, where):
    """The kernels of one main path, each held against its plain version
    at a shape that path gave it (`calls`: every launch of `walk`,
    `refine_dense_extents` and `tile_extents`, from `_capture_path`): the
    busiest nearest launch (most listed visits) of the `walk` entry (K1,
    primaries) and of the `walk_dma` entry (K2, a bounce wavefront), and
    the launch with the most alive lanes of K5+K6 and of K6: rows
    walk<suffix>, walk_dma<suffix>, refine_extents<suffix> and
    extents<suffix>. where: the path, for the printed lines."""
    from raytracing_tpu_torch.kernels import traverse as T

    for entry, k in (("walk", 1), ("walk_dma", 2)):
        nearest = [(a, kw) for a, kw in calls["walk"]
                   if kw.get("entry") == entry and a[8] and a[5]]
        _require(nearest, f"{where}: no nearest {entry} launch")
        args, kw = max(nearest, key=lambda c: int(c[0][2].sum()))
        rp, pmto = args[0], args[10]
        _timed_walk(rows, entry + suffix, f"{entry} (K{k}) {where}, its "
                    f"busiest nearest launch of {len(nearest)}", T, args, kw,
                    rp[7] != 0, OPS_PMTO if pmto else OPS_PMT,
                    f"{rp.shape[1]} rays, {args[3].shape[0]}x{args[6]}, A = "
                    f"{args[5]}{', pmto' if pmto else ''}", plain_reps=1)

    def most_alive(cs):
        return max(cs, key=lambda c: int((c[0][0][7] != 0).sum()))[0]

    rargs = most_alive(calls["refine_dense_extents"])
    _refine_extents_row(rows, "refine_extents" + suffix, rargs,
                        f"{rargs[0].shape[1]} rays, {rargs[1].shape[0]} "
                        f"clusters, {where}: the launch with the most alive "
                        f"lanes of {len(calls['refine_dense_extents'])}")
    _extents_row(rows, "extents" + suffix,
                 most_alive(calls["tile_extents"])[0])


def phase_cli(rows):
    """13. The command line at full width, in process: `render` of the
    reference frame (800x800x4, CS 16 with the CS 128 bounce accel,
    chunks of 65,536 as `RenderConfig()`; the CLI's default is 16,384) twice
    through an accel cache — built and saved, then loaded; the loaded
    accel equal to a fresh build field by field, both PNGs (read back with
    the raw decoder where there is no PIL) equal bit for bit to `to_u8` of
    `render()` with the same seed; `render` at the CLI's defaults (CS 128,
    no bounce accel given) with its launches counted and captured; `render --profile` at
    64x64, whose trace names the walk and refinement kernels; `fit` at its
    defaults (4,096 rays a step) for 20 steps without a checkpoint, then
    for 60 with one, each step under the Supervisor — the
    step-50 snapshot holds the live params (neither the start nor the
    end) — and `--resume` for 5 more, the step and Adam's count going on;
    `animate --frames 3 --out-pattern` at the reference frame's settings.
    The default render's PNG has the sky's colour and the reference
    frame's mean within CLI_MEAN_ATOL, and its kernels are held against
    their plain versions at its shapes (`_path_rows`). Returns the launches
    of the default render."""
    import numpy as np
    import torch

    from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                      build_default_scene)
    from raytracing_tpu_torch.accel.packets import ClusterAccel, load_accel
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.models.whitted import render
    from raytracing_tpu_torch.ops.color import to_rgba_frame
    from raytracing_tpu_torch.utils import checkpoint as ckpt
    from raytracing_tpu_torch.utils.image import read_png

    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    cache = os.path.join(d, "accel16.npz")
    frame = ["--cluster-size", "16", "--gi-cluster-size", "128",
             "--chunk-size", "65536"]  # RenderConfig()'s chunks
    ref = ["render", *frame, "--seed", "0", "--accel-cache", cache]
    pngs, secs = [], []
    for how in ("built", "loaded from"):
        pngs.append(os.path.join(d, f"ref_{len(pngs)}.png"))
        t0 = time.perf_counter()
        out = _cli(ref + ["--out", pngs[-1]])
        secs.append(time.perf_counter() - t0)
        _require(f"16, {how}" in out, f"render --accel-cache: not {how}")
    print(f"[cli] render of the reference frame, time to first frame "
          f"(process already up, kernels built): {secs[0]} s with the accel "
          f"built and saved, {secs[1]} s with it loaded")
    scene = build_default_scene(device="cuda")
    acc16 = build_cluster_accel(scene.mesh, cluster_size=16)
    loaded = load_accel(cache, mesh=scene.mesh, cluster_size=16)
    for name in ClusterAccel._fields:
        a, b = getattr(acc16, name), getattr(loaded, name)
        _require((a is None) == (b is None)
                 and (a is None or (b.is_cuda and torch.equal(a, b))),
                 f"accel cache: field {name} differs from a fresh build")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    want = to_rgba_frame(render(
        scene, RenderConfig(), accel=acc16,
        gi_accel=build_cluster_accel(scene.mesh, cluster_size=128),
        generator=gen))
    for png in pngs:
        _require(np.array_equal(read_png(png), want),
                 f"{png}: the CLI's frame is not to_u8 of render()")
    print(f"[cli] accel cache equal to a fresh build in all "
          f"{len(ClusterAccel._fields)} fields; both PNGs equal to_u8 of "
          f"render() bit for bit ({want.shape[1]}x{want.shape[0]})")

    defaults = os.path.join(d, "defaults.png")
    torch.cuda.synchronize()
    T.reset_launches()
    calls = _capture_path(lambda: _cli(["render", "--out", defaults]))
    torch.cuda.synchronize()
    launches = dict(T.LAUNCHES)
    for k in ("walk", "walk_dma", "refine_extents", "extents"):
        _require(launches[k] > 0, f"render at the CLI's defaults did not "
                 f"launch {k}: {launches}")
    print(f"[cli] launches per render at the CLI's defaults (800x800x4, CS "
          f"128, chunks of 16,384): {launches}")
    img = read_png(defaults)
    sky = np.round(255 * (np.array([0x87, 0xCE, 0xEB]) / 255.0) ** (1 / 2.2))
    gap = abs(float(img[..., :3].mean()) - float(want[..., :3].mean()))
    _require(img.shape == want.shape
             and np.abs(img[2, 2, :3] - sky).max() <= 1
             and gap <= CLI_MEAN_ATOL,
             f"render at the CLI's defaults: shape {img.shape}, sky pixel "
             f"{img[2, 2, :3]} (want {sky}), mean {gap} u8 from the "
             f"reference frame's")
    print(f"[cli] render at the CLI's defaults: sky pixel {img[2, 2, :3]}; "
          f"mean {float(img[..., :3].mean())} u8 against the reference "
          f"frame's {float(want[..., :3].mean())} (other cluster size and "
          f"chunks, so other samples; limit {CLI_MEAN_ATOL})")
    _path_rows(rows, calls, "_cli", "at the CLI's defaults")
    del calls

    prof = os.path.join(d, "prof")
    _cli(["render", "--width", "64", "--height", "64", "--cluster-size",
          "16", "--gi-cluster-size", "128", "--profile", prof, "--out",
          os.path.join(d, "small.png")])
    with open(os.path.join(prof, "trace.json")) as f:
        trace = f.read()
    names = [k for k in ("walk_kernel", "refine_kernel", "extents_kernel")
             if k in trace]
    _require({"walk_kernel", "refine_kernel"} <= set(names),
             f"profile trace names only {names}")
    print(f"[cli] render --profile: {len(trace)} bytes of trace naming "
          f"{names}")

    # The fit without a checkpoint (no Supervisor) for its ms a step.
    _cli(["fit", "--steps", "20"])
    ck = os.path.join(d, "fit.npz")
    saved = []
    real_save = ckpt.save

    def spy(path, params, opt_state=None, step=0, metadata=None):
        saved.append((step, {k: v.clone() for k, v in params.items()}))
        real_save(path, params, opt_state, step, metadata)

    ckpt.save = spy
    try:
        t0 = time.perf_counter()
        out = _cli(["fit", "--steps", "60", "--checkpoint", ck])
        fit_s = time.perf_counter() - t0
        first = json.loads(out.strip().splitlines()[-1])
        _require([st for st, _ in saved] == [50, 60],
                 f"fit: snapshots at steps {[st for st, _ in saved]}")
        start = scene.mesh.colors * 0.5
        mid, end = saved[0][1]["colors"], saved[1][1]["colors"]
        _require(not torch.equal(mid, start) and not torch.equal(mid, end),
                 "fit: the step-50 snapshot does not hold the live params")
        saved.clear()
        out = _cli(["fit", "--steps", "5", "--checkpoint", ck, "--resume"])
        last = json.loads(out.strip().splitlines()[-1])
    finally:
        ckpt.save = real_save
    _require(f"resumed from {ck} @ step 60" in out, "fit --resume: no resume")
    _, opt_state, step, _ = ckpt.load(ck, {"colors": start})
    _require(step == 65 and float(opt_state["state"][0]["step"]) == 65,
             f"fit --resume: step {step}, Adam's step "
             f"{float(opt_state['state'][0]['step'])}")
    losses = [v for rec in (first, last) for v in rec.values()]
    _require(all(np.isfinite(losses)), f"fit: losses {first} {last}")
    print(f"[cli] fit: 60 steps in {fit_s} s (800x800x4 target render "
          f"included), snapshots at 50 and 60; the step-50 one holds the "
          f"live params; --resume went on to step 65 (Adam's count 65)")

    pattern = os.path.join(d, "anim_{frame:03d}.png")
    out = _cli(["animate", *frame, "--frames", "3", "--out-pattern",
                pattern])
    frames = [pattern.format(frame=i) for i in range(3)]
    _require(all(os.path.exists(f) for f in frames)
             and "rendered 3 frames in" in out and "fps avg" in out,
             "animate: 3 PNGs and an fps line asked for")
    _require(read_png(frames[2]).shape == (800, 800, 4),
             "animate: a frame of the wrong shape")
    tmp.cleanup()
    return launches


def phase_resilience():
    """14. Recovery on the card: the liveness probe; `with_retry` past a
    real out-of-memory error (an allocation of 32 TiB); and a fit of 3
    steps whose second step fails after `optimizer.step()` with a real
    out-of-memory error, retried, against a clean fit: the same params and
    losses bit for bit (both under `torch.use_deterministic_algorithms`,
    so the backward's scatter-adds sum in one order)."""
    import torch

    from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                      build_default_scene)
    from raytracing_tpu_torch.models import inverse
    from raytracing_tpu_torch.models.whitted import render
    from raytracing_tpu_torch.utils.resilience import (device_alive,
                                                       with_retry)

    _require(device_alive(60.0), "device_alive() is False on the card")
    tries = []

    def alloc():
        tries.append(1)
        if len(tries) == 1:
            torch.empty(2 ** 45, dtype=torch.uint8, device="cuda")
        return float(torch.ones(4, device="cuda").sum())

    _require(with_retry(alloc, retries=2, backoff_s=0.0) == 4.0
             and len(tries) == 2, "with_retry did not get past an OOM")
    print("[resilience] device_alive() True; with_retry got past a real "
          "torch.cuda.OutOfMemoryError on its second attempt")

    scene = build_default_scene(device="cuda")
    acc = build_cluster_accel(scene.mesh, cluster_size=16)
    cfg = RenderConfig(width=64, height=64, samples_per_pixel=1)
    target = render(scene, cfg, accel=acc)

    def run(**kw):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(9)
        return inverse.fit(scene, target,
                           {"colors": scene.mesh.colors * 0.5}, cfg,
                           accel=acc, steps=3, rays_per_step=1024,
                           generator=gen, **kw)

    real_step = inverse.Fitter.step
    calls = []

    def faulty(self, idx, uniforms):
        loss = real_step(self, idx, uniforms)
        calls.append(1)
        if len(calls) == 2:
            torch.empty(2 ** 45, dtype=torch.uint8, device="cuda")
        return loss

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    tmp = tempfile.TemporaryDirectory()
    try:
        clean = run()
        inverse.Fitter.step = faulty
        retried = run(retries=2,
                      checkpoint_path=os.path.join(tmp.name, "r.npz"))
    finally:
        inverse.Fitter.step = real_step
        torch.use_deterministic_algorithms(was)
        tmp.cleanup()
    _require(len(calls) == 4, f"fit: {len(calls)} step attempts, 4 expected")
    _require(retried.losses == clean.losses
             and torch.equal(retried.params["colors"], clean.params["colors"]),
             f"fit: the retried step differs from a clean one (losses "
             f"{retried.losses} against {clean.losses})")
    print(f"[resilience] a fit step retried after a real OOM raised after "
          f"optimizer.step(): params and losses bit-equal to a clean fit "
          f"({clean.losses})")


def _sharded_frame(tag, scene, cfg, mesh, accel, card, need,
                   capture=False):
    """One `render_sharded` frame with the launch counts set to 0 just
    before and read just after: (image, seconds, launches, calls); with
    `capture`, calls holds every launch of the path's kernels
    (`_capture_path`; the seconds then include the capture), else None."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.parallel.shard import render_sharded

    out = []

    def run():
        out.append(render_sharded(scene, cfg, mesh, accel=accel, seed=0))

    torch.cuda.synchronize()
    T.reset_launches()
    t0 = time.perf_counter()
    calls = _capture_path(run) if capture else run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(T.LAUNCHES)
    for k in need:
        _require(launches[k] > 0, f"{tag}: kernel {k} was not launched: "
                 f"{launches}")
    how = " (launches captured)" if capture else ""
    print(f"[multi] {tag}: {dt} s a frame{how} on {card}; launches K1 "
          f"{launches['walk']}, K2 "
          f"{launches['walk_dma']}, K5+K6 {launches['refine_extents']}, K6 "
          f"{launches['extents']}")
    return out[0], dt, launches, calls


def _two_process_render(argv, timeout=600):
    """`python -m raytracing_tpu_torch render <argv>` in 2 new processes
    (each started fresh, never forked from this one, whose CUDA is up) of
    one gloo group sharing the card; their outputs."""
    import socket

    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "raytracing_tpu_torch", "render", *argv,
         "--num-processes", "2", "--process-id", str(i), "--coordinator",
         f"localhost:{port}", "--dist-backend", "gloo"], cwd=HERE,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            print(f"[multi] process {i}: {line}")
        _require(p.returncode == 0, f"2-process render: process {i} exited "
                 f"{p.returncode}")
    return outs


def phase_multi_device(card, rows):
    """15. Multi-device and multi-process on the card, at full width (the
    reference config, CS 16 plus the auto-built CS 128 bounce accel):
    (a) `render_sharded` over the card and over 4 virtual shards of it at
        diffuse depth 1 (no draws), each within MULTI_ATOL of `render()`
        on the card; at the reference config (the fan on) over 4 shards,
        finite, its u8 mean within CLI_MEAN_ATOL of `render()`'s; seconds
        and K1, K2, K5+K6, K6 launches of each, counted from 0 (the
        sharded frame is this slice's main path); the reference-config
        frame's launches captured and its kernels held against their plain
        versions at its shapes (`_path_rows`: rows walk_sharded,
        walk_dma_sharded, refine_extents_sharded, extents_sharded);
    (b) `render --num-processes 2 --assemble` in 2 processes of a gloo
        group sharing the card (NCCL refuses two ranks on one card): the
        stitched shards within MULTI_ATOL of the one-process 2-shard
        `render_sharded` frame;
    (c) a one-rank NCCL group on the card: `make_train_step` runs its
        all_reduce, and its step equals the step without a group bit for
        bit (both under deterministic algorithms);
    (d) the train step at the backward cell's size (262,144 rays of blocks
        90-105, CS 16, the reference config) over 2 virtual shards against
        one unsharded `Fitter` step on the same rays and draws, all under
        deterministic algorithms (a second Fitter step's spread, printed
        beside, then reads 0): the loss within GRAD_PARITY_RTOL, the
        gradients within TRAIN_STEP_RTOL of each table's largest
        magnitude; then ms per step of each without them;
    (e) `dryrun_multichip(1)` on the card and `dryrun_multichip(2)` over 2
        virtual shards of it;
    (f) the brute-force and cluster backends at 64x64x4 (the reference
        config), each within MULTI_ATOL of the kernel path's frame from the
        same seed. Returns the launches of (a)'s sharded frames."""
    import functools
    import socket

    import numpy as np
    import torch

    from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                      build_default_scene)
    from raytracing_tpu_torch.models import inverse
    from raytracing_tpu_torch.models.camera import (block_ray_ids,
                                                    camera_rays_for_ids)
    from raytracing_tpu_torch.models.whitted import render
    from raytracing_tpu_torch.ops.color import to_rgba_frame
    from raytracing_tpu_torch.parallel import distributed as D
    from raytracing_tpu_torch.parallel import shard as S
    from raytracing_tpu_torch.parallel.dryrun import dryrun_multichip

    scene = build_default_scene(device="cuda")
    acc16 = build_cluster_accel(scene.mesh, cluster_size=16)
    need = ("walk", "walk_dma", "refine_extents", "extents")

    def gen(seed):
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        return g

    # (a)
    out = {}
    dd1 = RenderConfig(diffuse_depth=1)
    want = render(scene, dd1, accel=acc16)
    for n in (1, 4):
        mesh = S.make_device_mesh(n, devices=["cuda:0"] * n)
        img, _, out[f"dd1_{n}"], _ = _sharded_frame(
            f"render_sharded over {n} shard(s) of the card, diffuse depth "
            f"1", scene, dd1, mesh, acc16, card, need)
        err = float((img - want).abs().max())
        _require(img.shape == want.shape and err <= MULTI_ATOL,
                 f"render_sharded over {n}: {err} from render() (limit "
                 f"{MULTI_ATOL})")
        print(f"[multi] render_sharded over {n} shard(s): max |sharded - "
              f"render()| = {err} (limit {MULTI_ATOL}) on {card}")
    ref = RenderConfig()
    mesh4 = S.make_device_mesh(4, devices=["cuda:0"] * 4)
    img, _, out["ref_4"], calls = _sharded_frame(
        "render_sharded over 4 shards, the reference config", scene, ref,
        mesh4, acc16, card, need, capture=True)
    full = render(scene, ref, accel=acc16, generator=gen(0))
    a = to_rgba_frame(img)[..., :3].astype(np.float64)
    b = to_rgba_frame(full)[..., :3].astype(np.float64)
    gap = abs(a.mean() - b.mean())
    _require(bool(torch.isfinite(img).all()) and gap <= CLI_MEAN_ATOL,
             f"render_sharded at the reference config: mean {a.mean()} u8 "
             f"against render()'s {b.mean()}")
    print(f"[multi] reference config over 4 shards: mean {a.mean()} u8 "
          f"against render()'s {b.mean()} (other draws; limit "
          f"{CLI_MEAN_ATOL}) on {card}")
    _path_rows(rows, calls, "_sharded", "in the reference frame over 4 "
               "shards")
    del calls

    # (b)
    tmp = tempfile.TemporaryDirectory()
    png = os.path.join(tmp.name, "two.png")
    t0 = time.perf_counter()
    outs = _two_process_render(["--cluster-size", "16", "--gi-cluster-size",
                                "128", "--chunk-size", "65536", "--seed",
                                "0", "--assemble", "--out", png])
    wall = time.perf_counter() - t0
    _require(f"wrote {png}" in outs[0] and os.path.exists(png),
             "2-process render: process 0 wrote no frame")
    got = D.assemble_shards(png + ".shards", ref)
    two = S.render_sharded(scene, ref, S.make_device_mesh(
        2, devices=["cuda:0"] * 2), accel=acc16, seed=0).cpu().numpy()
    err = float(np.abs(got - two).max())
    _require(err <= MULTI_ATOL, f"2-process render: {err} from the "
             f"one-process 2-shard frame (limit {MULTI_ATOL})")
    print(f"[multi] 2 processes sharing the card (gloo): {wall} s wall for "
          f"both, start-up included; stitched frame max |2 processes - 1 "
          f"process of 2 shards| = {err} (limit {MULTI_ATOL}) on {card}")
    tmp.cleanup()

    # (c)
    cfg = RenderConfig(width=64, height=64, samples_per_pixel=1)
    ids = block_ray_ids(0, 4096, cfg, device="cuda")
    o, d = camera_rays_for_ids(ids, cfg)
    target = torch.rand((4096, 3), generator=gen(5), device="cuda")
    mesh1 = S.make_device_mesh(1)
    step = S.make_train_step(cfg, functools.partial(torch.optim.Adam,
                                                    lr=1e-2), mesh1)
    params = {"colors": scene.mesh.colors * 0.5}
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    # Deterministic algorithms: the backward's scatter-adds then sum in one
    # order, so two steps can be held bit for bit.
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        alone = step(params, None, scene.mesh, acc16, scene.sun, o, d,
                     target)
        torch.distributed.init_process_group(
            "nccl", init_method=f"tcp://localhost:{port}", world_size=1,
            rank=0)
        try:
            S.COLLECTIVES["all_reduce"] = 0
            grouped = step(params, None, scene.mesh, acc16, scene.sun, o, d,
                           target)
            torch.cuda.synchronize()
            backend = torch.distributed.get_backend()
        finally:
            torch.distributed.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(was)
    _require(S.COLLECTIVES["all_reduce"] == 1 and backend == "nccl",
             f"NCCL: {S.COLLECTIVES['all_reduce']} all_reduce in a "
             f"{backend} group")
    _require(torch.equal(alone[0]["colors"], grouped[0]["colors"])
             and bool(alone[2] == grouped[2]),
             "NCCL: the one-rank step differs from the step without a group")
    print(f"[multi] one-rank NCCL group: the train step ran 1 all_reduce, "
          f"its params and loss ({float(grouped[2])}) equal to the step "
          f"without a group on {card}")

    # (d)
    pixels = 800 * 800
    idx = torch.cat([block_ray_ids(i, 16384, ref, 16, 16, device="cuda")
                     for i in range(90, 106)])
    n = idx.shape[0]
    u1 = torch.rand((ref.diffuse_scatter, n, 2), generator=gen(7),
                    device="cuda")

    def draw(tag, shape, lo=0):
        _require(tag == 1 and shape == (ref.diffuse_scatter,
                                        shape[1], 2),
                 f"train step: an unexpected draw {tag} {shape}")
        return u1[:, lo:lo + shape[1]].contiguous()

    tgt_img = torch.rand((800, 800, 3), generator=gen(8), device="cuda")
    tables = {k: getattr(scene.mesh, k) for k in ("verts", "colors",
                                                  "materials")}
    mesh2 = S.make_device_mesh(2, devices=["cuda:0"] * 2)
    step2 = S.make_train_step(ref, functools.partial(torch.optim.Adam,
                                                     lr=1e-2), mesh2)
    per = n // 2

    def fitter_step():
        fitter = inverse.Fitter(scene, tgt_img, tables, ref, accel=acc16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = fitter.step(idx, draw)
        torch.cuda.synchronize()
        return (fitter, loss, {k: v.grad for k, v in fitter.params.items()},
                (time.perf_counter() - t0) * 1e3)

    def sharded_step(grads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, loss = step2(
            tables, None, scene.mesh, acc16, scene.sun, o2, d2, t2,
            uniforms=lambda g, tag, shape: draw(tag, shape, g * per),
            grads_out=grads)
        torch.cuda.synchronize()
        return loss, (time.perf_counter() - t0) * 1e3

    # Deterministic algorithms: the backward's scatter-adds sum in one
    # order, so what is left between the two is the split into shards.
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        fitter, loss_1, grads_1, _ = fitter_step()
        _, _, again, _ = fitter_step()
        o2, d2 = fitter.o[idx], fitter.d[idx]
        t2 = fitter.target[idx % pixels]
        grads_2 = {}
        loss_2, _ = sharded_step(grads_2)
    finally:
        torch.use_deterministic_algorithms(was)
    spread = {k: float((again[k] - grads_1[k]).abs().max())
              / float(grads_1[k].abs().max()) for k in tables}
    times = [sharded_step({})[1] for _ in range(2)]
    fit_ms = fitter_step()[3]
    rel = abs(float(loss_2) - loss_1) / abs(loss_1)
    _require(rel <= GRAD_PARITY_RTOL, f"train step: loss {float(loss_2)} "
             f"against the Fitter's {loss_1}")
    errs = {}
    for k in tables:
        scale = float(grads_1[k].abs().max())
        errs[k] = float((grads_2[k] - grads_1[k]).abs().max()) / scale
        _require(scale > 0 and errs[k] <= TRAIN_STEP_RTOL,
                 f"train step: {k} gradient {errs[k]} of its largest "
                 f"magnitude from the Fitter's (limit {TRAIN_STEP_RTOL})")
    print(f"[multi] train step, 262,144 rays over 2 shards of the card: "
          f"{times} ms a step ({fit_ms} ms for the unsharded Fitter step); "
          f"under deterministic algorithms: loss {float(loss_2)} against "
          f"{loss_1} (rel {rel}); gradients max |sharded - Fitter| / max "
          f"|Fitter| {errs} (limit {TRAIN_STEP_RTOL}); two Fitter steps on "
          f"the same inputs differ by {spread} on {card}")
    del fitter, again, grads_1, grads_2, u1

    # (e)
    for nd, dev in ((1, None), (2, "cuda:0")):
        loss = dryrun_multichip(nd, device=dev)
        print(f"[multi] dryrun_multichip({nd}"
              f"{'' if dev is None else ', ' + repr(dev)}): loss {loss} on "
              f"{card}")

    # (f)
    c64 = RenderConfig(width=64, height=64)
    kern = render(scene, c64, accel=acc16, generator=gen(3))
    for backend, acc in (("bruteforce", None), ("cluster", acc16)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render(scene, c64.replace(backend=backend), accel=acc,
                     generator=gen(3))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        err = float((img - kern).abs().max())
        _require(err <= MULTI_ATOL, f"{backend} backend at 64x64: {err} "
                 f"from the kernel path (limit {MULTI_ATOL})")
        print(f"[multi] {backend} backend, 64x64x4 reference config: "
              f"{dt} s, max |{backend} - kernels| = {err} (limit "
              f"{MULTI_ATOL}) on {card}")
    return out


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
    variant_launches = phase_variants(rows)
    phase_headline()
    (rate_launches, big_launches, gstream_launches,
     frame_1m6_launches) = phase_large_scenes(rows, *large)
    pt_launches = phase_path_traced_frame()
    light_launches, grid_launches = phase_area_light_frame()
    bwd_launches, bwd_gi_launches = phase_backward(rows)
    phase_grad_parity()
    fit_launches = phase_fit()
    cli_launches = phase_cli(rows)
    phase_resilience()
    multi_launches = phase_multi_device(card, rows)
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
    # Both K1 rows are launches of the CS 16 run's one walk_both count.
    launches["walk_both"] = bwd_launches["walk_both"]
    launches["walk_both_bounce"] = bwd_launches["walk_both"]
    launches["walk_dma_both"] = bwd_gi_launches["walk_dma_both"]
    launches.update(variant_launches)
    for k in ("walk", "walk_dma", "refine_extents", "extents"):
        launches[k + "_cli"] = cli_launches[k]
        launches[k + "_sharded"] = multi_launches["ref_4"][k]
    print(f"[done] launches of the path-traced frame {pt_launches}; of the "
          f"area-light frame {light_launches}; of the fit's 20 steps "
          f"{fit_launches}; of a CLI render at its defaults {cli_launches}; "
          f"of the sharded frames {multi_launches}")
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
