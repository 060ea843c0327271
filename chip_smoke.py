#!/usr/bin/env python3
"""The kernel table of the PyTorch/CUDA port (`raytracing_tpu_torch`): how
fast each CUDA kernel is alone, on one card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

This script times; `tests/test_torch_gpu.py` (`python -m pytest
--noconftest -q -m gpu tests/test_torch_gpu.py`) checks that the kernels
and the paths around them are right on the card, and `rtbench/` measures
the program. A row's `max_abs_err` (each kernel against its plain version
at the row's shape) is part of what the row measures, so it stays here.

Phases (any failure raises and the script exits non-zero):
  1. device — require CUDA; print `nvidia-smi`'s name and power limit;
  2. build  — compile the CUDA kernels from `raytracing_tpu_torch/csrc`
     and the port's host library from
     `raytracing_tpu_torch/native/raytracing_native.cpp`; print every
     kernel's registers, shared memory and spills as `ptxas -v` reports
     them, and refuse a spill in any instance of the split walks
     (`walk.cu`: every intersector family, with and without the lane
     cull; `camera.cu`, `gstream.cu`), the refinement (`refine.cu`,
     capped or not), the work-queue walk (`wq.cu`), K6 (`extents.cu`)
     and the list builds (`lists.cu`); print each pack kernel
     instance's resident blocks and warps a multiprocessor at every
     accepted culling tile's block (K4's blocks of 256 threads at CS 128
     and 16: its warps take any tile's work; the list builds' at the
     threads and shared memory of rows 100 to 50,560 boxes wide)
     (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`), and the build's
     seconds;
  3. kernels against their plain PyTorch versions, on the card, at the
     main paths' shapes; median time of 5 runs each (K6 read steadily:
     200 launches of its entry in one pair of CUDA events over copies of
     its pack in turns that exceed the L2, beside the graphed PyTorch
     composite; the list builds steadily too, 200 launches of their
     entry with the arguments a wrapper call gave it, every output bit
     for bit against the plain version on the card):
     a. the reference frame's busiest 65,536-ray chunk of camera rays
        (CS=16 accel, the `_walk_groups` entry, with the default and the
        origin-folded intersector; its lists, row `lists`, and K6 alone
        at its 65,536 rays, row `extents`) and that chunk's binned
        depth-2 wavefront of 720,896 rays (CS=128 bounce accel: K6 and
        the list build from the pack as a gi_wq=False frame's bounce
        levels take them, rows `extents_gi_wq_false` and
        `lists_gi_wq_false`; the dense refinement with tile-alive flags
        given, the dense query in one launch as `_refined_lists` makes
        it with its lists from its extents and bits, row `lists_ext`,
        and the `_walk_dma` entry, then the rest set's merge into its
        results, row `rest_merge`: `_rest_row`, timed steadily beside
        the plain merge eager and graphed);
     b. camera mode on the whole reference frame (2,500 tiles of 1,024
        rays), CS=16 (`walk_camera`) and CS=128 (`walk_camera_dma`),
        against the plain version lane by lane and against the pack path
        under `shared_origin=0` on all 2,560,000 rays, and the rest set's
        merge into the CS 16 walk's results (row `rest_merge_camera`); the
        CS 16 query's lists from the camera, 2,500 blocks x 790 boxes in
        one launch, row `lists_camera`; phase 5 repeats this on every
        large scene, with its pooled lists held against the direct ones
        (both bit-equal to their plain compositions; the 1.6M pooled
        lists, both stages, are row `lists_camera_pooled`, their second
        stage alone row `lists_camera_members`; the 6.4M lists 50,560 wide
        sort through device memory), and the `walk_camera_dma` row is the
        1.6M launch (launched 10 times, equal every time); phase 4 times
        `walk_camera` at the frame's own shape (one chunk of 64 tiles, as
        the camera-mode frame launches it);
     c. the gathered refinement (`refine_lists`) and the `_walk_dma` entry
        on the depth-2 wavefront of the 404k-triangle subdivided teapot
        (3,160 bounce clusters); phase 5 times `refine_lists` again at the
        1.6M Whitted frame's busiest launch (12,640 clusters), with the
        spread of listed candidates and alive lanes over the tiles;
     d. per-ray t_max: the busiest chunk's area-light shadow query (one
        spherical light, centre (1, 8, 7), radius 1.5) through the
        `_walk_groups` entry (CS=16) and the `_walk_dma` entry (CS=128),
        kernel against plain, and timed beside a scalar t_max;
     e. the streamed-groups walk (`walk_gstream`, K3), run in phase 5 on
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
        with attributes; occlusion under a scalar and a per-ray t_max;
        capped; a tile with no visits); its work (`_wq_row`: the real
        items, its queue against the plain one, the (ray, triangle) tests
        its per-warp cull makes and skips, its bound ray by ray beside
        the tile-granular one, K2 on the same lists in turns);
     h. the walks of a differentiated render: K1 on 3a's chunk and K2 on
        its wavefront carrying the backward's 11 planes beside the
        shading planes (A = 15, rows walk_both_chunk and
        walk_dma_both_chunk; and A = 20 with a color per triangle),
        against their plain versions and against the shading walk (the
        rows of the kernel table come from phase 8's own launches);
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
        16), K2 mt and K4 mt on 3a's wavefront (CS 128; K4 as 3f's rows
        are), K3 mt and woop on
        the chunk over the CS 16 table in 4 groups, the capped K2 walk and
        capped K5 dense query on the wavefront under the reference frame's
        cap, the K1 lane-cull walk on the wavefront; their launches counted
        over a reference frame with gi_cap_frac 0.1 and one with
        gi_wq=False;
     j. the bounce levels' culling tile (`phase_ray_tile`): every pack
        kernel at a tile of 256 rays against its plain version at 256
        (K6, K5 dense + K6, K2 ten launches equal, K1 with and without
        the lane cull, K4 on 3a's wavefront, and K4 at 128 too; K5
        gathered on 3c's 404k wavefront; K3 on the 1.6M frame's chunk-12
        primaries and sun shadows); at 384 and 2,048, tiles the wrappers
        build from launches at 128 and 1,024 with the lists repeated and
        the results folded, K6, K5 dense + K6, K2, K1 with the lane cull
        and K4 on 3a's wavefront and K5 gathered on 3c's, each against its
        plain version at the tile and timed beside its launch at 128 or
        1,024 alone; the wavefront's kernels at 1,024, 512, 256 and 128
        in turns (K6, K5 dense + K6, K2 and K1's visits and times); the
        rows' launches counted over the reference frame at gi_ray_tile
        256, 384 and 2,048 and the gi_wq=False, "grid" and over-budget
        frames at 256 (the "grid" one at 128 too; it and gi_wq=False at
        384 and 2,048), each frame once;
  4. the reference frame — 800x800 at 4 spp, default config: one counted
     frame, then the same with `primary_shared_origin=True` (camera-mode
     primaries), its chunk-20 `walk_camera` launch kept for 3b and that
     launch's lists built from the camera (row `lists_camera_chunk`);
     each frame's launches of the port's kernels printed;
  5. large scenes — the subdivided teapot at 404k (CS=64), 1.6M and 6.4M
     (CS=128) triangles, with mesh-generation and accel-build seconds:
     one counted camera-mode query over the whole 800x800x4 frame at
     1.6M and 6.4M, the pack-path query `nearest_hit_soa` at 1.6M
     and 6.4M (it runs K3), and one counted Whitted frame each of the
     1.6M scene (its primary and sun-shadow queries run K3; chunk 12's
     two launches kept for 3e, and the primary query's group lists, one
     list build from K6's extents over 4 groups of 4,096 boxes, row
     `lists_ext_gstream`) and the 404k scene;
  6. the area-light frame — the reference frame with the light of 3d and 4
     shadow samples, counted with its bounce queries through K2 and then,
     from the same seed, through K4 (`_WQ_IMPL = "grid"`);
  7. the area lights' glue (csrc/light.cu, `phase_light_glue`) at the
     1.6M frame's binned level, 720,896 shaded points with a permuted
     `rows`: one sample's rays (`light_sample`) and a light's last fold
     (`light_fold`) against the plain functions bit for bit, timed
     steadily (a CUDA graph of the wrapper over copies of the inputs
     beyond the L2, replayed) beside the plain chains (median of 5, and
     their launches) and their bounds (rows `light_sample`, `light_fold`
     of the JSON "glue_kernels");
  8. the backward at full width (`bench_suite.py:80-130`): the 262,144
     camera rays of blocks 90-105 of the reference frame through
     `render_rays`, loss sum(rgb^2), gradients for verts, colors and
     materials, on the CS 16 accel and with the CS 128 bounce accel, one
     counted forward + backward each; the K1 primary and first-bounce
     launches of the CS 16 run (rows walk_both and walk_both_bounce) and
     the first K2 bounce launch of the CS 128 run (row walk_dma_both), as
     the renderer made them, against their plain versions and timed;
     8b. the backward's scatter-add (csrc/scatter.cu, `phase_scatter`) at
     the fit cell's level-2 shape (8,650,752 lanes of 3 floats, 8% in
     range, the rest at the drop bucket) against the plain `index_add_`
     line within 1e-5 of its largest magnitude, both timed beside the
     kernel's DRAM bound (row `segment_scatter_add` of "glue_kernels");
  9. the command line (`python -m raytracing_tpu_torch render`) at its
     defaults, in process: its launches are the kernel table's "per CLI
     render" column; its busiest K1 and K2 launches and its K5+K6 and
     list-build launches with the most alive lanes, captured, against
     their plain versions, with K6 alone on that list build's pack: rows
     walk_cli, walk_dma_cli, refine_extents_cli, lists_cli, extents_cli;
 10. the reference frame sharded (`render_sharded`) over 4 virtual shards
     of the card, its launches counted and captured as 9's: rows
     walk_sharded, walk_dma_sharded, refine_extents_sharded,
     lists_sharded, extents_sharded.

Each main path (4, 4 with camera mode, 3i's family queries and frames,
3j's frames, 5's 1.6M camera and pack-path queries, 5's Whitted frames, 6,
each configuration of 8, 9's render, 10's sharded frame) runs with the
launch counts set to 0 just before and read just after, once: nothing
here times a frame (`rtbench/` times the program). A plain version
that takes seconds is timed once, by the run that compares it with the
kernel. The last three lines are each one JSON object: the kernel table
(`{"kernels": [...]}`), the kernels with no TPU counterpart
(`{"glue_kernels": [...]}`) and the result (`{"ok": true, ...}`). The
script never imports JAX.
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
# The spherical light of bench_suite.py:542-546: centre, radius, emission.
LIGHT = ((1.0, 8.0, 7.0), 1.5, (1.5, 1.5, 1.5))
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
    # K6 at the wavefront's 720,896 rays (a gi_wq=False frame's bounce
    # levels at a composed tile take it alone).
    "extents_gi_wq_false": ("raytracing_tpu_torch/csrc/extents.cu",
                            "raytracing_tpu/kernels/traverse.py:163"),
    # The list builds (csrc/lists.cu): from a pack, K6's extents with the
    # lists XLA builds after it (traverse.py:325-380); from extents, those
    # lists alone. The reference frame's chunk and wavefront, the 1.6M
    # frame's K3 groups.
    "lists": ("raytracing_tpu_torch/csrc/lists.cu",
              "raytracing_tpu/kernels/traverse.py:163"),
    "lists_gi_wq_false": ("raytracing_tpu_torch/csrc/lists.cu",
                          "raytracing_tpu/kernels/traverse.py:163"),
    "lists_ext": ("raytracing_tpu_torch/csrc/lists.cu",
                  "raytracing_tpu/kernels/traverse.py:325"),
    "lists_ext_gstream": ("raytracing_tpu_torch/csrc/lists.cu",
                          "raytracing_tpu/kernels/traverse.py:325"),
    # Camera mode's lists with the frustums derived in the kernel: the
    # whole two-teapot frame (2,500 blocks x 790 boxes), the camera-mode
    # frame's chunk, the 1.6M query's pooled lists (both stages) and their
    # second stage alone.
    "lists_camera": ("raytracing_tpu_torch/csrc/lists.cu",
                     "raytracing_tpu/kernels/traverse.py:3291"),
    "lists_camera_chunk": ("raytracing_tpu_torch/csrc/lists.cu",
                           "raytracing_tpu/kernels/traverse.py:3291"),
    "lists_camera_pooled": ("raytracing_tpu_torch/csrc/lists.cu",
                            "raytracing_tpu/kernels/traverse.py:3505"),
    "lists_camera_members": ("raytracing_tpu_torch/csrc/lists.cu",
                             "raytracing_tpu/kernels/traverse.py:3505"),
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
    # The launches of `render` at the CLI's defaults (phase 9).
    "walk_cli": ("raytracing_tpu_torch/csrc/walk.cu",
                 "raytracing_tpu/kernels/traverse.py:972"),
    "walk_dma_cli": ("raytracing_tpu_torch/csrc/walk.cu",
                     "raytracing_tpu/kernels/traverse.py:1819"),
    "refine_extents_cli": ("raytracing_tpu_torch/csrc/refine.cu",
                           "raytracing_tpu/kernels/traverse.py:498"),
    "extents_cli": ("raytracing_tpu_torch/csrc/extents.cu",
                    "raytracing_tpu/kernels/traverse.py:163"),
    "lists_cli": ("raytracing_tpu_torch/csrc/lists.cu",
                  "raytracing_tpu/kernels/traverse.py:163"),
    # The launches of the reference frame sharded over 4 virtual shards of
    # the card (phase 10): raster-order chunks of a shard's rays.
    "walk_sharded": ("raytracing_tpu_torch/csrc/walk.cu",
                     "raytracing_tpu/kernels/traverse.py:972"),
    "walk_dma_sharded": ("raytracing_tpu_torch/csrc/walk.cu",
                         "raytracing_tpu/kernels/traverse.py:1819"),
    "refine_extents_sharded": ("raytracing_tpu_torch/csrc/refine.cu",
                               "raytracing_tpu/kernels/traverse.py:498"),
    "extents_sharded": ("raytracing_tpu_torch/csrc/extents.cu",
                        "raytracing_tpu/kernels/traverse.py:163"),
    "lists_sharded": ("raytracing_tpu_torch/csrc/lists.cu",
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
    # The bounce levels at gi_ray_tile 256 (phase 3j): every pack kernel
    # with a block of 64 threads a tile.
    "extents_rt256": ("raytracing_tpu_torch/csrc/extents.cu",
                      "raytracing_tpu/kernels/traverse.py:163"),
    "refine_extents_rt256": ("raytracing_tpu_torch/csrc/refine.cu",
                             "raytracing_tpu/kernels/traverse.py:498"),
    "refine_lists_rt256": ("raytracing_tpu_torch/csrc/refine.cu",
                           "raytracing_tpu/kernels/traverse.py:648"),
    "walk_rt256": ("raytracing_tpu_torch/csrc/walk.cu",
                   "raytracing_tpu/kernels/traverse.py:972"),
    "walk_lc_rt256": ("raytracing_tpu_torch/csrc/walk.cu",
                      "raytracing_tpu/kernels/traverse.py:972"),
    "walk_dma_rt256": ("raytracing_tpu_torch/csrc/walk.cu",
                       "raytracing_tpu/kernels/traverse.py:1819"),
    "walk_gstream_rt256": ("raytracing_tpu_torch/csrc/gstream.cu",
                           "raytracing_tpu/kernels/traverse.py:1414"),
    "walk_wq_rt256": ("raytracing_tpu_torch/csrc/wq.cu",
                      "raytracing_tpu/kernels/traverse.py:2063"),
    "walk_wq_rt128": ("raytracing_tpu_torch/csrc/wq.cu",
                      "raytracing_tpu/kernels/traverse.py:2063"),
}
# Phase 3j's tiles outside RAY_TILES, which the wrappers build from
# launches at the largest tile of RAY_TILES dividing them (`_split_tile`):
# 3 x 128 and 2 x 1,024. The rows "<entry>_rt<tile>" of these entries
# hold each composed wrapper against its plain version at the tile.
COMPOSED_TILES = (384, 2048)
COMPOSED = ("extents", "refine_extents", "refine_lists", "walk_lc",
            "walk_dma", "walk_wq")
KERNELS.update({f"{e}_rt{t}": KERNELS[f"{e}_rt256"]
                for t in COMPOSED_TILES for e in COMPOSED})
# Published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside
# the tensor cores, and device memory.
PEAK_FP32 = 67e12
PEAK_HBM = 3.35e12
# Floating-point operations per (ray, triangle) test, comparisons and the
# (t, slot) update included, as counted in csrc/walk_core.cuh; per
# (ray, box) slab test in csrc/refine.cu; per ray in csrc/extents.cu.
OPS_PMT, OPS_PMTO, OPS_SLAB, OPS_EXTENTS = 40, 30, 30, 16
# ... per (tile, box) interval slab test of a list build in csrc/lists.cu:
# per axis 2 subtractions, 4 products, 3 min and 3 max; the axes' folds, the
# cap and the two comparisons.
OPS_FRUSTUM = 41
# ... and of the other intersector families' tests, counted the same way:
# mt's cross products, determinant, reciprocal and three dots; woop's six
# transform rows and its epilogue.
OPS_MT, OPS_WOOP = 55, 51
# ... and of the rest-set merge (csrc/rest.cu) per (ray, rest triangle):
# mt's as above, its limit test and the comparison with the running best.
OPS_REST = 56
# ... and of the area lights' glue (csrc/light.cu) per lane: a sample's
# cone, cone sample, tangent frame, three normalisations, n.l and the ray
# against the light's sphere, its sine and cosine at ~20 each; a light's
# last fold, its cone again, the visibility sum and the term.
OPS_LIGHT_SAMPLE, OPS_LIGHT_FOLD = 170, 40
# Phase 3i's two-phase cap: the renderer's gi_cap_frac of the frame.
CAP_FRAC = 0.1
# List rows' widths that phase 2 reads the list build's occupancy at: the
# CS 128 bounce accel, the CS 16 table, K3's groups at 1.6M, the 404k CS 64
# table, the shared-memory sort's cap, K3's widest group (an occlusion
# query at CS 16) and the 6.4M table (the device-memory merge).
LIST_WIDTHS = (100, 790, 4096, 6320, 16384, 43690, 50560)
# Phase 3j's culling tile of the bounce levels (gi_ray_tile): JAX's test's.
GI_TILE = 256
# K6's steady reading: back-to-back launches in one pair of CUDA events,
# over copies of its 23 MB pack that together exceed the card's 50 MB L2.
STEADY_LAUNCHES = 200
L2_COPIES = 4
L2_BYTES = 50 * 2 ** 20


class SmokeFailure(RuntimeError):
    pass


def _require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def sphere_light(device="cuda"):
    import torch

    from raytracing_tpu_torch.geometry.mesh import SphereLight

    c, r, e = LIGHT
    return SphereLight(torch.tensor([c]), torch.tensor([r]),
                       torch.tensor([e])).to(device)


def counted_frame(scene, cfg, accel, gi_accel=None):
    """One Whitted frame with the launch counts set to 0 just before and
    read just after. Returns the launches (`kernels.traverse.LAUNCHES`)."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.models import whitted

    torch.cuda.synchronize()
    T.reset_launches()
    whitted.render(scene, cfg, accel=accel, gi_accel=gi_accel)
    torch.cuda.synchronize()
    return dict(T.LAUNCHES)


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


def _extents_row(rows, name, bp, ray_tile=1024):
    """K6 (`tile_extents`) on the pack `bp` in tiles of `ray_tile` against
    its plain version, bit for bit, timed into rows[name]. Returns the
    plain (lo, hi)."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T

    lo, hi = T.tile_extents(bp, ray_tile)
    plo, phi = T.tile_extents_plain(bp, ray_tile)
    _require(torch.equal(lo, plo) and torch.equal(hi, phi),
             f"{name} (K6): lo/hi differ")
    live = phi[:, 7] > 0
    err = float(torch.cat([(lo - plo)[live], (hi - phi)[live]]).abs().max()
                ) if live.any() else 0.0
    nt = bp.shape[1] // ray_tile
    print(f"[kernels] {name} (K6): {nt} tiles of {ray_tile}, "
          f"{int(live.sum())} alive, equal")
    _row(rows, name, err, lambda: T.tile_extents(bp, ray_tile),
         lambda: T.tile_extents_plain(bp, ray_tile),
         _bound(OPS_EXTENTS * bp.shape[1], bp.numel() * 4 + nt * 64),
         f"{bp.shape[1]} rays")
    return plo, phi


def _refine_extents_row(rows, name, rargs, shape, ray_tile=1024):
    """K5 dense with K6's extents (`refine_dense_extents`) on (pack, boxes)
    `rargs` in tiles of `ray_tile` against its plain version, extents and
    bits bit for bit, timed into rows[name] with its bound from this
    data's entered bits."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T

    bp = rargs[0]
    tile = dict(ray_tile=ray_tile)
    flo, fhi, fent = T.refine_dense_extents(*rargs, **tile)
    plo, phi, pent = T.refine_dense_extents_plain(*rargs, **tile)
    _require(torch.equal(flo, plo) and torch.equal(fhi, phi)
             and torch.equal(fent, pent),
             f"{name} (K5 dense + K6): extents or bits differ from "
             f"tile_extents_plain / refine_dense_plain")
    live = phi[:, 7] > 0
    err = float(torch.cat([(flo - plo)[live], (fhi - phi)[live]]).abs().max()
                ) if live.any() else 0.0
    c, nt = rargs[1].shape[0], bp.shape[1] // ray_tile
    lanes = _tile_alive_lanes(bp, ray_tile)
    _, _, tests = _refine_bound(lanes, live.to(torch.int32) * c,
                                pent.sum(dim=1), bp, c, c)
    print(f"[kernels] {name} (K5 dense + K6): extents and bits equal; "
          f"{int(pent.sum())} of {pent.numel()} bits set; "
          f"{_list_stats(live * c, lanes)}; (ray, box) tests the bound "
          f"counts: {tests}")
    _row(rows, name, err, lambda: T.refine_dense_extents(*rargs, **tile),
         lambda: T.refine_dense_extents_plain(*rargs, **tile),
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


def _steady_extents(rows, name, bp, plo, phi):
    """K6 read steadily at the shape of rows[name]: its kernel's entry
    called directly (no wrapper in the loop) STEADY_LAUNCHES times in one
    pair of CUDA events, in turns on copies of the pack that together
    exceed the card's 50 MB L2 (at least L2_COPIES), so each launch reads
    its pack from device memory as the bound counts; beside it the plain
    PyTorch composite (`where`, `amin`, `amax` and the transposes of
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
    copies = max(L2_COPIES, -(-2 * L2_BYTES // (bp.numel() * 4)))
    packs = [bp] + [bp.clone() for _ in range(copies - 1)]
    outs = [(torch.empty((nt, 8), device="cuda"),
             torch.empty((nt, 8), device="cuda")) for _ in packs]
    calls = [(p.data_ptr(), p.shape[1], T.RAY_TILE, lo.data_ptr(),
              hi.data_ptr(), stream) for p, (lo, hi) in zip(packs, outs)]
    for args in calls:
        cuda.check(lib.rt_tile_extents(*args), "extents")
    _require(all(torch.equal(lo, plo) and torch.equal(hi, phi)
                 for lo, hi in outs),
             f"{name} (K6), entry called directly: lo/hi differ")
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
             f"{name}: the graphed composite differs from the plain version")
    composite = _steady_ms(graph.replay) / len(packs)
    del graph, graphed, packs
    row = rows[name]
    bound = row["bound_ms"]
    print(f"[kernels] {name} (K6) steady, {STEADY_LAUNCHES} launches in one "
          f"pair of events: entry {entry} ms over {copies} packs of "
          f"{bp.shape[1]} rays in turns ({bound / entry} of its {bound} ms "
          f"bound by {row['bound_by']}); the PyTorch composite (graphed, "
          f"packs in turns) {composite} ms, {composite / entry}x the entry; "
          f"median of 5 wrapper calls {row['ms']} ms")
    row["ms"] = entry
    row["plain_graphed_ms"] = composite


class _PlainWrappers:
    """Within it, every wrapper of kernels.traverse takes its plain
    version on the card's tensors (`_on_cpu` answers yes)."""

    def __enter__(self):
        from raytracing_tpu_torch.kernels import traverse as T

        self.real = T._on_cpu
        T._on_cpu = lambda *tensors: True

    def __exit__(self, *exc):
        from raytracing_tpu_torch.kernels import traverse as T

        T._on_cpu = self.real


def _bit_equal(name, got, want):
    """Require `got` equal to `want` bit for bit (floats by their bits:
    -0.0 against +0.0 too); returns the max abs difference over the
    positions where both are finite (0.0)."""
    import torch

    err = 0.0
    for a, b in zip(got, want):
        _require(a.shape == b.shape and a.dtype == b.dtype,
                 f"{name}: shape or type differs from the plain version")
        if a.is_floating_point():
            both = torch.isfinite(a) & torch.isfinite(b)
            if bool(both.any()):
                err = max(err, float((a[both].double() - b[both].double())
                                     .abs().max()))
            same = torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            err = max(err, float((a.long() - b.long()).abs().max())
                      if a.numel() else 0.0)
            same = torch.equal(a, b)
        _require(same, f"{name}: differs from its plain version (max abs "
                 f"{err})")
    return err


def _steady_entry(entries, run):
    """(run()'s result, ms per call) of the kernel entries `entries` (one
    `rt_*` name of the kernel library, or a tuple of them) that `run()`
    launches once each: their ctypes arguments captured, then the entries
    called directly in turn STEADY_LAUNCHES times in one pair of CUDA
    events (`_steady_ms`), no wrapper in the loop. The scratch and the
    list outputs the wrapper allocates stay alive meanwhile (a later
    entry may read an earlier one's), and the outputs must read the same
    after the loop."""
    import torch

    from raytracing_tpu_torch.kernels import cuda
    from raytracing_tpu_torch.kernels import traverse as T

    entries = (entries,) if isinstance(entries, str) else tuple(entries)
    lib = cuda.library()
    seen, keep = {e: [] for e in entries}, []

    class Proxy:
        def __getattr__(self, name):
            fn = getattr(lib, name)
            if name not in seen:
                return fn

            def call(*args):
                seen[name].append(args)
                return fn(*args)
            return call

    scratch, outputs = T._lists_scratch, T._list_outputs
    real = cuda.library
    cuda.library = Proxy
    T._lists_scratch = lambda *a: keep.append(scratch(*a)) or keep[-1]
    T._list_outputs = lambda *a: keep.append(outputs(*a)) or keep[-1]
    try:
        out = run()
    finally:
        cuda.library = real
        T._lists_scratch, T._list_outputs = scratch, outputs
    for e in entries:
        _require(len(seen[e]) == 1, f"{e}: {len(seen[e])} launches, not one")
    calls = [(getattr(lib, e), seen[e][0]) for e in entries]
    before = [t.clone() for t in out]

    def launch():
        for fn, args in calls:
            fn(*args)
    ms = _steady_ms(launch)
    torch.cuda.synchronize()
    _require(all(torch.equal(a, b) for a, b in zip(out, before)),
             f"{entries}: the outputs changed over the steady launches")
    del keep
    return out, ms


def _lists_work(rows_, width, rays=0, ext_rows=0, mask_bytes=0):
    """(operations, bytes) of a list build: `rows_` list rows of `width`
    boxes, each (tile, box) pair one interval slab test (OPS_FRUSTUM) and
    each list position written once (ids and tnear, 8 bytes), the boxes
    read once; from a pack, `rays` rays read once (32 bytes, OPS_EXTENTS
    each) and [nt, 8] lo and hi written; from extents, `ext_rows` rows of
    12 extents and an alive value read; and the mask's bytes (a camera
    row's frustum comes from the camera: none of these)."""
    ops = OPS_FRUSTUM * rows_ * width + OPS_EXTENTS * rays
    nbytes = (rows_ * (width * 8 + 4) + width * 24 + rays * 32
              + (rays and rows_ * 64) + ext_rows * 52 + mask_bytes)
    return ops, nbytes


def _lists_bound(*args, **kw):
    """The bound of a list build (`_lists_work`)."""
    return _bound(*_lists_work(*args, **kw))


def _lists_row(rows, name, args, shape):
    """The list build from a pack (`tile_lists`, csrc/lists.cu) on `args`
    (pack, boxes, t_cap, ray_tile) against its plain version on the card,
    every output bit for bit, timed steadily into rows[name] beside the
    plain version (median of 5) and its bound."""
    from raytracing_tpu_torch.kernels import traverse as T

    rp, cmin = args[0], args[1]
    got, ms = _steady_entry("rt_tile_lists", lambda: T.tile_lists(*args))
    with _PlainWrappers():
        want = T.tile_lists(*args)
        plain_ms = _median_ms(lambda: T.tile_lists(*args))
    err = _bit_equal(name, got, want)
    ray_tile = args[4] if len(args) > 4 else T.RAY_TILE
    nt, c = rp.shape[1] // ray_tile, cmin.shape[0]
    bound = _lists_bound(nt, c, rays=rp.shape[1])
    wrapper = _median_ms(lambda: T.tile_lists(*args))
    rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound[0], bound_by=bound[1], shape=shape)
    print(f"[kernels] {name} (lists.cu, from a pack): {nt} tiles x {c} "
          f"boxes, {int(got[4].sum())} listed, {int((got[1][:, 7] > 0).sum())}"
          f" tiles alive; equal bit for bit; steady {ms:.5f} ms (median of 5 "
          f"wrapper calls {wrapper:.4f}), plain {plain_ms:.4f} ms, bound "
          f"{bound[0]:.5f} ms by {bound[1]} ({shape})")
    return got


def _lists_ext_row(rows, name, args, kw, shape):
    """The list build from extents (`lists_from_extents`, csrc/lists.cu)
    on (args, kw) as a query path made it, against its plain version on
    the card bit for bit, timed steadily into rows[name] (`_lists_row`)."""
    from raytracing_tpu_torch.kernels import traverse as T

    got, ms = _steady_entry("rt_lists_from_extents",
                            lambda: T.lists_from_extents(*args, **kw))
    with _PlainWrappers():
        want = T.lists_from_extents(*args, **kw)
        plain_ms = _median_ms(lambda: T.lists_from_extents(*args, **kw))
    err = _bit_equal(name, got, want)
    nt, c = args[0].shape[0], args[4].shape[0]
    g = kw.get("groups") or 1
    mask = kw.get("mask")
    bound = _lists_bound(g * nt, c // g, ext_rows=nt,
                         mask_bytes=0 if mask is None else mask.numel())
    wrapper = _median_ms(lambda: T.lists_from_extents(*args, **kw))
    rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound[0], bound_by=bound[1], shape=shape)
    print(f"[kernels] {name} (lists.cu, from extents): {g} x {nt} rows x "
          f"{c // g} boxes, {int(got[2].sum())} listed; equal bit for bit; "
          f"steady {ms:.5f} ms (median of 5 wrapper calls {wrapper:.4f}), "
          f"plain {plain_ms:.4f} ms, bound {bound[0]:.5f} ms by {bound[1]} "
          f"({shape})")
    return got


def _camera_lists_row(rows, names, args, shape):
    """Camera mode's list build (`camera_lists`, csrc/lists.cu) on `args`
    (accel, offs, cam, tile0, tiles) as a query made it, against its plain
    composition on the card bit for bit, timed steadily (every launch of
    the call in turn, the pooled lists' host sync left out: the width
    stays the first call's) into rows[names[0]] beside the plain
    composition (median of 5) and its bound; for the pooled lists, their
    second stage (`rt_camera_member_lists`) alone too, into
    rows[names[1]], beside the plain second stage. Returns the lists."""
    from raytracing_tpu_torch.kernels import traverse as T

    acc, offs, cam, tile0, tiles = args
    pooled = T._pooled(acc, cam, tile0, tiles)
    entries = ("rt_camera_lists",) + (("rt_camera_member_lists",)
                                      if pooled else ())
    got, ms = _steady_entry(entries, lambda: T.camera_lists(*args))
    with _PlainWrappers():
        want = T.camera_lists(*args)
        plain_ms = _median_ms(lambda: T.camera_lists(*args))
    err = _bit_equal(names[0], got, want)
    c, w = acc.num_clusters, got[0].shape[1]
    wrapper = _median_ms(lambda: T.camera_lists(*args))
    work = _lists_work(tiles, c)
    if pooled:
        gy, gx, _, _, nby2, nbx2 = T._supertiles(cam)
        members = _lists_work(tiles, w)
        work = tuple(a + b for a, b in zip(_lists_work(nby2 * nbx2, c),
                                           members))
    bound = _bound(*work)
    rows[names[0]] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound[0], bound_by=bound[1], shape=shape)
    how = (f" through {nby2 * nbx2} supertiles of {gy}x{gx} blocks, "
           f"candidates {w} wide" if pooled else "")
    print(f"[kernels] {names[0]} (lists.cu, camera): {tiles} blocks x {c} "
          f"boxes{how}, {int(got[2].sum())} listed; equal bit for bit; steady "
          f"{ms:.5f} ms ({len(entries)} launch(es); median of 5 wrapper "
          f"calls {wrapper:.4f}), plain {plain_ms:.4f} ms, bound "
          f"{bound[0]:.5f} ms by {bound[1]} ({shape})")
    if pooled:
        got2, ms2 = _steady_entry("rt_camera_member_lists",
                                  lambda: T.camera_lists(*args))
        ext = T._camera_tile_extents(tiles, offs, cam, tile0)
        with _PlainWrappers():
            first = T._supertile_lists(acc, ext, cam)
            plain2 = _median_ms(
                lambda: T._pooled_camera_lists(acc, ext, cam, first))
            err2 = _bit_equal(names[1], got2, T._pooled_camera_lists(
                acc, ext, cam, first))
        del ext, first
        bound2 = _bound(*members)
        rows[names[1]] = dict(max_abs_err=err2, ms=ms2, plain_ms=plain2,
                              bound_ms=bound2[0], bound_by=bound2[1],
                              shape=f"{shape}: the second stage alone")
        print(f"[kernels] {names[1]} (lists.cu, the pooled lists' second "
              f"stage): {tiles} blocks x {w} candidates; equal bit for "
              f"bit; steady {ms2:.5f} ms, plain {plain2:.4f} ms, bound "
              f"{bound2[0]:.5f} ms by {bound2[1]}")
    return got


def _graph_ms(fn, copies):
    """ms a call of fn(k) over the copies k in turns: one CUDA graph of a
    call on each copy, replayed STEADY_LAUNCHES / copies times."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for k in range(copies):
            fn(k)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(copies):
            fn(k)
    reps = max(1, STEADY_LAUNCHES // copies)
    ms = _steady_ms(graph.replay, reps) / copies
    del graph
    return ms


def _rest_row(rows, name, merge, inputs, rest_rows, reads, shape):
    """The rest-set merge (csrc/rest.cu) into a walk's outputs: `merge(*x)`
    (a wrapper of kernels.traverse) on copies x of `inputs` (tensors or
    None), every output bit for bit against its plain version on the card,
    the kernel's update in place; timed steadily into rows[name]: one CUDA
    graph of the merge over copies of the inputs that together exceed the
    L2, replayed STEADY_LAUNCHES / copies times (no wrapper in the loop).
    The merge is idempotent, so a steady launch writes nothing: its bound
    is `reads` bytes a launch from device memory, or OPS_REST operations
    for each of its rays against each of `rest_rows` rest triangles,
    whichever is longer. plain ms: median of 5 eager calls (a query's
    launches), beside it the graphed composite."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T

    def copy():
        return [None if x is None else x.clone() for x in inputs]

    with _PlainWrappers():
        want = [x for x in merge(*copy()) if x is not None]
        plain_ms = _median_ms(lambda: merge(*inputs))
    before = T.LAUNCHES["rest_merge"]
    mine = copy()
    got = [x for x in merge(*mine) if x is not None]
    _require(T.LAUNCHES["rest_merge"] == before + 1,
             f"{name}: not one rest_merge launch")
    _require(all(any(g is m for m in mine) for g in got),
             f"{name}: the kernel did not update the walk's outputs in place")
    err = _bit_equal(name, got, want)
    better = int((want[0] < inputs[0]).sum())
    per = sum(x.numel() * x.element_size() for x in inputs if x is not None)
    copies = max(L2_COPIES, -(-2 * L2_BYTES // per))
    sets = [copy() for _ in range(copies)]
    for x in sets:
        merge(*x)
    ms = _graph_ms(lambda k: merge(*sets[k]), copies)
    _require(all(torch.equal(a, b) for x in sets
                 for a, b in zip([y for y in x if y is not None], want)),
             f"{name}: the outputs changed over the steady launches")
    with _PlainWrappers():
        composite = _graph_ms(lambda k: merge(*sets[k]), copies)
    del sets
    n = inputs[0].shape[1]
    bound = _bound(float(n) * rest_rows * OPS_REST, reads)
    rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                      plain_graphed_ms=composite, bound_ms=bound[0],
                      bound_by=bound[1], shape=shape)
    print(f"[kernels] {name} (rest.cu): {n} rays x {rest_rows} rest "
          f"triangles, {better} taken from the rest set; equal bit for bit, "
          f"in place; steady {ms:.5f} ms over {copies} copies in turns "
          f"({bound[0] / ms:.3f} of its {bound[0]:.5f} ms bound by "
          f"{bound[1]}: {reads} bytes read, none written once merged), plain "
          f"{plain_ms:.4f} ms (graphed {composite:.5f} ms) ({shape})")


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
                                   "wq_plan", "wq_warp", "wq_finish", "walk",
                                   "refine_lists", "refine", "camera_lists",
                                   "lists", "extents")
                       if k + "_kernel" in mangled), mangled)
        variant = mangled.split(kernel + "_kernel")[-1].split("Ev")[0]
        used = next(l for l in lines[i:] if "Used" in l).split(":", 1)[1]
        spill = next(l for l in lines[i:] if "spill" in l).strip()
        print(f"[build] {kernel}_kernel {variant}:{used}; {spill}")
        _require(not any(f"_{src}_cu_" in mangled
                         for src in ("walk", "camera", "gstream", "refine",
                                     "wq", "lists", "extents"))
                 or " 0 bytes spill stores, 0 bytes spill loads"
                 in " " + spill, f"{kernel}_kernel {variant} spills "
                 f"registers: {spill}")
    _print_occupancy(cuda.library())
    print(f"[build] {res.seconds:.2f} s -> {os.path.relpath(res.path, HERE)}")
    from raytracing_tpu_torch.geometry import native

    t0 = time.perf_counter()
    _require(native.available(),
             "the host library (raytracing_tpu_torch/native/"
             "raytracing_native.cpp) did not build: the large scenes need "
             "it")
    print(f"[build] host library {time.perf_counter() - t0:.2f} s")
    return res.seconds


def _print_occupancy(lib):
    """Resident blocks (and warps) per multiprocessor of every instance of
    the pack kernels at each accepted tile's block of T / 4 threads, as
    `cudaOccupancyMaxActiveBlocksPerMultiprocessor` reads them: the K2
    instance (walk.cu, pmt nearest) first."""
    import ctypes

    from raytracing_tpu_torch.kernels import traverse as T

    threads = [t // 4 for t in reversed(T.RAY_TILES)]

    def line(name, fn, *args, smem=None):
        got = []
        for n in threads:
            blocks = ctypes.c_int(0)
            extra = () if smem is None else (smem,)
            _require(fn(*args, n, *extra, ctypes.byref(blocks)) == 0,
                     f"occupancy of {name} at {n} threads failed")
            got.append(f"{n} threads {blocks.value} blocks "
                       f"({blocks.value * n // 32} warps)")
        print(f"[build] occupancy {name}: {'; '.join(got)}")

    families = {"pmt": 0, "pmto": 1, "mt": 2, "woop": 3}
    line("walk (K1/K2) pmt nearest", lib.rt_walk_occupancy, 0, 1, 0, 0)
    for fam, f in families.items():
        for nearest, lc, capped in ((1, 0, 0), (1, 0, 1), (1, 1, 0),
                                    (1, 1, 1), (0, 0, 0), (0, 1, 0)):
            line(f"walk {fam} {'nearest' if nearest else 'occlusion'}"
                 f"{' lane-cull' if lc else ''}{' capped' if capped else ''}",
                 lib.rt_walk_occupancy, f, nearest, lc, capped)
        for nearest, capped in ((1, 0), (1, 1), (0, 0)):
            tag = f"{'nearest' if nearest else 'occlusion'}" \
                  f"{' capped' if capped else ''}"
            line(f"gstream {fam} {tag}", lib.rt_gstream_occupancy, f,
                 nearest, capped)
            if fam == "woop":
                continue
            # K4's blocks are 256 threads at every tile: its warps take
            # 128-lane units of any tile.
            got = []
            for cs in (128, 16):
                blocks = ctypes.c_int(0)
                _require(lib.rt_wq_occupancy(f, nearest, capped, cs,
                                             ctypes.byref(blocks)) == 0,
                         f"occupancy of wq {fam} {tag} failed")
                got.append(f"CS {cs} {blocks.value} blocks "
                           f"({blocks.value * 8} warps)")
            print(f"[build] occupancy wq {fam} {tag}, 256 threads: "
                  f"{'; '.join(got)}")
    line("extents", lib.rt_extents_occupancy)
    # The list builds: the threads and shared memory a launch takes follow
    # the row's width (csrc/lists.cu lists_shape).
    for source, what in ((1, "from a pack"), (0, "from extents"),
                         (2, "from the camera"),
                         (3, "the camera's member rows")):
        got = []
        for width in LIST_WIDTHS:
            n, blocks = ctypes.c_int(0), ctypes.c_int(0)
            _require(lib.rt_lists_occupancy(source, width,
                                            ctypes.byref(n),
                                            ctypes.byref(blocks)) == 0,
                     f"occupancy of lists at width {width} failed")
            got.append(f"width {width}: {n.value} threads {blocks.value} "
                       f"blocks ({blocks.value * n.value // 32} warps)")
        print(f"[build] occupancy lists {what}: {'; '.join(got)}")
    for lists, capped in ((0, 0), (0, 1), (1, 0), (1, 1)):
        # the dense form's boxes for 100 clusters (the CS 128 bounce
        # accel), the gathered form's for a run of _REFINE_RUN
        smem = 7 * 4 * (T._REFINE_RUN if lists else 100)
        line(f"refine {'gathered' if lists else 'dense'}"
             f"{' capped' if capped else ''}", lib.rt_refine_occupancy,
             lists, capped, smem=smem)


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


def _launch_args(kernel, args, kw):
    """(args, kw) of the launch that a pack walk wrapper (`walk`,
    `walk_gstream`, `walk_wq`) makes at a tile outside RAY_TILES: its
    lists repeated for the k launch tiles of each tile (along the tile
    axis: K3's is the second), at s (`_split_tile`)."""
    from raytracing_tpu_torch.kernels import traverse as T

    s, k = T._split_tile(kw.get("ray_tile"))
    dim = 1 if kernel == "walk_gstream" else 0
    args = (args[0], T._per_subtile(args[1], k, dim),
            T._per_subtile(args[2], k, dim)) + tuple(args[3:])
    kw = dict(kw, ray_tile=s)
    if kw.get("tnear") is not None:
        kw["tnear"] = T._per_subtile(kw["tnear"], k, dim)
    return args, kw


def _timed_walk(rows, name, tag, T, args, kw, alive, ops_per_test, shape,
                nearest=True, plain_reps=5, kernel="walk", bound_visits=None):
    """Compare one pack walk launch (`walk`, `walk_gstream` or `walk_wq`)
    with its plain version, then time both and reckon the launch's bound
    from the visits it made (or `bound_visits` per tile: the lane cull's
    kernel reports the visits it staged, not those it tested). The
    geometry rows the bound reads are the intersector family's. At a tile
    outside RAY_TILES the bound counts the visits of its launch tiles
    (`bound_visits` then per launch tile), and the launch alone at s on
    the repeated lists (`_launch_args`) is timed into the row's
    "launch_ms", beside the wrapper's time with the fold. Returns the
    kernel's result."""
    import functools

    import torch

    fn, plain = getattr(T, kernel), getattr(T, kernel + "_plain")
    if kw.get("lane_bounds") is not None:
        plain = functools.partial(plain, lane_bounds=kw["lane_bounds"])
    rp, ids, cnt, geo, attr, n_attrs, cs = args[:7]
    ray_tile = kw.get("ray_tile", T.RAY_TILE)
    s, k = T._split_tile(ray_tile)
    plain = functools.partial(plain, ray_tile=ray_tile)
    if kernel == "walk_wq":  # no early exit: every listed visit is made
        visits, tile_visits, out = cnt, cnt, fn(*args, **kw)
    else:
        visits = torch.zeros(cnt.shape, dtype=torch.int32, device=rp.device)
        out = fn(*args, **kw, visits=visits)
        # K3 lists per (group, tile): a tile's visits are its groups' sum.
        tile_visits = visits if visits.dim() == 1 else visits.sum(dim=0)
    bound_tile = ray_tile
    if k > 1:
        sargs, skw = _launch_args(kernel, args, kw)
        if kernel != "walk_wq":  # each launch tile's own visits
            bound_tile = s
            v = torch.zeros(sargs[2].shape, dtype=torch.int32,
                            device=rp.device)
            fn(*sargs, **skw, visits=v)
            tile_visits = v if v.dim() == 1 else v.sum(dim=0)
    want, plain_ms = _timed_once(lambda: plain(*args))
    err = _compare_walk(tag, out, want, alive, nearest)
    del want
    tr = args[-1]  # the per-ray limit row, read once
    bound = _walk_bound(tile_visits if bound_visits is None else bound_visits,
                        _tile_alive_lanes(rp, bound_tile), cnt, geo, attr,
                        n_attrs if nearest else 0, cs, rp.shape[1],
                        rp.numel() * 4 + (0 if tr is None else tr.numel() * 4),
                        ops_per_test, kw.get("tnear") is not None,
                        T._FAMILY_ROWS[int(args[-2])])
    made, listed = int(visits.sum()), int(cnt.sum())
    if k > 1:  # each launch tile walks its tile's whole list
        listed *= k
        made = listed if kernel == "walk_wq" else made
    _row(rows, name, err, lambda: fn(*args, **kw), lambda: plain(*args),
         bound, f"{shape}, {made} of {listed} listed visits",
         plain_reps=plain_reps, plain_ms=plain_ms if plain_reps == 1 else None)
    if k > 1:
        _launch_row(rows[name], name, lambda: fn(*sargs, **skw), s, k)
    return out


def _launch_row(row, name, launch, s, k):
    """Time `launch`, the kernel at s that a wrapper at a tile of k launch
    tiles makes, into row["launch_ms"]: the wrapper's time less it is the
    fold (the repeated lists, the min / max or any)."""
    row["launch_ms"] = _median_ms(launch)
    print(f"[ray_tile] {name}: {k} launch tiles of {s} a tile; wrapper "
          f"{row['ms']} ms, the launch at {s} alone {row['launch_ms']} ms, "
          f"the fold {row['ms'] - row['launch_ms']} ms")


def _wq_work(args, kw):
    """What K4's launch `walk_wq(*args, **kw)` has to do on this data,
    counted in plain PyTorch: its work items (`wq_queue_plain`), the listed
    visits, the visits of a 128-lane warp some alive ray of which enters
    the cluster (`_lane_enters`: the (ray, triangle) tests the per-warp
    cull makes are these x 128 x CS), and the (ray, listed cluster) pairs
    whose ray enters (the least work any walk of these lists needs). The
    queue and the runs are the launch's: at a tile outside RAY_TILES each
    launch tile takes its tile's whole list (`_launch_args`)."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T

    rp, ids, cnt = args[:3]
    sub = kw.get("ray_tile", T.RAY_TILE) // 128
    listed = torch.clamp_max(cnt.to(torch.int64), ids.shape[1])
    pack = rp.reshape(8, -1, 1, 128)
    lanes = torch.arange(sub, device=rp.device)
    warp_visits = ray_visits = 0
    for j in range(int(listed.max()) if listed.numel() else 0):
        act = torch.nonzero(listed > j).squeeze(1)
        enter = T._lane_enters(pack, (act[:, None] * sub + lanes).reshape(-1),
                               ids[act, j].repeat_interleave(sub),
                               kw["lane_bounds"])
        warp_visits += int(enter.any(dim=1).sum())
        ray_visits += int(enter.sum())
    s, k = T._split_tile(kw.get("ray_tile"))
    sub, cnt = s // 128, T._per_subtile(cnt, k)
    lanes = torch.arange(sub, device=rp.device)
    queue = T.wq_queue_plain(cnt, ids.shape[1], kw["u"])
    # The runs the warps merge: unit x of warp w of tile t is first[t] *
    # sub + w * items + k, a take the units [run c, run (c + 1)).
    items = (queue[1:] - queue[:-1]).to(torch.int64)[:, None]
    start = queue[:-1].to(torch.int64)[:, None] * sub + lanes * items
    run = T.WQ_RUN
    runs = ((start + items - 1) // run - start // run + 1)[
        items.expand(-1, sub) > 0]
    return dict(items=int(queue[-1]), units=int(queue[-1]) * sub,
                visits=int(listed.sum()), warp_visits=warp_visits,
                ray_visits=ray_visits, queue=queue, runs=int(runs.sum()),
                warps=int(runs.numel()))


def _wq_row(rows, name, tag, T, args, kw, alive, ops_per_test, shape,
            k2=None):
    """A K4 row: `_timed_walk` against the plain version, then the work
    the launch made (`_wq_work`): its real items (the queue the launch
    writes, held against the plain one), the tests the warp cull makes
    and skips, and its bound from the ray-granular work — each ray against
    only the listed clusters it enters — beside the tile-granular bound
    `_timed_walk` reckons (every alive lane of a tile). With k2 = (args,
    kw) of K2 on the same lists, both are timed in turns (K4, K2, K2,
    K4)."""
    import torch

    out = _timed_walk(rows, name, tag, T, args, kw, alive, ops_per_test,
                      shape, plain_reps=1, kernel="walk_wq")
    rp, ids, cnt, geo, attr, n_attrs, cs = args[:7]
    nearest, tr = args[8], args[-1]
    work = _wq_work(args, kw)
    queue = torch.empty(work["queue"].shape[0] + 1, dtype=torch.int32,
                        device="cuda")
    T.walk_wq(*args, **kw, queue=queue)
    _require(torch.equal(queue[:-1], work["queue"]),
             f"{name} (K4): the work queue differs from wq_queue_plain")
    row = rows[name]
    row["tile_bound_ms"] = row["bound_ms"]
    row["bound_ms"], row["bound_by"] = _walk_bound(
        torch.tensor([work["ray_visits"]]), torch.ones(1), cnt, geo, attr,
        n_attrs if nearest else 0, cs, rp.shape[1],
        rp.numel() * 4 + (0 if tr is None else tr.numel() * 4),
        ops_per_test, False, T._FAMILY_ROWS[int(args[-2])])
    rt = kw.get("ray_tile", T.RAY_TILE)
    made = work["warp_visits"] * 128 * cs
    every = work["visits"] * rt * cs
    warps = max(work["warps"], 1)
    row.update(items=work["items"], tests=made,
               warp_visits=work["warp_visits"])
    print(f"[kernels] {name} (K4): {work['items']} work items of "
          f"{kw['u']} visits ({work['visits']} listed visits, queue equal); "
          f"{work['warp_visits']} of {work['visits'] * (rt // 128)} "
          f"warp-visits entered: {made} (ray, triangle) tests made, "
          f"{every - made} of {every} skipped ({made / every:.4f} made); "
          f"{work['ray_visits'] * cs} tests ray by ray; bound "
          f"{row['bound_ms']:.6f} ms ray-granular "
          f"({row['bound_ms'] / row['ms']:.4f} of the kernel's time), "
          f"{row['tile_bound_ms']:.6f} ms tile-granular "
          f"({row['tile_bound_ms'] / row['ms']:.4f}); {work['runs']} runs "
          f"merged by {work['warps']} 128-lane warps with work "
          f"({work['runs'] / warps:.3f} merges a lane, against "
          f"{work['units'] / warps:.3f} at one an item)")
    if k2 is not None:
        dargs, dkw = k2
        _require(torch.equal(dargs[1], ids) and torch.equal(dargs[2], cnt),
                 f"{name} (K4): K2 is not given the same lists")
        turns = [_median_ms(lambda: T.walk_wq(*args, **kw)),
                 _median_ms(lambda: T.walk(*dargs, **dkw)),
                 _median_ms(lambda: T.walk(*dargs, **dkw)),
                 _median_ms(lambda: T.walk_wq(*args, **kw))]
        row["k2_ms"] = turns[1:3]
        print(f"[kernels] {name} (K4) beside K2 on the same lists, in turns "
              f"K4, K2, K2, K4: {turns} ms")
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
    # At a tile outside RAY_TILES each launch tile walks its tile's list.
    k = 1 if camera else T._split_tile(kw.get("ray_tile"))[1]
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
          f"visits made {min(made)}-{max(made)} of {k * int(cnt.sum())} "
          f"listed")


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
    # Its lists as `_groups_walk_args` builds them (one launch of
    # lists.cu: the extents, the slab test, the sort), and K6 alone at
    # this shape, the shape of its launches in the 1.6M frame's queries.
    ext = _lists_row(rows, "lists", (rp, acc16.cluster_min, acc16.cluster_max,
                                     None, T.RAY_TILE),
                     f"{rp.shape[1]} rays, {acc16.num_clusters} boxes, "
                     f"the primary chunk's lists")
    _require(torch.equal(ext[2], args[1]) and torch.equal(ext[4], args[2]),
             "lists: not the lists the primary walk was given")
    plo, phi = _extents_row(rows, "extents", rp)
    _steady_extents(rows, "extents", rp, plo, phi)
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
    # K6 and the list build from a pack at the wavefront's shape: what a
    # gi_wq=False frame's bounce queries take (at a composed tile, K6 at
    # the launch tile; at 1,024 the list build).
    plo, phi = _extents_row(rows, "extents_gi_wq_false", bp)
    _steady_extents(rows, "extents_gi_wq_false", bp, plo, phi)
    c128 = acc128.num_clusters
    _lists_row(rows, "lists_gi_wq_false", (bp, acc128.cluster_min,
                                           acc128.cluster_max, None,
                                           T.RAY_TILE),
               f"{bp.shape[1]} rays, {c128} boxes, the gi_wq=False bounce "
               f"lists")
    tile_alive = phi[:, 7] > 0.0
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
    # The bounce level's lists from that query, as `_refined_lists` builds
    # them: its extents, its entered bits ANDed into the flags.
    flo, fhi, fent = T.refine_dense_extents(*rargs)
    _lists_ext_row(rows, "lists_ext", (flo[:, 0:3], fhi[:, 0:3], flo[:, 4:7],
                                       fhi[:, 4:7], *rargs[1:]),
                   dict(mask=fent), f"{bp.shape[1]} rays, {c128} boxes, the "
                   f"dense refined lists")
    balive = bp[7] != 0
    early = True if cfg.gi_early_exit else None  # as render_rays asks
    dargs, dkw = T._dma_walk_args(acc128, bp, eps, True, INF, na,
                                  early_exit=early)
    _timed_walk(rows, "walk_dma", "walk_dma (K2) bounce nearest+attrs", T,
                dargs, dkw, balive, OPS_PMT,
                f"{bp.shape[1]} rays, {c128}x128")
    # The rest set's merge into that walk's results (the ground plane's
    # triangles against every wavefront ray), as `nearest_hit_attrs_soa`
    # runs it after the walk.
    _rest_row(rows, "rest_merge",
              lambda t, s, a, p: T._merge_rest_nearest(acc128, p, t, s, a,
                                                       eps, na),
              tuple(T.walk(*dargs, **dkw)) + (bp,),
              acc128.rest_blocks.shape[0], bp.shape[1] * 28,
              f"{bp.shape[1]} rays, the K2 bounce walk's results, attrs "
              f"shade (A = {na})")
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
    lights = sphere_light(dev)
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
    k4 = _wq_row(rows, "walk_wq", "walk_wq (K4) bounce nearest+attrs", T,
                 wargs, wkw, balive, OPS_PMT,
                 f"{bp.shape[1]} rays, {c128}x128, {wkw['u']} visits per "
                 f"work item", k2=(dargs, dkw))
    _compare_walk("walk_wq (K4) vs walk_dma (K2), nearest+attrs", k4,
                  T.walk(*dargs, **dkw), balive, True)
    noexit = dict(dkw, tnear=None, bbox=None)
    print(f"[kernels] walk_dma (K2) on the same lists: "
          f"{_median_ms(lambda: T.walk(*dargs, **dkw)):.4f} ms with its "
          f"early exit, {_median_ms(lambda: T.walk(*dargs, **noexit)):.4f} "
          f"ms without")
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
    a4, k4kw = T._wq_walk_args(acc128, bp, eps, True, 1.2873, na)
    _compare_walk("walk_wq (K4) capped, vs plain", T.walk_wq(*a4, **k4kw),
                  T.walk_wq_plain(*a4, **k4kw), balive, True)
    # A tile with no visits reads miss / not occluded.
    bp0 = bp.clone()
    bp0[7, -T.RAY_TILE:] = 0.0
    dead = slice(bp0.shape[1] - T.RAY_TILE, bp0.shape[1])
    z4, zkw = T._wq_walk_args(acc128, bp0, eps, True, INF, na)
    _require(int(z4[2][-1]) == 0, "walk_wq (K4): the dead tile lists visits")
    zt, zs, za = T.walk_wq(*z4, **zkw)
    o4, okw = T._wq_walk_args(acc128, bp0, eps, False, INF, 0)
    zo = T.walk_wq(*o4, **okw)
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
    and the shading planes. Phase 8 times the launches of the kernel
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
                        repeats=False, lists_rows=None):
    """Camera mode over the whole 800x800x4 frame on `acc`, with the lists
    and tables `nearest_hit_camera_soa` launches: its lists
    (`camera_lists`; timed into rows[lists_rows...] if given,
    `_camera_lists_row`) bit-equal to their plain composition on the card;
    above _SUPERTILE_MIN_C clusters, where they go through supertiles, the
    direct lists of every tile bit-equal to theirs too and the pooled lists
    against the direct ones as sets; the kernel against its plain version
    lane by lane (timed into rows[row]), with `repeats` ten launches equal,
    and the public query against the pack path under shared_origin=0 on
    all 2,560,000 rays."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T

    cam, offs, rp, eps = camera
    dev = offs.device
    cs, c = acc.cluster_size, acc.num_clusters
    n_tiles = cam.grid[0] * cam.grid[1]
    na = acc.attr_blocks.shape[1] if with_attrs else 0
    made = []
    (largs, _), = _capture_calls(
        "camera_lists", [0], lambda: made.append(T._camera_walk_args(
            acc, offs, cam, 0, n_tiles, na, eps)))
    (args, kw), = made
    _require(kw["entry"] == entry, f"{row}: CS {cs} took entry {kw['entry']}")
    ids, cnt = args[4:6]
    pooled = T._pooled(acc, cam, 0, n_tiles)
    what = (f"{row}: {'the pooled' if pooled else 'the direct'} lists, "
            f"{n_tiles} blocks x {c} boxes")
    if lists_rows is not None:
        _camera_lists_row(rows, lists_rows, largs, what)
    else:
        with _PlainWrappers():
            want = T.camera_lists(*largs)
        _bit_equal(what, T.camera_lists(*largs), want)
        print(f"[kernels] {what}: equal bit for bit")
        del want
    if pooled:
        min_c, T._SUPERTILE_MIN_C = T._SUPERTILE_MIN_C, c
        try:
            d_ids, d_tn, d_cnt = T.camera_lists(*largs)
            with _PlainWrappers():
                want = T.camera_lists(*largs)
        finally:
            T._SUPERTILE_MIN_C = min_c
        _bit_equal(f"{row}: the direct lists", (d_ids, d_tn, d_cnt), want)
        print(f"[kernels] {row}: the direct lists ({n_tiles} tiles x {c} "
              f"boxes, {int(d_cnt.sum())} listed) equal bit for bit")
        del want, d_tn
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
    attributes, through both entries (`_check_camera_frame`; the CS 16
    query's lists are row lists_camera); then the rest set's merge into
    the CS 16 walk's results (row rest_merge_camera). Returns the lists'
    launches of one CS 16 camera query over the whole frame."""
    from raytracing_tpu_torch import build_cluster_accel, build_default_scene

    from raytracing_tpu_torch.kernels import traverse as T

    dev = "cuda"
    scene = build_default_scene(device=dev)
    camera = _reference_camera(dev)
    accs = {}
    for row, entry, cs, lists_rows in (
            ("walk_camera", "walk_camera", 16, ("lists_camera",)),
            ("walk_camera_dma_100", "walk_camera_dma", 128, None)):
        accs[cs] = build_cluster_accel(scene.mesh, cluster_size=cs)
        _check_camera_frame(rows, row, entry, accs[cs], camera, True,
                            lists_rows=lists_rows)
    # The rest set's merge into the whole frame's camera walk, as the
    # primary query (`nearest_hit_camera_soa`, no attributes) runs it.
    cam, offs, _, eps = camera
    acc = accs[16]
    nt = cam.grid[0] * cam.grid[1]
    args, kw = T._camera_walk_args(acc, offs, cam, 0, nt, 0, eps)
    t, s, _ = T.walk_camera(*args, **kw)
    _rest_row(rows, "rest_merge_camera",
              lambda t, s, a: T._merge_rest_camera(acc, offs, cam, 0, t, s,
                                                   a, eps, 0),
              (t, s, None), acc.rest_blocks.shape[0], t.numel() * 4,
              f"{nt} tiles x {cam.ray_tile} camera rays, the K1 camera "
              f"walk's results, no attributes")
    return _query_launches(lambda: T.nearest_hit_camera_soa(
        acc, offs, width=cam.width, height=cam.height, spp=cam.spp,
        scale=cam.scale, eps=eps), "lists_camera")


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
    alive = _tile_alive_lanes(bp, bp.shape[1] // ids.shape[0])
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
    pack = rp.reshape(8, -1, 1, kw.get("ray_tile", T.RAY_TILE))
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
    The capped rows' launches are those of one reference frame with
    gi_cap_frac 0.1, the lane-cull row's those of one gi_wq=False frame.
    Returns the rows' launches."""
    import torch

    from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                      build_default_scene)
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
    _wq_row(rows, "walk_wq_mt", "walk_wq (K4) bounce nearest+attrs, mt", T,
            wargs, wkw, balive, OPS_MT, f"{wave}, mt, {wkw['u']} visits per "
            f"work item", k2=(args, kw))
    bargs, bkw = T._wq_walk_args(acc128, bp, eps, True, INF, na)
    rows["walk_wq_mt"]["pmt_ms"] = _median_ms(lambda: T.walk_wq(*bargs,
                                                                **bkw))
    print(f"[variants] walk_wq_mt: {rows['walk_wq_mt']['ms']:.4f} ms beside "
          f"pmt's {rows['walk_wq_mt']['pmt_ms']:.4f} ms ({wave})")
    del bargs, bkw
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

    # The frames that launch the capped walks and the lane-cull walk.
    capped = counted_frame(scene, cfg.replace(gi_cap_frac=CAP_FRAC), acc16)
    culled = counted_frame(scene, cfg.replace(gi_wq=False), acc16)
    for tag, fl in (("gi_cap_frac 0.1", capped), ("gi_wq False", culled)):
        print(f"[variants] reference frame, {tag}: launches "
              f"{ {k: v for k, v in fl.items() if v} }")
    launches["walk_dma_capped"] = capped.get("walk_dma_capped", 0)
    launches["refine_extents_capped"] = capped.get("refine_extents_capped",
                                                   0)
    launches["walk_lc"] = culled.get("walk_lc", 0)
    return launches


def _steady_extents_entry(bp, ray_tile):
    """K6's entry at `ray_tile` read steadily as `_steady_extents` reads
    it: STEADY_LAUNCHES direct calls in one pair of CUDA events, over
    L2_COPIES copies of the pack in turns (ms per launch)."""
    import itertools

    import torch

    from raytracing_tpu_torch.kernels import cuda

    nt = bp.shape[1] // ray_tile
    lib = cuda.library()
    stream = torch.cuda.current_stream().cuda_stream
    packs = [bp] + [bp.clone() for _ in range(L2_COPIES - 1)]
    outs = [torch.empty((2, nt, 8), device="cuda") for _ in packs]
    calls = itertools.cycle([(p.data_ptr(), p.shape[1], ray_tile,
                              o[0].data_ptr(), o[1].data_ptr(), stream)
                             for p, o in zip(packs, outs)])
    return _steady_ms(lambda: lib.rt_tile_extents(*next(calls)))


def _tile_sweep(bp, acc128, eps, na, early):
    """The depth-2 wavefront's kernels at every accepted tile, in turns
    (1,024 first and last): K6 (its entry, steady), K5 dense + K6 (steady,
    200 wrapper calls), K2 (`_walk_dma`, median of 5, with the visits it
    made and the lists' length) and K1 with the lane cull (a gi_wq=False
    frame's bounce walk; median of 5, visits staged). Prints each reading
    and returns {tile: {metric: value}}."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.ops.intersect import INF

    cmin, cmax = acc128.cluster_min, acc128.cluster_max
    tiles = T.RAY_TILES[::-1]
    out = {t: {} for t in tiles}
    walks = {}
    for t in tiles:
        walks[t] = {
            "k2": T._dma_walk_args(acc128, bp, eps, True, INF, na,
                                   early_exit=early, ray_tile=t),
            "k1_lc": T._groups_walk_args(acc128, bp, eps, True, INF, na,
                                         early_exit=early, lane_cull=True,
                                         ray_tile=t)}
    for rnd, order in enumerate((tiles, tiles[::-1])):
        for t in order:
            o = out[t]
            o.setdefault("k6_ms", []).append(_steady_extents_entry(bp, t))
            o.setdefault("k5k6_ms", []).append(_steady_ms(
                lambda: T.refine_dense_extents(bp, cmin, cmax, ray_tile=t)))
            for name, (args, kw) in walks[t].items():
                o.setdefault(f"{name}_ms", []).append(
                    _median_ms(lambda: T.walk(*args, **kw)))
                if rnd == 0:
                    visits = torch.zeros(args[2].shape, dtype=torch.int32,
                                         device="cuda")
                    T.walk(*args, **kw, visits=visits)
                    o[f"{name}_visits"] = int(visits.sum())
                    o[f"{name}_listed"] = int(args[2].sum())
                    o[f"{name}_tiles"] = int(args[2].numel())
    for t in tiles:
        o = out[t]
        print(f"[ray_tile] wavefront {bp.shape[1]} rays, 100x128, tile {t} "
              f"({bp.shape[1] // t} tiles): K6 entry {o['k6_ms']} ms; "
              f"K5 dense + K6 {o['k5k6_ms']} ms; K2 {o['k2_ms']} ms, "
              f"{o['k2_visits']} of {o['k2_listed']} listed visits; K1 "
              f"lane cull {o['k1_lc_ms']} ms, {o['k1_lc_visits']} of "
              f"{o['k1_lc_listed']} listed visits staged")
    return out


def _composed_rows(rows, tile, bp, acc128, eps, na, early):
    """3j at a tile outside RAY_TILES on 3a's wavefront (padded to whole
    tiles of it): K6, K5 dense + K6, K2 (ten launches equal), K1 with the
    lane cull and K4 (beside K2 on the same lists) through their wrappers,
    which launch at s and fold, each against its plain version at the
    tile, timed into rows "<entry>_rt<tile>" with the launch at s alone
    beside (`_launch_row`); K5 dense with flags given equal too."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.ops.intersect import INF

    s, k = T._split_tile(tile)
    bp, _ = T._pad_rays_soa(bp, tile)
    balive = bp[7] != 0
    rargs = (bp, acc128.cluster_min, acc128.cluster_max)
    wave = (f"{bp.shape[1]} rays, {acc128.num_clusters}x128, tiles of "
            f"{tile} ({k} x {s})")
    name = f"extents_rt{tile}"
    _, phi = _extents_row(rows, name, bp, tile)
    _launch_row(rows[name], name, lambda: T.tile_extents(bp, s), s, k)
    name = f"refine_extents_rt{tile}"
    _refine_extents_row(rows, name, rargs,
                        f"{wave}, the extents and the bits", tile)
    _launch_row(rows[name], name,
                lambda: T.refine_dense_extents(*rargs, ray_tile=s), s, k)
    flags = phi[:, 7] > 0.0
    _require(torch.equal(T.refine_dense(*rargs, flags, ray_tile=tile),
                         T.refine_dense_plain(*rargs, flags, ray_tile=tile)),
             f"refine (K5 dense, flags given) at {tile}: bits differ")
    dargs, dkw = T._dma_walk_args(acc128, bp, eps, True, INF, na,
                                  early_exit=early, ray_tile=tile)
    tag = f"walk_dma (K2) bounce nearest+attrs at {tile}"
    _timed_walk(rows, f"walk_dma_rt{tile}", tag, T, dargs, dkw, balive,
                OPS_PMT, wave, plain_reps=1)
    _check_repeats(tag, T.walk, dargs, dkw, balive)
    largs, lkw = T._groups_walk_args(acc128, bp, eps, True, INF, na,
                                     early_exit=early, lane_cull=True,
                                     ray_tile=tile)
    _timed_walk(rows, f"walk_lc_rt{tile}", f"walk (K1) bounce nearest+attrs "
                f"at {tile}, lane cull", T, largs, lkw, balive, OPS_PMT,
                f"{wave}, lane cull", plain_reps=1,
                bound_visits=_lane_cull_visits(*_launch_args("walk", largs,
                                                             lkw)))
    wargs, wkw = T._wq_walk_args(acc128, bp, eps, True, INF, na,
                                 ray_tile=tile)
    k4 = _wq_row(rows, f"walk_wq_rt{tile}", f"walk_wq (K4) bounce "
                 f"nearest+attrs at {tile}", T, wargs, wkw, balive, OPS_PMT,
                 f"{wave}, {wkw['u']} visits per work item", k2=(dargs, dkw))
    _compare_walk(f"walk_wq (K4) vs walk_dma (K2) at {tile}", k4,
                  T.walk(*dargs, **dkw), balive, True)


def _composed_launches(launches, tile, frame_launches):
    """Into launches["<entry>_rt<tile>"], for each entry of COMPOSED, the
    count of a frame at gi_ray_tile `tile` under the key of its launch
    tile (`_count_key`: at 2,048 the bare entry, which counts the frame's
    launches at 1,024 of the primary level too)."""
    from raytracing_tpu_torch.kernels import traverse as T

    s, _ = T._split_tile(tile)
    for e in COMPOSED:
        key = (T._count_key("walk", lane_cull=True, ray_tile=s)
               if e == "walk_lc" else T._count_key(e, ray_tile=s))
        name = f"{e}_rt{tile}"
        launches[name] = max(launches.get(name, 0),
                             frame_launches.get(key, 0))


def phase_ray_tile(rows, card, scene404, acc64_404k, acc128_404k):
    """3j. The bounce levels' culling tile (`RenderConfig.gi_ray_tile`,
    `ray_tile=` of every pack kernel): every kernel at a tile of 256
    against its plain version at 256, bit for bit on alive lanes, timed
    (rows "<kernel>_rt256"): K6, K5 dense + K6, K2, K1 with and without
    the lane cull and K4 on 3a's 720,896-ray wavefront (CS 128), K2 ten
    launches equal under its racing exit; K5 gathered on the 404k
    wavefront (3,160 clusters, 3c's shape) and K3 on the 1.6M Whitted
    frame's chunk-12 primaries and sun shadows (12,640 x 128 in 4
    groups, 3e's shape). At the tiles outside RAY_TILES (COMPOSED_TILES,
    `_composed_rows`): K6, K5 dense + K6, K2, K1 with the lane cull and K4
    on the wavefront and K5 gathered on the 404k one, each wrapper
    (launches at s, folded) against its plain version at the tile. Then
    the wavefront's kernels at every tile of RAY_TILES in turns
    (`_tile_sweep`), and the frames whose launches the rows count, each
    counted once: the reference frame at gi_ray_tile 256, 384 and 2,048
    (at the composed tiles under the keys of their launch tiles),
    gi_wq=False (K1 with the lane cull, K6) at 1,024, 256, 384 and 2,048,
    gi_wq=False without the lane cull (K1) at 256, `_WQ_IMPL = "grid"`
    with no coarse bounce accel (K4 over K5 gathered's lists: 790
    clusters) at 256, 128, 384 and 2,048, and gi_wq=False with no coarse
    bounce accel and the group budget patched (K3 in 4 groups) at 256.
    Returns the rows' launches."""
    import torch

    from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                      build_default_scene)
    from raytracing_tpu_torch.accel import packets
    from raytracing_tpu_torch.geometry.scene import (subdivided_teapot_mesh,
                                                     sun_position)
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.models import whitted
    from raytracing_tpu_torch.models.camera import (block_ray_ids,
                                                    camera_rays_for_ids)
    from raytracing_tpu_torch.ops.intersect import INF
    from raytracing_tpu_torch.ops.linalg import dot, normalize

    dev = "cuda"
    t = GI_TILE
    cfg = RenderConfig()
    scene = build_default_scene(device=dev)
    acc16 = build_cluster_accel(scene.mesh, cluster_size=16)
    acc128 = build_cluster_accel(scene.mesh, cluster_size=128)
    eps, na = cfg.eps, acc16.attr_blocks.shape[1]
    early = True if cfg.gi_early_exit else None
    o, d = camera_rays_for_ids(
        block_ray_ids(KERNEL_CHUNK, cfg.chunk_size, cfg, device=dev), cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    ob, db, ab = whitted.bounce_wavefront(
        scene.mesh, acc16, scene.sun, o, d, cfg,
        lambda depth, shape: torch.rand(shape, generator=gen, device=dev))
    bp, _ = T._pad_rays_soa(T.rays_to_soa(ob, db, alive=ab))
    balive = bp[7] != 0
    c128 = acc128.num_clusters
    wave = f"{bp.shape[1]} rays, {c128}x128, tiles of {t}"
    _extents_row(rows, f"extents_rt{t}", bp, t)
    rargs = (bp, acc128.cluster_min, acc128.cluster_max)
    _refine_extents_row(rows, f"refine_extents_rt{t}", rargs,
                        f"{wave}, the extents and the bits", t)
    _, phi = T.tile_extents_plain(bp, t)
    flags = phi[:, 7] > 0.0
    _require(torch.equal(T.refine_dense(*rargs, flags, ray_tile=t),
                         T.refine_dense_plain(*rargs, flags, ray_tile=t)),
             f"refine (K5 dense, flags given) at {t}: bits differ")
    dargs, dkw = T._dma_walk_args(acc128, bp, eps, True, INF, na,
                                  early_exit=early, ray_tile=t)
    _timed_walk(rows, f"walk_dma_rt{t}", f"walk_dma (K2) bounce "
                f"nearest+attrs at {t}", T, dargs, dkw, balive, OPS_PMT,
                wave, plain_reps=1)
    _check_repeats(f"walk_dma (K2) bounce nearest+attrs at {t}", T.walk,
                   dargs, dkw, balive)
    oargs, okw = T._dma_walk_args(acc128, bp, eps, False, INF, 0,
                                  ray_tile=t)
    _compare_walk(f"walk_dma (K2) bounce occlusion at {t}",
                  T.walk(*oargs, **okw), T.walk_plain(*oargs, ray_tile=t),
                  balive, False)
    for name, lc in ((f"walk_rt{t}", False), (f"walk_lc_rt{t}", True)):
        largs, lkw = T._groups_walk_args(acc128, bp, eps, True, INF, na,
                                         early_exit=early, lane_cull=lc,
                                         ray_tile=t)
        _timed_walk(rows, name, f"walk (K1) bounce nearest+attrs at {t}"
                    f"{', lane cull' if lc else ''}", T, largs, lkw, balive,
                    OPS_PMT, f"{wave}{', lane cull' if lc else ''}",
                    plain_reps=1,
                    bound_visits=_lane_cull_visits(largs, lkw) if lc
                    else None)
    largs, lkw = T._groups_walk_args(acc128, bp, eps, False, INF, 0,
                                     lane_cull=True, ray_tile=t)
    _compare_walk(f"walk (K1) bounce occlusion at {t}, lane cull",
                  T.walk(*largs, **lkw),
                  T.walk_plain(*largs, ray_tile=t,
                               lane_bounds=lkw["lane_bounds"]),
                  balive, False)
    wargs, wkw = T._wq_walk_args(acc128, bp, eps, True, INF, na, ray_tile=t)
    k4 = _wq_row(rows, f"walk_wq_rt{t}", f"walk_wq (K4) bounce "
                 f"nearest+attrs at {t}", T, wargs, wkw, balive, OPS_PMT,
                 f"{wave}, {wkw['u']} visits per work item", k2=(dargs, dkw))
    _compare_walk(f"walk_wq (K4) vs walk_dma (K2) at {t}", k4,
                  T.walk(*dargs, **dkw), balive, True)
    # K4 at the finest tile: the per-warp cull has nothing left to skip
    # that the tile's own lists do not.
    a128, k128 = T._wq_walk_args(acc128, bp, eps, True, INF, na,
                                 ray_tile=128)
    d128 = T._dma_walk_args(acc128, bp, eps, True, INF, na,
                            early_exit=early, ray_tile=128)
    _wq_row(rows, "walk_wq_rt128", "walk_wq (K4) bounce nearest+attrs at 128",
            T, a128, k128, balive, OPS_PMT,
            f"{bp.shape[1]} rays, {c128}x128, tiles of 128, {k128['u']} "
            f"visits per work item", k2=d128)
    a128o, k128o = T._wq_walk_args(acc128, bp, eps, False, 30.0, 0,
                                   ray_tile=128)
    _compare_walk("walk_wq (K4) bounce occlusion at 128",
                  T.walk_wq(*a128o, **k128o), T.walk_wq_plain(*a128o, **k128o),
                  balive, False)
    del a128, k128, d128, a128o, k128o
    # Against the default tile: the same winners, lane by lane.
    a1024, k1024 = T._dma_walk_args(acc128, bp, eps, True, INF, na,
                                    early_exit=early)
    _compare_walk(f"walk_dma (K2) at {t} vs at {T.RAY_TILE}",
                  T.walk(*dargs, **dkw), T.walk(*a1024, **k1024), balive,
                  True)
    del a1024, k1024, k4
    for tile in COMPOSED_TILES:
        _composed_rows(rows, tile, bp, acc128, eps, na, early)

    # K5 gathered on the 404k wavefront (3c's shape).
    bp404, nb404, alive404 = _wavefront_404k(scene404, acc64_404k)
    ids, _, cnt = T._narrow_lists(*T._tile_visit_lists_soa(
        bp404, acc128_404k.cluster_min, acc128_404k.cluster_max,
        ray_tile=t))
    _timed_refine_lists(rows, f"refine_lists_rt{t}",
                        (bp404, ids, cnt, acc128_404k.cluster_min,
                         acc128_404k.cluster_max, None, t),
                        f"the 404k wavefront ({alive404} of {nb404} rays "
                        f"alive), tiles of {t}")
    for tile in COMPOSED_TILES:
        s, k = T._split_tile(tile)
        bpc, _ = T._pad_rays_soa(bp404, tile)
        ids, _, cnt = T._narrow_lists(*T._tile_visit_lists_soa(
            bpc, acc128_404k.cluster_min, acc128_404k.cluster_max,
            ray_tile=tile))
        boxes = (acc128_404k.cluster_min, acc128_404k.cluster_max)
        name = f"refine_lists_rt{tile}"
        _timed_refine_lists(rows, name, (bpc, ids, cnt) + boxes + (None, tile),
                            f"the 404k wavefront ({alive404} of {nb404} rays "
                            f"alive), tiles of {tile} ({k} x {s})")
        sids, scnt = T._per_subtile(ids, k), T._per_subtile(cnt, k)
        _launch_row(rows[name], name, lambda: T.refine_lists(
            bpc, sids, scnt, *boxes, None, s), s, k)
    del bp404, bpc, ids, cnt, sids, scnt

    # K3 on the 1.6M frame's chunk-12 primaries and their sun shadows.
    mesh = subdivided_teapot_mesh(levels=4, device=dev)
    acc = build_cluster_accel(mesh, cluster_size=128, variants=("pmt",))
    o12, d12 = camera_rays_for_ids(
        block_ray_ids(LARGE_KERNEL_CHUNK, cfg.chunk_size, cfg, device=dev),
        cfg)
    rp = T.rays_to_soa(o12, d12)
    gargs, gkw = T._gstream_walk_args(acc, rp, eps, True, INF,
                                      acc.attr_blocks.shape[1], ray_tile=t)
    _require(gargs[1].shape[0] == 4, "K3 at 1.6M: not 4 groups")
    gt, gs, ga = _timed_walk(
        rows, f"walk_gstream_rt{t}", f"walk_gstream (K3) 1.6M chunk "
        f"primaries at {t}", T, gargs, gkw, rp[7] != 0, OPS_PMT,
        f"{rp.shape[1]} rays, {acc.num_clusters}x128 in 4 groups, tiles of "
        f"{t}", kernel="walk_gstream", plain_reps=1)
    _check_repeats(f"walk_gstream (K3) 1.6M chunk primaries at {t}",
                   T.walk_gstream, gargs, gkw, rp[7] != 0)
    hit = torch.isfinite(gt[0])
    pos = o12 + torch.where(hit, gt[0], 1.0)[:, None] * d12 \
        + ga[0:3].T * cfg.normal_offset
    sun_dir = normalize(sun_position(0.0).to(dev) - pos, eps=1e-20)
    sh = T.rays_to_soa(pos, sun_dir, alive=hit & (dot(ga[0:3].T, sun_dir)
                                                  > 0.0))
    sargs, skw = T._gstream_walk_args(acc, sh, eps, False, INF, 0,
                                      ray_tile=t)
    _compare_walk(f"walk_gstream (K3) 1.6M chunk sun shadows at {t}",
                  T.walk_gstream(*sargs, **skw),
                  T.walk_gstream_plain(*sargs, ray_tile=t), sh[7] != 0,
                  False)
    del mesh, acc, gargs, gkw, sargs, skw, gt, gs, ga

    sweep = _tile_sweep(bp, acc128, eps, na, early)
    del bp

    # Frames: the reference frame at 256 and at the composed tiles, and the
    # frames that run the other kernels at those tiles, each counted once.
    frames = {tile: counted_frame(scene, cfg.replace(gi_ray_tile=tile),
                                  acc16) for tile in (t,) + COMPOSED_TILES}
    for tile, fl in frames.items():
        print(f"[ray_tile] reference frame, gi_ray_tile {tile}: launches "
              f"{ {k: v for k, v in fl.items() if v} }")
    launches = {k: v for k, v in frames[t].items() if k.endswith(f"_rt{t}")}
    for tile in COMPOSED_TILES:
        _composed_launches(launches, tile, frames[tile])
    budget, impl = packets._GROUP_BLOCK_BUDGET_BYTES, T._WQ_IMPL
    cases = (("gi_wq False", dict(gi_wq=False), {},
              (1024, t) + COMPOSED_TILES),
             ("gi_wq False, no lane cull",
              dict(gi_wq=False, gi_lane_cull=False), {}, (t,)),
             ("grid, no coarse bounce accel", dict(gi_cluster_size=0),
              dict(impl="grid"), (t, 128) + COMPOSED_TILES),
             ("gi_wq False, no coarse bounce accel, budget patched",
              dict(gi_wq=False, gi_cluster_size=0), dict(budget=1), (t,)))
    try:
        for tag, change, patch, tiles in cases:
            T._WQ_IMPL = patch.get("impl", impl)
            packets._GROUP_BLOCK_BUDGET_BYTES = patch.get("budget", budget)
            counted = {}
            for tile in tiles:
                fl = counted[tile] = counted_frame(
                    scene, cfg.replace(gi_ray_tile=tile, **change), acc16)
                print(f"[ray_tile] reference frame, {tag}, gi_ray_tile "
                      f"{tile}: launches "
                      f"{ {k: v for k, v in fl.items() if v} }")
                if tile in COMPOSED_TILES:
                    _composed_launches(launches, tile, fl)
                elif tile != 1024:
                    for k, v in fl.items():
                        if k.endswith(f"_rt{tile}"):
                            launches[k] = max(launches.get(k, 0), v)
            if tag == "gi_wq False":
                # The list build at 1,024 and K6 alone at the composed
                # 2,048 (launch tiles of 1,024) on the bounce wavefronts.
                launches["lists_gi_wq_false"] = counted[1024]["lists"]
                launches["extents_gi_wq_false"] = counted[2048]["extents"]
    finally:
        T._WQ_IMPL = impl
        packets._GROUP_BLOCK_BUDGET_BYTES = budget
    print("[ray_tile] summary " + json.dumps({
        "card": card, "sweep": sweep,
        "frames": {tile: {k: v for k, v in fl.items() if v}
                   for tile, fl in frames.items()}}))
    return launches


def phase_reference_frame(rows):
    """4. The reference frame (800x800 at 4 spp, `RenderConfig()`): one
    counted frame with pack-path primaries, then one with camera-mode
    primaries, whose `walk_camera` launch of chunk KERNEL_CHUNK (64 tiles)
    is kept: timed at that shape (row "walk_camera_chunk") and its lists
    built from the camera (row `lists_camera_chunk`). Returns both frames'
    launches."""
    import torch

    from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                      build_default_scene)
    from raytracing_tpu_torch.kernels import traverse as T

    cfg = RenderConfig()
    scene = build_default_scene(device="cuda")
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    out = []
    for tag, c in (("reference frame", cfg),
                   ("reference frame, camera-mode primaries",
                    cfg.replace(primary_shared_origin=True))):
        frame = []
        chunk = _capture_calls(
            "walk_camera", [KERNEL_CHUNK] if c.primary_shared_origin else [],
            lambda: frame.append(counted_frame(scene, c, accel)))
        print(f"[frame] {tag}: launches {frame[0]}")
        out.append(frame[0])
    (cargs, ckw), = chunk
    _timed_camera(rows, "walk_camera_chunk", cargs, ckw,
                  f"the camera-mode frame's chunk {KERNEL_CHUNK}: "
                  f"{cargs[3]} tiles x {cargs[1].ray_tile} rays, "
                  f"{accel.num_clusters}x16, A = {cargs[8]}")
    # That launch's lists: its 64 blocks' closed-form frustums in the list
    # build (one launch, as `_camera_walk_args`).
    offs, cam, tile0, n_tiles = cargs[:4]
    got = _camera_lists_row(
        rows, ("lists_camera_chunk",), (accel, offs, cam, tile0, n_tiles),
        f"the camera-mode frame's chunk {KERNEL_CHUNK}: {n_tiles} blocks, "
        f"{accel.num_clusters} boxes")
    _require(torch.equal(got[0], cargs[4]) and torch.equal(got[2], cargs[5]),
             "lists_camera_chunk: not the lists the camera walk was given")
    return out


def phase_large_scenes(rows, scene404, acc64, gi128, built404):
    """The camera-mode query at 404k (CS 64), 1.6M and 6.4M (CS 128)
    triangles against its plain version and the pack path at that very
    shape (`_check_camera_frame`; the 1.6M launch is the `walk_camera_dma`
    row), one counted camera-mode query each at 1.6M and 6.4M, one Whitted
    frame of the 1.6M scene (its
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
    from raytracing_tpu_torch.ops.sampling import stratified_offsets

    print(f"[large] 404k: mesh_gen {built404['mesh_s']} s, accel_build "
          f"{built404['accel_s']} s")
    camera = _reference_camera("cuda")
    _check_camera_frame(rows, "walk_camera_404k", "walk_camera", acc64,
                        camera, False)

    query_launches = gstream_launches = frame_launches = None
    for levels, tag in ((4, "1m6"), (5, "6m4")):
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
                            acc, camera, False, repeats=levels == 4,
                            lists_rows=("lists_camera_pooled",
                                        "lists_camera_members")
                            if levels == 4 else None)
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
            frame, refines, glists = [], [], []
            chunk = _capture_calls("walk_gstream", [k, k + 1], lambda:
                                   refines.extend(_capture_calls(
                                       "refine_lists", None, lambda:
                                       glists.extend(_capture_calls(
                                           "lists_from_extents", [k],
                                           lambda: frame.append(
                                               counted_frame(
                                                   Scene(mesh=mesh,
                                                         sun=sun_position(
                                                             0.0).to("cuda")),
                                                   RenderConfig(), acc)))))))
            frame = frame[0]
            # The primary query's group lists of that chunk (K3's lists:
            # one launch over the groups, a dead tile listing nothing).
            (gargs, gkw), = glists
            got = _lists_ext_row(
                rows, "lists_ext_gstream", gargs, gkw,
                f"the 1.6M frame's chunk {LARGE_KERNEL_CHUNK}: "
                f"{gargs[0].shape[0]} tiles, {gkw['groups']} groups of "
                f"{gargs[4].shape[0] // gkw['groups']} boxes")
            _require(torch.equal(got[0], chunk[0][0][1])
                     and torch.equal(got[2], chunk[0][0][2]),
                     "lists_ext_gstream: not the lists of the chunk's K3 "
                     "launch")
            del glists, gargs, gkw, got
            # One object and no rest set: the merge never launches.
            _require(frame["walk_gstream"] > 0 and frame["walk"] == 0
                     and frame["refine_lists"] > 0
                     and frame["rest_merge"] == 0,
                     f"the 1.6M Whitted frame's launches: {frame}")
            print(f"[frame] 1.6M Whitted frame: launches {frame}")
            frame_launches = frame
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
        # One camera-mode query over the whole frame, counted.
        torch.cuda.reset_peak_memory_stats()
        T.reset_launches()
        T.nearest_hit_camera_soa(acc, stratified_offsets(4, device="cuda"),
                                 width=800, height=800, spp=4)
        torch.cuda.synchronize()
        print(f"[large {tag}] camera query 800x800x4: launches "
              f"{ {k: v for k, v in T.LAUNCHES.items() if v} }, peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2 ** 30} GiB")
        query_launches = query_launches or dict(T.LAUNCHES)
        del acc, mesh

    launches = counted_frame(scene404, RenderConfig(), acc64,
                             gi_accel=gi128)
    for k in ("refine_lists", "walk_dma", "walk", "lists"):
        _require(launches[k] > 0,
                 f"kernel {k} was not launched by the 404k Whitted frame")
    print(f"[frame] 404k Whitted frame: launches {launches}")
    return query_launches, launches, gstream_launches, frame_launches


def _check_gstream(rows, acc, camera):
    """3e. K3 at the 1.6M-triangle scene on all 2,560,000 pack-path rays
    (the origin folded, as phase 5's pack-path query walks them): the
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


def phase_area_light_frame():
    """6. The reference frame with one spherical light and 4 shadow
    samples, counted twice from one seed: its bounce queries through K2
    (the `_walk_dma` entry, the default), then through K4 (`_WQ_IMPL =
    "grid"`). Returns the launches of both frames."""
    import torch

    from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                      build_default_scene)
    from raytracing_tpu_torch.geometry.mesh import Scene
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.models import whitted

    base = build_default_scene(device="cuda")
    scene = Scene(base.mesh, base.sun, sphere_light("cuda"))
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    cfg = RenderConfig(light_samples=4)
    impl, launches = T._WQ_IMPL, {}
    try:
        for which in ("dma", "grid"):
            T._WQ_IMPL = which
            T.reset_launches()
            gen = torch.Generator(device="cuda")
            gen.manual_seed(5)
            whitted.render(scene, cfg, accel=accel, generator=gen)
            torch.cuda.synchronize()
            launches[which] = dict(T.LAUNCHES)
            print(f"[frame] area-light reference frame, _WQ_IMPL {which}: "
                  f"launches {launches[which]}")
    finally:
        T._WQ_IMPL = impl
    return launches["dma"], launches["grid"]


def _plain_launches(fn):
    """The device operations one call of fn makes, by the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def phase_light_glue(rows):
    """9b. The area lights' glue at the 1.6M frame's binned level: 720,896
    shaded points (positions row-major, normals, colours and albedo/pi as
    the kernel path's attribute planes, 80% hits) in a box around the
    light of 3d, one light sampled 4 times, each lane's draw by a
    permuted row. `light_sample` against `light_cone` +
    `light_shadow_rays`, and the fold of the light's last sample against
    the estimator's lines, every output bit for bit; each timed steadily
    (`_graph_ms` over copies of its inputs beyond the L2) beside its
    plain chain (median of 5 eager calls, and that chain's device
    operations) and its bound from its bytes and OPS_LIGHT_*."""
    import torch

    from raytracing_tpu_torch.kernels import light as LK
    from raytracing_tpu_torch.models import whitted

    dev = "cuda"
    n, ns = 720_896, 4
    gen = torch.Generator(device=dev).manual_seed(21)
    lights = sphere_light(dev)

    def inputs():
        lo = torch.tensor([-6.0, -3.0, 0.0], device=dev)
        span_ = torch.tensor([12.0, 12.0, 14.0], device=dev)
        pos = lo + torch.rand(n, 3, generator=gen, device=dev) * span_
        planes = torch.rand(7, n, generator=gen, device=dev)
        nrm = torch.randn(3, n, generator=gen, device=dev)
        planes[:3] = nrm / nrm.norm(dim=0, keepdim=True)
        return dict(
            pos=pos, n=planes[:3].T, color=planes[3:6].T, alb=planes[6],
            hit=torch.rand(n, generator=gen, device=dev) < 0.8,
            u=torch.rand(n, 2, generator=gen, device=dev),
            rows=torch.randperm(n, generator=gen, device=dev),
            occ=torch.rand(n, generator=gen, device=dev) < 0.3)

    x = inputs()
    per = sum(v.numel() * v.element_size() for v in x.values())
    copies = max(L2_COPIES, -(-2 * L2_BYTES // per))
    sets = [x] + [inputs() for _ in range(copies - 1)]

    def sample(k, plain=False):
        a = sets[k]
        if plain:
            return whitted.light_shadow_rays(
                whitted.light_cone(lights, 0, a["pos"]), a["pos"], a["n"],
                a["hit"], a["u"][a["rows"]])
        return LK.light_sample(a["pos"], a["n"], a["hit"], a["u"], a["rows"],
                               lights, 0)

    got = sample(0)
    err = _bit_equal("light_sample", got, sample(0, plain=True))
    alive = got[2]
    reads, writes = 41, 21
    ms = _graph_ms(sample, copies)
    plain_ms = _median_ms(lambda: sample(0, plain=True))
    chain = _plain_launches(lambda: sample(0, plain=True))
    bound = _bound(float(n) * OPS_LIGHT_SAMPLE, n * (reads + writes))
    rows["light_sample"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                plain_launches=chain, bound_ms=bound[0],
                                bound_by=bound[1],
                                shape=f"{n} rays, rows permuted")
    print(f"[glue] light_sample (light.cu): {n} rays, {int(alive.sum())} "
          f"alive, draws by permuted rows; equal bit for bit; steady "
          f"{ms:.5f} ms over {copies} copies in turns ({bound[0] / ms:.3f} "
          f"of its {bound[0]:.5f} ms bound by {bound[1]}: {reads} + {writes} "
          f"bytes a lane), plain {plain_ms:.4f} ms in {chain} device "
          f"operations")

    # The fold of the light's last sample (one light: the term is written
    # from acc, which it does not update, so every launch writes the same).
    outs = [sample(k) for k in range(copies)]
    accs = [torch.rand(n, generator=gen, device=dev) * 3 for _ in sets]
    totals = [torch.empty(n, 3, device=dev) for _ in sets]

    def fold(k, plain=False):
        a, (_, ndl, al, _) = sets[k], outs[k]
        if plain:
            vis = al & ~a["occ"]
            acc = accs[k] + torch.where(vis, torch.clamp_min(ndl, 0.0), 0.0)
            omega = whitted.light_cone(lights, 0, a["pos"]).omega
            total = torch.zeros_like(a["pos"]) + (
                (acc / ns * omega)[:, None] * lights.emission[0])
            return total * a["alb"][:, None] * a["color"]
        LK.light_fold(accs[k], totals[k], al, a["occ"], ndl, ns - 1, ns, 0,
                      lights, a["pos"], a["alb"], a["color"])
        return totals[k]

    want = fold(0, plain=True)
    err = _bit_equal("light_fold", [fold(0).clone()], [want])
    reads, writes = 38, 12
    ms = _graph_ms(fold, copies)
    plain_ms = _median_ms(lambda: fold(0, plain=True))
    chain = _plain_launches(lambda: fold(0, plain=True))
    bound = _bound(float(n) * OPS_LIGHT_FOLD, n * (reads + writes))
    rows["light_fold"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              plain_launches=chain, bound_ms=bound[0],
                              bound_by=bound[1],
                              shape=f"{n} rays, a light's last sample")
    print(f"[glue] light_fold (light.cu), a light's last sample: {n} rays; "
          f"equal bit for bit; steady {ms:.5f} ms over {copies} copies in "
          f"turns ({bound[0] / ms:.3f} of its {bound[0]:.5f} ms bound by "
          f"{bound[1]}: {reads} + {writes} bytes a lane), plain "
          f"{plain_ms:.4f} ms in {chain} device operations (the light's "
          f"cone included)")
    del sets, outs, accs, totals


def phase_scatter(rows):
    """8b. The backward's scatter-add (csrc/scatter.cu) at the fit cell's
    level-2 shape: 8,650,752 lanes (the three corners of 2,883,584 rays)
    of 3 floats into 37,926 triangle-corner rows, 8% of them in range
    (uniformly) and the rest at the drop bucket, as `grad.hit` read in the
    fit. `segment_scatter_add` on the card (the kernel, with its zeroed
    table) against the plain `index_add_` line (`index_add_rows`), its
    table within 1e-5 of the plain one's largest magnitude (atomics add in
    another order); both timed (median of 20; the inputs, 173 MB, exceed
    the L2), beside the bound of the bytes the kernel must move: every
    index, the live lanes' values and the table once; and the kernel's
    sorted form under deterministic algorithms, its sort included."""
    import torch

    from raytracing_tpu_torch.ops import scatter as S

    dev = "cuda"
    n, k, n_rows, share = 3 * 2_883_584, 3, 37_926, 0.08
    gen = torch.Generator(device=dev).manual_seed(25)
    vals = torch.randn(n, k, generator=gen, device=dev)
    idx = torch.randint(0, n_rows, (n,), generator=gen, device=dev)
    idx = torch.where(torch.rand(n, generator=gen, device=dev) < share, idx,
                      n_rows)
    live = int((idx < n_rows).sum())
    got = S.segment_scatter_add(n_rows, idx, vals)
    want = S.index_add_rows(n_rows, idx, vals)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    _require(err <= 1e-5 * scale, f"segment_scatter_add: {err} from the "
             f"plain line, above 1e-5 of its largest magnitude {scale}")
    ms = _median_ms(lambda: S.segment_scatter_add(n_rows, idx, vals),
                    reps=20)
    plain_ms = _median_ms(lambda: S.index_add_rows(n_rows, idx, vals),
                          reps=20)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        sorted_ms = _median_ms(
            lambda: S.segment_scatter_add(n_rows, idx, vals), reps=20)
    finally:
        torch.use_deterministic_algorithms(was)
    nbytes = n * idx.element_size() + live * k * 4 + n_rows * k * 4
    bound = _bound(float(live) * k, nbytes)
    rows["segment_scatter_add"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, sorted_ms=sorted_ms,
        bound_ms=bound[0], bound_by=bound[1],
        shape=f"{n} lanes x {k} into {n_rows} rows, {live} in range")
    print(f"[glue] segment_scatter_add (scatter.cu): {n} lanes x {k} into "
          f"{n_rows} rows, {live} in range ({live / n:.4f}), the rest at "
          f"the drop bucket; max abs err {err:.3g} of {scale:.3g}; "
          f"{ms:.5f} ms ({bound[0] / ms:.3f} of its {bound[0]:.5f} ms bound "
          f"by {bound[1]}: {nbytes} bytes), plain index_add_ {plain_ms:.4f} "
          f"ms, the sorted form {sorted_ms:.4f} ms")


def _backward_262k(scene, accel, keep, gi_accel=None):
    """One forward + backward of `bench_suite.py:80-130`'s backward cell:
    the 262,144 camera rays of blocks 90-105 (16,384 rays each) of the
    800x800x4 reference frame through `render_rays`, loss sum(rgb^2),
    gradients for verts, colors and materials, with the launch counts set
    to 0 just before and read just after. keep = (entry, picks): the `walk`
    launches of that entry, numbered from 0, to keep. Returns (its
    launches, the kept (args, kw))."""
    import torch

    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.models.camera import (block_ray_ids,
                                                    camera_rays_for_ids)
    from raytracing_tpu_torch.models.whitted import render_rays

    dev = scene.mesh.verts.device
    cfg = RenderConfig()
    ids = torch.cat([block_ray_ids(i, 16384, cfg, 16, 16, device=dev)
                     for i in range(90, 106)])
    o, d = camera_rays_for_ids(ids, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    live = {k: getattr(scene.mesh, k).clone().requires_grad_()
            for k in ("verts", "colors", "materials")}

    def run():
        rgb = render_rays(scene.mesh._replace(**live), accel, scene.sun, o, d,
                          cfg, lambda tag, shape: torch.rand(
                              shape, generator=gen, device=dev),
                          gi_accel=gi_accel)
        (rgb * rgb).sum().backward()

    torch.cuda.synchronize()
    T.reset_launches()
    kept = _capture_calls("walk", keep[1], run, entry=keep[0])
    torch.cuda.synchronize()
    launches = dict(T.LAUNCHES)
    print(f"[backward] {'CS 16' if gi_accel is None else 'CS 16 + CS 128'}"
          f": 262,144 rays, launches {launches}")
    return launches, kept


def _backward_rows(rows, calls):
    """The kernel rows of the differentiated walk: each kept launch of
    phase 8, as the renderer made it, against its plain version (t,
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
    """8. Gradients at full width, two configurations: the CS 16 accel
    alone (as bench_suite.py runs it) and with the reference frame's CS 128
    bounce accel (so K2 and K5 dense run under grad). The first's primary
    and first-bounce K1 launches and the second's first K2 launch become
    the rows walk_both, walk_both_bounce and walk_dma_both. Returns the
    launches of both."""
    from raytracing_tpu_torch import build_cluster_accel, build_default_scene

    scene = build_default_scene(device="cuda")
    acc16 = build_cluster_accel(scene.mesh, cluster_size=16)
    first, k1 = _backward_262k(scene, acc16, ("walk_both", [0, 1]))
    second, k2 = _backward_262k(
        scene, acc16, ("walk_dma_both", [0]),
        gi_accel=build_cluster_accel(scene.mesh, cluster_size=128))
    _backward_rows(rows, [
        ("walk_both", "K1, the CS 16 run's primaries", k1[0]),
        ("walk_both_bounce", "K1, the CS 16 run's first bounce", k1[1]),
        ("walk_dma_both", "K2, the CS 128 bounce accel's first bounce",
         k2[0])])
    return first, second


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


PATH_KERNELS = ("walk", "refine_dense_extents", "tile_lists")


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
    `refine_dense_extents` and `tile_lists`, from `_capture_path`): the
    busiest nearest launch (most listed visits) of the `walk` entry (K1,
    primaries) and of the `walk_dma` entry (K2, a bounce wavefront), the
    list build of that K1 launch, and the launch with the most alive
    lanes of K5+K6 and K6 alone on the list build's pack with the most
    alive lanes (read steadily): rows walk<suffix>, walk_dma<suffix>,
    refine_extents<suffix>, lists<suffix> and extents<suffix>. where: the
    path, for the printed lines."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T

    busiest = {}
    for entry, k in (("walk", 1), ("walk_dma", 2)):
        nearest = [(a, kw) for a, kw in calls["walk"]
                   if kw.get("entry") == entry and a[8] and a[5]]
        _require(nearest, f"{where}: no nearest {entry} launch")
        args, kw = busiest[entry] = max(nearest,
                                        key=lambda c: int(c[0][2].sum()))
        rp, pmto = args[0], args[10]
        _timed_walk(rows, entry + suffix, f"{entry} (K{k}) {where}, its "
                    f"busiest nearest launch of {len(nearest)}", T, args, kw,
                    rp[7] != 0, OPS_PMTO if pmto else OPS_PMT,
                    f"{rp.shape[1]} rays, {args[3].shape[0]}x{args[6]}, A = "
                    f"{args[5]}{', pmto' if pmto else ''}", plain_reps=1)

    def most_alive(cs):
        return max(cs, key=lambda c: int((c[0][0][7] != 0).sum()))[0]

    # `_refined_lists` calls (pack, boxes, t_cap, ray_tile); these paths
    # run no cap.
    rargs = most_alive(calls["refine_dense_extents"])
    _require(rargs[3] is None, f"{where}: a capped dense query")
    _refine_extents_row(rows, "refine_extents" + suffix, rargs[:3],
                        f"{rargs[0].shape[1]} rays, {rargs[1].shape[0]} "
                        f"clusters, {where}: the launch with the most alive "
                        f"lanes of {len(calls['refine_dense_extents'])}",
                        rargs[4])
    # The list build of the busiest K1 launch (its pack is that walk's),
    # and K6 alone on the pack with the most alive lanes.
    walk_args = busiest["walk"][0]
    largs = next(a for a, _ in calls["tile_lists"] if a[0] is walk_args[0])
    _require(largs[3] is None, f"{where}: a capped list build")
    got = _lists_row(rows, "lists" + suffix, largs,
                     f"{largs[0].shape[1]} rays, {largs[1].shape[0]} "
                     f"boxes, {where}: the lists of the busiest K1 launch, "
                     f"one of {len(calls['tile_lists'])}")
    _require(torch.equal(got[4], walk_args[2]),
             f"lists{suffix}: not the lists of the busiest K1 launch")
    kpack = most_alive(calls["tile_lists"])[0]
    plo, phi = _extents_row(rows, "extents" + suffix, kpack)
    _steady_extents(rows, "extents" + suffix, kpack, plo, phi)


def phase_cli(rows):
    """9. `python -m raytracing_tpu_torch render` at the CLI's defaults
    (800x800x4, CS 128, no bounce accel given, chunks of 16,384), in
    process, its launches counted and captured: its busiest K1 and K2
    launches and its K5+K6 and list-build launches with the most alive
    lanes, and K6 alone on that list build's pack, timed at its shapes
    (`_path_rows`: rows walk_cli, walk_dma_cli, refine_extents_cli,
    lists_cli, extents_cli). Returns the render's launches."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T

    tmp = tempfile.TemporaryDirectory()
    torch.cuda.synchronize()
    T.reset_launches()
    calls = _capture_path(lambda: _cli(
        ["render", "--out", os.path.join(tmp.name, "defaults.png")]))
    torch.cuda.synchronize()
    launches = dict(T.LAUNCHES)
    tmp.cleanup()
    print(f"[cli] launches per render at the CLI's defaults: {launches}")
    _path_rows(rows, calls, "_cli", "at the CLI's defaults")
    return launches


def phase_sharded(rows):
    """10. `render_sharded` of the reference frame (the reference config,
    CS 16 plus the auto-built CS 128 bounce accel) over 4 virtual shards
    of the card, its launches counted and captured, and its kernels timed
    at its shapes (`_path_rows`: rows walk_sharded, walk_dma_sharded,
    refine_extents_sharded, lists_sharded, extents_sharded). Returns the
    frame's launches."""
    import torch

    from raytracing_tpu_torch import (RenderConfig, build_cluster_accel,
                                      build_default_scene)
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.parallel import shard as S

    scene = build_default_scene(device="cuda")
    acc16 = build_cluster_accel(scene.mesh, cluster_size=16)
    mesh4 = S.make_device_mesh(4, devices=["cuda:0"] * 4)
    torch.cuda.synchronize()
    T.reset_launches()
    calls = _capture_path(lambda: S.render_sharded(
        scene, RenderConfig(), mesh4, accel=acc16, seed=0))
    torch.cuda.synchronize()
    launches = dict(T.LAUNCHES)
    print(f"[sharded] launches of the reference frame over 4 shards: "
          f"{launches}")
    _path_rows(rows, calls, "_sharded", "in the reference frame over 4 "
               "shards")
    return launches


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
    camera_lists_launches = phase_kernels_camera(rows)
    large = phase_kernels_large(rows)
    ref_launches, cam_launches = phase_reference_frame(rows)
    variant_launches = phase_variants(rows)
    tile_launches = phase_ray_tile(rows, card, *large[:3])
    (query_launches, big_launches, gstream_launches,
     frame_1m6_launches) = phase_large_scenes(rows, *large)
    light_launches, grid_launches = phase_area_light_frame()
    phase_light_glue(rows)
    bwd_launches, bwd_gi_launches = phase_backward(rows)
    phase_scatter(rows)
    cli_launches = phase_cli(rows)
    sharded_launches = phase_sharded(rows)
    if "jax" in sys.modules:
        raise SmokeFailure("jax was imported")
    # Each kernel's launches on the main path that runs it.
    launches = dict(ref_launches)
    launches["walk_camera"] = cam_launches["walk_camera"]
    launches["walk_camera_dma"] = query_launches["walk_camera_dma"]
    launches["refine_lists"] = big_launches["refine_lists"]
    launches["refine_lists_1m6"] = frame_1m6_launches["refine_lists"]
    launches["walk_gstream"] = gstream_launches["walk_gstream"]
    launches["walk_wq"] = grid_launches["walk_wq"]
    # Both K1 rows are launches of the CS 16 run's one walk_both count.
    launches["walk_both"] = bwd_launches["walk_both"]
    launches["walk_both_bounce"] = bwd_launches["walk_both"]
    launches["walk_dma_both"] = bwd_gi_launches["walk_dma_both"]
    launches.update(variant_launches)
    launches.update(tile_launches)
    # K6 alone at 65,536 rays: the 1.6M frame's K3 queries.
    launches["extents"] = frame_1m6_launches["extents"]
    launches["lists_camera"] = camera_lists_launches
    launches["lists_camera_chunk"] = cam_launches["lists_camera"]
    launches["lists_ext_gstream"] = frame_1m6_launches["lists_ext"]
    launches["lists_camera_pooled"] = query_launches["lists_camera_pooled"]
    launches["lists_camera_members"] = query_launches[
        "lists_camera_members"]
    for k in ("walk", "walk_dma", "refine_extents", "lists"):
        launches[k + "_cli"] = cli_launches[k]
        launches[k + "_sharded"] = sharded_launches[k]
    # Neither path launches K6 alone: their list builds run its reduction
    # (csrc/tile_extents.cuh) at these shapes, once a launch.
    launches["extents_cli"] = cli_launches["lists"]
    launches["extents_sharded"] = sharded_launches["lists"]
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
    # The port's kernels with no TPU counterpart: the JAX package leaves the
    # rest-set merge and the area lights' glue to XLA, which fuses them (no
    # pallas_call), and sums the backward's scatter by a sort.
    # Launches: the reference frame's merges; the camera-mode frame's
    # camera merges, one a camera walk (its other merges are pack merges);
    # the area-light frame's light launches; the scatters of phase 8's CS
    # 16 backward.
    glue = []
    for name, n, source in (
            ("rest_merge", ref_launches["rest_merge"], "rest.cu"),
            ("rest_merge_camera", cam_launches["walk_camera"], "rest.cu"),
            ("light_sample", light_launches["light_sample"], "light.cu"),
            ("light_fold", light_launches["light_fold"], "light.cu"),
            ("segment_scatter_add", bwd_launches.get("scatter", 0),
             "scatter.cu")):
        r = rows[name]
        glue.append({"name": name, "route": "cuda",
                     "source": f"raytracing_tpu_torch/csrc/{source}",
                     "replaces": None, "launches": n,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"],
                     **{k: r[k] for k in ("plain_graphed_ms",
                                          "plain_launches", "sorted_ms")
                        if k in r},
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]})
    print(json.dumps({"glue_kernels": glue}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
