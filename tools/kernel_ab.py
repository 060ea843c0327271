#!/usr/bin/env python3
"""Time kernels of two trees in one process on one CUDA card: the
refinement (K5, dense and gathered) and the extents (K6), the pack walk
(K1/K2, `rt_walk`), the camera walk (K1 camera / K2 camera,
`rt_walk_camera`) and the streamed-groups walk (K3, `rt_walk_gstream`).

Run from the root of a checkout, with another commit of the repository
unpacked somewhere (`git archive <commit> | tar -x -C _work/parent`):

    python3 tools/kernel_ab.py _work/parent [--sweep]

Both trees' `raytracing_tpu_torch/csrc/*.cu` are compiled with this tree's
nvcc flags. The dense refined-list query runs on the depth-2 wavefront of
the reference frame's busiest chunk, 720,896 rays against the 100 clusters
of the CS=128 accel, as each tree's `_refined_lists` runs it: one launch
(`rt_refine_dense_extents`) or `rt_tile_extents`, the tile-alive flags
derived from its extents and `rt_refine_dense`; then `rt_refine_dense`
with the flags given and `rt_tile_extents` alone, which is also read
steadily: 200 launches in one pair of CUDA events. `rt_refine_lists` runs
at chip_smoke.py's two rows: the 404k wavefront's lists (3,160 clusters)
and the busiest of the 1.6M Whitted frame's 40 launches (12,640), captured
from the renderer; the spread of listed candidates and alive lanes over
the tiles is printed for both and for all 40 launches. A tree whose
refinement deals a tile's list to blocks in runs takes a grid (this
tree's `_refine_grid`); one that gives a tile one block does not.
`rt_walk` runs on the lists phase 3 of chip_smoke.py times it on:
that wavefront's refined lists over the combined table (the `_walk_dma`
entry, nearest with attributes), the chunk's area-light shadow query over
the CS=16 table (the `_walk_groups` entry, occlusion under a per-ray limit,
~200 listed clusters per tile), the chunk's primaries (short lists), and
the whole frame's 2,560,000 primaries over the subdivided teapot's 6,320 x
64 and 12,640 x 128 tables (coherent rays: the early exit decides the
work). `rt_walk_camera` runs on the whole reference frame (2,500 tiles of
1,024 rays) over the default scene's CS=16 table, on one 64-tile chunk of
the camera-primaries reference frame as the renderer launches it, and over
the 1.6M and 6.4M tables (CS=128, the combined-table entry);
`rt_walk_gstream` on the whole frame's primaries over the 1.6M and 6.4M
tables (4 and 10 groups) and on the two launches of chunk 12 of the 1.6M
Whitted frame as the renderer makes them (65,536 rays: primary
nearest+attrs, sun-shadow occlusion). A tree whose walk splits a tile's
list over blocks takes a segment size and merge scratch; one that gives a
tile one block does not: each tree's entries are bound by their own
signatures. Every kernel runs in the order this, other, other, this, each
the median of 5 launches by CUDA events. Prints the kernels' registers as
`ptxas -v` reports them, the four times, the visits each tree made, and
whether the outputs are equal (the walk's on alive lanes: a dead lane does
not vote on the early exit, so its result is meaningless). With `--sweep`
this tree's gathered refinement is then timed at other grids (runs of
32-256 positions, 16-128 blocks a tile) and its split walks on every
input at segments of 128, 256 and 512 triangles and at 4, 16 and 64
blocks per tile at most. Kernel
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
        name = next((k for k in ("refine_lists_kernel", "13refine_kernel",
                                 "extents_kernel", "camera_walk_kernel",
                                 "gstream_kernel", "walk_kernel")
                     if k in line), None)
        if "Compiling entry" in line and name:
            used = next(l for l in lines[i:] if "Used" in l)
            spill = next(l for l in lines[i:] if "spill" in l)
            print(f"[build] {tree}: {name.lstrip('13')}: "
                  f"{used.split(':', 1)[1].strip()}; {spill.strip()}")
    lib = ctypes.CDLL(out)
    p, ll, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float)
    lib.rt_tile_extents.argtypes = [p, ll, p, p, p]
    # A tree whose refinement deals a tile's list to several blocks takes
    # a grid, and folds the extents into the dense query; one that serves
    # the two-phase capped query takes a cap (+inf here) after the boxes.
    with open(os.path.join(tree, "raytracing_tpu_torch", "csrc",
                           "refine.cu")) as f:
        text = f.read()
    lib.fused_refine = "rt_refine_dense_extents" in text
    lib.cap = (f32,) if "float cap" in text else ()
    lib.rt_refine_dense.argtypes = [p, ll, p, p, i32, *lib.cap, p, p, p]
    if lib.fused_refine:
        lib.rt_refine_dense_extents.argtypes = [p, ll, p, p, i32, *lib.cap,
                                                p, p, p, p]
        lib.rt_refine_lists.argtypes = [p, ll, p, p, i32, i32, i32, p, p,
                                        *lib.cap, p, p]
    else:
        lib.rt_refine_lists.argtypes = [p, ll, p, p, i32, p, p, p, p]
    split, culls = {}, {}
    for name in ("walk", "camera", "gstream"):
        with open(os.path.join(tree, "raytracing_tpu_torch", "csrc",
                               f"{name}.cu")) as f:
            text = f.read()
        split[name] = "int* finished" in text
        # A walk with the lane-cull pre-test takes its boxes (null here)
        # after ee_batch / the family.
        culls[name] = [p] if "lane_bounds" in text else []
    lib.split_walk, lib.split_camera, lib.split_gstream = split.values()
    lib.cull_walk, lib.cull_camera = culls["walk"], culls["camera"]
    head = [p, ll, p, p, p, p, i32]
    tail = [p, p, ll, p, ll, i32, i32, f32, f32, i32, i32, i32, i32,
            *lib.cull_walk]
    lib.rt_walk.argtypes = (head + [i32] * 2 + tail + [p] * 7
                            if lib.split_walk else head + tail + [p] * 5)
    # rt_walk_camera: offs .. width, [seg, tile_blocks], bbox .. ee_batch,
    # [keys, finished], outputs, visits, stream.
    head = [p] + [i32] * 7 + [f32, f32, p, p, p, i32]
    tail = [p, p, ll, p, ll, i32, i32, f32, i32, i32, *lib.cull_camera]
    lib.rt_walk_camera.argtypes = (
        head + [i32] * 2 + tail + [p] * 7 if lib.split_camera
        else head + tail + [p] * 5)
    # rt_walk_gstream: rays .. width, [seg, tile_blocks], n_groups .. pmto,
    # [keys, finished], outputs, visits, stream.
    head = [p, ll, p, p, p, p, i32]
    tail = [i32, i32, p, p, ll, p, ll, i32, i32, f32, f32, i32, i32, i32, i32]
    lib.rt_walk_gstream.argtypes = (
        head + [i32] * 2 + tail + [p] * 7 if lib.split_gstream
        else head + tail + [p] * 5)
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
            int(kw["ee_batch"]), int(pmto)] + [None] * len(lib.cull_walk)
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


def _call_camera(lib, args, kw, out):
    """`rt_walk_camera` of one tree on `walk_camera(*args, **kw)`'s
    arguments."""
    from raytracing_tpu_torch.kernels import traverse as T

    offs, cam, tile0, n_tiles, ids, cnt, geo, attr, n_attrs, cs, eps = args
    early = kw.get("tnear") is not None
    ptr = T._ptr
    head = [ptr(offs), int(tile0), n_tiles, cam.width, cam.height, cam.spp,
            cam.bh, cam.bw, float(cam.aspect), float(cam.scale), ptr(ids),
            ptr(cnt), ptr(kw["tnear"] if early else None), ids.shape[1]]
    tail = [ptr(kw["bbox"] if early else None), ptr(geo), geo.stride(0),
            ptr(attr), attr.stride(0) if attr is not None else 0,
            n_attrs if attr is not None else 0, cs, float(eps), int(early),
            int(kw["ee_batch"])] + [None] * len(lib.cull_camera)
    outs = [ptr(out["t"]), ptr(out["s"]), ptr(out["a"]), ptr(out["visits"]),
            T._stream()]
    if lib.split_camera:
        seg, tile_blocks, _ = T._camera_grid(n_tiles, cam.ray_tile,
                                             ids.shape[1], cs)
        rc = lib.rt_walk_camera(*head, seg, tile_blocks, *tail,
                                ptr(out["keys"]), ptr(out["finished"]), *outs)
    else:
        rc = lib.rt_walk_camera(*head, *tail, *outs)
    assert rc == 0, rc


def _call_gstream(lib, args, kw, out):
    """`rt_walk_gstream` of one tree on `walk_gstream(*args, **kw)`'s
    arguments."""
    from raytracing_tpu_torch.kernels import traverse as T

    (rp, ids, cnt, geo, attr, n_attrs, cs, gsz, eps, nearest, t_max, pmto,
     row) = args
    early = kw.get("tnear") is not None and nearest
    attr = attr if nearest and n_attrs else None
    ptr = T._ptr
    ng, nt, w = ids.shape
    head = [ptr(rp), rp.shape[1], ptr(row), ptr(ids), ptr(cnt),
            ptr(kw["tnear"] if early else None), w]
    tail = [ng, int(gsz), ptr(kw["bbox"] if early else None), ptr(geo),
            geo.stride(0), ptr(attr),
            attr.stride(0) if attr is not None else 0,
            n_attrs if attr is not None else 0, cs, float(eps), float(t_max),
            int(nearest), int(early), int(kw["ee_batch"]), int(pmto)]
    outs = [ptr(out["t"]), ptr(out["s"]), ptr(out["a"]), ptr(out["visits"]),
            T._stream()]
    if lib.split_gstream:
        seg, tile_blocks = T._gstream_grid(nt, ng, w, cs)
        rc = lib.rt_walk_gstream(*head, seg, tile_blocks, *tail,
                                 ptr(out["keys"]), ptr(out["finished"]),
                                 *outs)
    else:
        rc = lib.rt_walk_gstream(*head, *tail, *outs)
    assert rc == 0, rc


def _refine_dense(lib, rays, cmin, cmax, alive, bits):
    """`rt_refine_dense` of one tree, tile-alive flags given."""
    from raytracing_tpu_torch.kernels import traverse as T

    rc = lib.rt_refine_dense(T._ptr(rays), rays.shape[1], T._ptr(cmin),
                             T._ptr(cmax), cmin.shape[0],
                             *(T.INF,) * len(lib.cap), T._ptr(alive),
                             T._ptr(bits), T._stream())
    assert rc == 0, rc


def _dense_query(lib, rays, cmin, cmax, out):
    """The dense refined-list query's kernels as `_refined_lists` runs them
    in one tree: the fused launch, or the extents (K6), the tile-alive
    flags derived from them and the entered bits (K5)."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T

    ptr = T._ptr
    lo, hi, bits = out["lo"], out["hi"], out["bits"]
    if lib.fused_refine:
        rc = lib.rt_refine_dense_extents(
            ptr(rays), rays.shape[1], ptr(cmin), ptr(cmax), cmin.shape[0],
            *(T.INF,) * len(lib.cap), ptr(lo), ptr(hi), ptr(bits),
            T._stream())
        assert rc == 0, rc
        return
    rc = lib.rt_tile_extents(ptr(rays), rays.shape[1], ptr(lo), ptr(hi),
                             T._stream())
    assert rc == 0, rc
    _refine_dense(lib, rays, cmin, cmax, (hi[:, 7] > 0.0).to(torch.int32),
                  bits)


def _refine_lists(lib, rays, ids, cnt, cmin, cmax, bits):
    """`rt_refine_lists` of one tree, on this tree's grid if it takes
    one."""
    from raytracing_tpu_torch.kernels import traverse as T

    ptr = T._ptr
    grid = (T._refine_grid(ids.shape[0], ids.shape[1])
            if lib.fused_refine else ())
    rc = lib.rt_refine_lists(ptr(rays), rays.shape[1], ptr(ids), ptr(cnt),
                             ids.shape[1], *grid, ptr(cmin), ptr(cmax),
                             *(T.INF,) * len(lib.cap), ptr(bits),
                             T._stream())
    assert rc == 0, rc


def _walk_outputs(kind, args):
    """Outputs and scratch of one launch of `kind` ("walk", "camera" or
    "gstream"): t, slot, attrs, merge keys, finish counters, visits."""
    import torch

    if kind == "camera":
        cam, n_tiles, cnt, n_attrs = args[1], args[3], args[5], args[8]
        n, dev = n_tiles * cam.ray_tile, cnt.device
        n_fin = n_tiles * -(-cam.ray_tile // 1024)
        visits = (n_tiles,)
    else:
        rp, cnt, n_attrs = args[0], args[2], args[5]
        n, dev = rp.shape[1], rp.device
        n_fin = n // 1024
        visits = cnt.shape
    return dict(t=torch.empty((1, n), device=dev),
                s=torch.empty((1, n), dtype=torch.int32, device=dev),
                a=torch.empty((max(n_attrs, 1), n), device=dev),
                keys=torch.empty(n, dtype=torch.int64, device=dev),
                finished=torch.empty(n_fin, dtype=torch.int32, device=dev),
                visits=torch.zeros(visits, dtype=torch.int32, device=dev))


def _frame_chunk_launches(dev, mesh_1m6, acc_1m6):
    """The launches of the frames' own shapes, as chip_smoke.py's phases 5
    and 7 capture them: the `walk_camera` launch of the camera-primaries
    reference frame's chunk 20 (64 tiles), and the two `walk_gstream`
    launches of the 1.6M Whitted frame's chunk 12 (65,536 rays: the
    primary nearest+attrs query, then the sun-shadow query), each as
    (args, kw); and under "refine_lists_1m6" the arguments of every
    `refine_lists` launch of that frame."""
    import torch

    import chip_smoke
    from raytracing_tpu_torch import (RenderConfig, bench,
                                      build_cluster_accel, build_default_scene)
    from raytracing_tpu_torch.geometry.mesh import Scene
    from raytracing_tpu_torch.geometry.scene import sun_position
    from raytracing_tpu_torch.models import whitted

    cfg = RenderConfig()
    scene = build_default_scene(device=dev)
    acc16 = build_cluster_accel(scene.mesh, cluster_size=16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    (camera,) = chip_smoke._capture_calls(
        "walk_camera", [chip_smoke.KERNEL_CHUNK], lambda: whitted.render(
            scene, cfg.replace(primary_shared_origin=True), accel=acc16,
            generator=gen))
    k = 2 * chip_smoke.LARGE_KERNEL_CHUNK  # each chunk: primary, sun shadow
    def frame_1m6():
        return whitted.render(
            Scene(mesh=mesh_1m6, sun=sun_position(0.0).to(dev)), cfg,
            accel=acc_1m6, generator=gen)

    refines = []
    prim, shadow = chip_smoke._capture_calls(
        "walk_gstream", [k, k + 1], lambda: refines.extend(
            chip_smoke._capture_calls("refine_lists", None, frame_1m6)))
    if not (prim[0][9] and not shadow[0][9]):
        raise SystemExit("walk_gstream calls of a chunk: not primary, then "
                         "shadow")
    return {"walk_camera_chunk": camera, "walk_gstream_chunk": prim,
            "walk_gstream_chunk_shadow": shadow,
            "refine_lists_1m6": [args for args, _ in refines]}


def _inputs(dev):
    """The depth-2 wavefront phase 3a of chip_smoke.py gives K5 and K6 with
    the CS=128 boxes, and phase 3's `rt_walk` launches as (args, kw) of
    `traverse.walk`: its `_walk_dma` row, its K1 light-shadow row (3d) and
    its K1 primary row."""
    import torch

    import chip_smoke
    from raytracing_tpu_torch import (RenderConfig, bench,
                                      build_cluster_accel, build_default_scene)
    from raytracing_tpu_torch.geometry.mesh import Scene
    from raytracing_tpu_torch.geometry.scene import (subdivided_teapot_mesh,
                                                     sun_position)
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
        whitted.light_cone(bench.sphere_light(dev), 0, pos), pos, n, hit,
        torch.rand((pos.shape[0], 2), generator=gen, device=dev))
    walks["walk, 65,536 light-shadow rays, 790x16, occlusion under "
          "tmax_row"] = T._groups_walk_args(
        acc16, T.rays_to_soa(pos, w_dir, alive=l_alive), cfg.eps, False, INF,
        0, tmax_row=t_stop[None].contiguous())
    # Coherent rays over big tables, where the early exit decides the work:
    # the whole frame's primaries (origin folded) against the subdivided
    # teapot, each table in one `_walk_groups` launch; the camera walk and
    # K3 over the same frame and tables.
    camera = chip_smoke._reference_camera(dev)
    cam, offs, frame, eps = camera
    n_tiles = cam.grid[0] * cam.grid[1]
    zero3 = torch.zeros(3, device=dev)
    cameras = {f"walk_camera, {n_tiles} x 1,024 rays, 790x16, A = {na}":
               T._camera_walk_args(acc16, offs, cam, 0, n_tiles, na, eps)}
    gstreams = {}
    for levels, cs in ((3, 64), (4, 128), (5, 128)):
        mesh = subdivided_teapot_mesh(levels=levels, device=dev)
        acc = build_cluster_accel(mesh, cluster_size=cs, variants=("pmt",))
        c = acc.num_clusters
        if levels == 3:  # chip_smoke.py's refine_lists row
            bp404, _, _ = chip_smoke._wavefront_404k(
                Scene(mesh=mesh, sun=sun_position(0.0).to(dev)), acc)
            refines = {"refine_lists, the 404k wavefront":
                       chip_smoke.refine_lists_404k(bp404, build_cluster_accel(
                           mesh, cluster_size=128, variants=("pmt",)))}
        if levels < 5:
            walks[f"walk, 2,560,000 primaries, {c}x{cs}, nearest+attrs, "
                  f"pmto"] = T._groups_walk_args(acc, frame, eps, True, INF,
                                                 na, shared_origin=zero3)
        if levels > 3:
            cameras[f"walk_camera_dma, {n_tiles} x 1,024 rays, {c}x{cs}"] = \
                T._camera_walk_args(acc, offs, cam, 0, n_tiles, 0, eps)
            gstreams[f"walk_gstream, 2,560,000 primaries, {c}x{cs}, "
                     f"nearest+attrs, pmto"] = T._gstream_walk_args(
                acc, frame, eps, True, INF, na, shared_origin=zero3)
        if levels == 4:
            mesh_1m6, acc_1m6 = mesh, acc
        del mesh, acc
    # The frames' own shapes: one 64-tile chunk of the camera-primaries
    # reference frame, and chunk 12 of the 1.6M Whitted frame.
    chunks = _frame_chunk_launches(dev, mesh_1m6, acc_1m6)
    cameras["walk_camera, chunk of 64 tiles x 1,024 rays, 790x16, A = 4"] = \
        chunks["walk_camera_chunk"]
    gstreams["walk_gstream, 1.6M frame chunk, 65,536 primaries, "
             "nearest+attrs"] = chunks["walk_gstream_chunk"]
    gstreams["walk_gstream, 1.6M frame chunk, 65,536 sun-shadow rays, "
             "occlusion"] = chunks["walk_gstream_chunk_shadow"]
    # The 1.6M frame's gathered refinements: the spread of their work, and
    # the busiest (most listed candidates) as a row.
    frame = chunks["refine_lists_1m6"]
    cnt = torch.cat([a[2] for a in frame])
    alive = torch.cat([chip_smoke._tile_alive_lanes(a[0]) for a in frame])
    busiest = max(frame, key=lambda a: int(a[2].sum()))
    print(f"[input] the 1.6M frame's {len(frame)} refine_lists launches: "
          f"{chip_smoke._list_stats(cnt, alive)}; listed per launch "
          f"{[int(a[2].sum()) for a in frame]}")
    refines["refine_lists, the 1.6M frame's busiest launch"] = busiest
    return (bp, acc128.cluster_min.contiguous(),
            acc128.cluster_max.contiguous(),
            {"walk": walks, "camera": cameras, "gstream": gstreams}, refines)


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
    import chip_smoke

    bp, cmin, cmax, by_kind, refines = _inputs("cuda")
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    n = bp.shape[1]
    nt, c = n // 1024, cmin.shape[0]
    dense_out = {k: dict(lo=torch.empty((nt, 8), device="cuda"),
                         hi=torch.empty((nt, 8), device="cuda"),
                         bits=torch.empty((nt, c), dtype=torch.int32,
                                          device="cuda")) for k in libs}
    libs["this"].rt_tile_extents(ptr(bp), n, ptr(dense_out["this"]["lo"]),
                                 ptr(dense_out["this"]["hi"]), stream)
    alive = (dense_out["this"]["hi"][:, 7] > 0.0).to(torch.int32).contiguous()
    spread = chip_smoke._list_stats(alive * c,
                                    chip_smoke._tile_alive_lanes(bp))
    print(f"[input] dense query: {n} rays, {c} clusters; {spread}")
    order = ("this", "other", "other", "this")
    dense = {
        "dense query (extents, tile-alive flags, entered bits)":
            lambda k: _dense_query(libs[k], bp, cmin, cmax, dense_out[k]),
        "refine_dense, tile-alive flags given":
            lambda k: _refine_dense(libs[k], bp, cmin, cmax, alive,
                                    dense_out[k]["bits"]),
        "extents": lambda k: libs[k].rt_tile_extents(
            ptr(bp), n, ptr(dense_out[k]["lo"]), ptr(dense_out[k]["hi"]),
            stream)}
    same = True
    for name, fn in dense.items():
        for k in order * 3:  # the first launches of a process run slower
            fn(k)
        ms = [_median_ms(lambda k=k: fn(k)) for k in order]
        print(f"[{name}] ms, median of 5: "
              + ", ".join(f"{k} {t}" for k, t in zip(order, ms)))
        eq = all(torch.equal(dense_out["this"][x], dense_out["other"][x])
                 for x in ("lo", "hi", "bits"))
        print(f"[{name}] extents and bits of the two trees equal: {eq}")
        same = same and eq
    steady = [chip_smoke._steady_ms(lambda k=k: dense["extents"](k))
              for k in order]
    print("[extents] ms, 200 back-to-back launches in one pair of CUDA "
          "events: " + ", ".join(f"{k} {t}" for k, t in zip(order, steady)))
    for name, rargs in refines.items():
        # (a captured call of this tree also passes its cap: None here)
        rays, ids, cnt, rmin, rmax = rargs[:5]
        cnt = cnt.to(torch.int32).contiguous()
        bits = {k: torch.empty(ids.shape, dtype=torch.int32, device="cuda")
                for k in libs}

        def launch(k):
            _refine_lists(libs[k], rays, ids, cnt, rmin.contiguous(),
                          rmax.contiguous(), bits[k])

        for k in order * 3:
            launch(k)
        ms = [_median_ms(lambda k=k: launch(k)) for k in order]
        spread = chip_smoke._list_stats(cnt,
                                        chip_smoke._tile_alive_lanes(rays))
        print(f"[{name}] {rays.shape[1]} rays, lists {tuple(ids.shape)}, "
              f"{int(bits['this'].sum())} of {int(cnt.sum())} kept; {spread}")
        print(f"[{name}] ms, median of 5: "
              + ", ".join(f"{k} {t}" for k, t in zip(order, ms)))
        eq = torch.equal(bits["this"], bits["other"])
        print(f"[{name}] bits of the two trees equal: {eq}")
        same = same and eq
    calls = {"walk": _call_walk, "camera": _call_camera,
             "gstream": _call_gstream}
    for kind, launches in by_kind.items():
        for name, (args, kw) in launches.items():
            icnt = 5 if kind == "camera" else 2
            args = (args[:icnt] + (args[icnt].to(torch.int32).contiguous(),)
                    + args[icnt + 1:])
            call = calls[kind]
            out = {k: _walk_outputs(kind, args) for k in libs}
            for k in order * 3:
                call(libs[k], args, kw, out[k])
            ms = [_median_ms(lambda k=k: call(libs[k], args, kw, out[k]))
                  for k in order]
            print(f"[{name}] ms, median of 5: "
                  + ", ".join(f"{k} {t}" for k, t in zip(order, ms)))
            # Camera lanes are all alive; a pack's dead lanes do not vote.
            m = (slice(None) if kind == "camera" else args[0][7] != 0)
            nearest = kind == "camera" or args[9 if kind == "gstream" else 8]
            with_attrs = nearest and args[8 if kind == "camera" else 5]
            a, b = out["this"], out["other"]
            eq = all(torch.equal(a[k][..., m], b[k][..., m])
                     for k in ("t", "s", "a")[:3 if with_attrs else 2])
            print(f"[{name}] visits this {int(a['visits'].sum())}, other "
                  f"{int(b['visits'].sum())} of {int(args[icnt].sum())} "
                  f"listed; outputs equal on alive lanes: {eq}")
            same = same and eq
    print(f"[equal] outputs of the two trees equal: {same}")
    if sweep:
        _sweep_refine(libs["this"], refines)
        _sweep(libs["this"], by_kind)
    return 0 if same else 1


def _sweep_refine(lib, refines):
    """This tree's gathered refinement at other grids than
    `kernels/traverse.py` sets: runs of 32-256 positions and at most 16-128
    blocks a tile; two rounds."""
    import torch

    from raytracing_tpu_torch.kernels import traverse as T

    saved = (T._REFINE_RUN, T._MAX_REFINE_BLOCKS)
    try:
        for name, (rays, ids, cnt, rmin, rmax) in refines.items():
            cnt = cnt.to(torch.int32).contiguous()
            bits = torch.empty(ids.shape, dtype=torch.int32, device="cuda")
            for run, cap in ((64, 64), (32, 64), (128, 64), (256, 64),
                             (64, 16), (64, 128), (128, 128), (32, 32)) * 2:
                T._REFINE_RUN, T._MAX_REFINE_BLOCKS = run, cap
                ms = _median_ms(lambda: _refine_lists(
                    lib, rays, ids, cnt, rmin.contiguous(),
                    rmax.contiguous(), bits))
                print(f"[sweep] {name}: runs of {run}, at most {cap} blocks "
                      f"a tile: {ms} ms")
    finally:
        T._REFINE_RUN, T._MAX_REFINE_BLOCKS = saved


def _sweep(lib, by_kind):
    """This tree's split walks at other segment sizes and other caps on a
    tile's blocks than `kernels/traverse.py` sets, two rounds."""
    from raytracing_tpu_torch.kernels import traverse as T

    import torch

    calls = {"walk": _call_walk, "camera": _call_camera,
             "gstream": _call_gstream}
    saved = (T._SEGMENT_TRIANGLES, T._SHORT_SEGMENT_TRIANGLES,
             T._LONG_SEGMENT_TRIANGLES, T._MAX_TILE_BLOCKS)
    try:
        for kind, launches in by_kind.items():
            for name, (args, kw) in launches.items():
                icnt = 5 if kind == "camera" else 2
                args = (args[:icnt]
                        + (args[icnt].to(torch.int32).contiguous(),)
                        + args[icnt + 1:])
                out = _walk_outputs(kind, args)
                for seg, cap in ((256, 64), (128, 64), (512, 64), (256, 16),
                                 (256, 4), (128, 16)) * 2:
                    T._SEGMENT_TRIANGLES = seg
                    T._SHORT_SEGMENT_TRIANGLES = T._LONG_SEGMENT_TRIANGLES = seg
                    T._MAX_TILE_BLOCKS = cap
                    ms = _median_ms(lambda: calls[kind](lib, args, kw, out))
                    print(f"[sweep] {name}: {seg} triangles a segment, at "
                          f"most {cap} blocks a tile: {ms} ms, "
                          f"{int(out['visits'].sum())} visits")
    finally:
        (T._SEGMENT_TRIANGLES, T._SHORT_SEGMENT_TRIANGLES,
         T._LONG_SEGMENT_TRIANGLES, T._MAX_TILE_BLOCKS) = saved


if __name__ == "__main__":
    sys.exit(main(sys.argv))
