"""Command-line application (twin of `raytracing_tpu.app`):

  render   one frame of the default scene -> PNG
  animate  N frames with the orbiting sun, an fps line once a second, and
           optional PNG dumps or a live terminal view
  bench    the headline primary rays/s (`bench.measure`)
  fit      inverse rendering: perturb the scene's colors, recover them,
           with checkpoint and resume

Run: python -m raytracing_tpu_torch <subcommand> [flags]

The flags and their defaults are the JAX package's, plus `--device`: the
card ("cuda", the default) or "cpu", where the kernels' plain PyTorch
versions run. Without a card and without `--device cpu` a command fails;
it never renders on the CPU in the card's place. `--backend` picks the
traversal: the kernels ("auto", "cuda", "pallas") or the plain PyTorch
"bruteforce" (no accel is built) and "cluster" backends.

Multi-process rendering, as the JAX CLI does it: `render` with
`--num-processes N --process-id i --coordinator host:port` (or the
RTPU_NUM_PROCESSES / RTPU_PROCESS_ID / RTPU_COORDINATOR variables; `auto`
reads torchrun's) joins a `torch.distributed` group, renders this
process's shards of the frame and writes them to `<out>.shards/`; with
`--assemble` process 0 stitches them into `<out>` once every process has
written. The group runs NCCL on a card and gloo on the CPU;
`--dist-backend gloo` puts processes that share one card in a gloo group
(NCCL refuses two ranks on one card). `--device cuda` gives each process
of a group its own card: torchrun's LOCAL_RANK, else its rank modulo the
host's cards; `--device cuda:i` names one. The other commands run in one
process and ignore these flags, as the JAX CLI's do.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Optional

import torch

FIT_CHECKPOINT_EVERY = 50  # steps between mid-fit snapshots (as the JAX CLI)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _check_args(args) -> torch.device:
    """The device to run on, or SystemExit without the card asked for."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA card here (torch.cuda.is_available() is False); pass "
            "--device cpu to run the kernels' plain versions on the CPU")
    return dev


def _rank_card(rank: int) -> int:
    """The card of process `rank` of a group when --device names none:
    torchrun's LOCAL_RANK, else rank modulo the cards of this host."""
    local = os.environ.get("LOCAL_RANK")
    return int(local) if local is not None else \
        rank % torch.cuda.device_count()


def _maybe_init_distributed(args) -> bool:
    """Join a process group (`parallel.distributed.initialize`) from the
    multi-process flags or the RTPU_* variables; False, and nothing done,
    for a single process. NCCL on a card unless --dist-backend says
    otherwise; gloo for --device cpu. In a group, `--device cuda` (no
    index) becomes this process's card (`_rank_card`), which is made the
    current card, so that the processes of a host spread over its
    cards."""
    from raytracing_tpu_torch.parallel.distributed import (initialize,
                                                           process_index)

    dev = torch.device(args.device)
    backend = args.dist_backend or ("gloo" if dev.type == "cpu" else None)
    joined = initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes, process_id=args.process_id,
        local_device_ids=([dev.index] if dev.type == "cuda"
                          and dev.index is not None else None),
        backend=backend)
    if joined and dev.type == "cuda" and dev.index is None:
        card = _rank_card(process_index())
        torch.cuda.set_device(card)
        args.device = f"cuda:{card}"
    return joined


def _build(args):
    """(config, scene, accel, gi_accel, device) from the common flags;
    under --backend bruteforce no accel is built (accel and gi_accel
    None), as in the JAX CLI."""
    from raytracing_tpu_torch.accel.packets import (build_cluster_accel,
                                                    load_accel, save_accel)
    from raytracing_tpu_torch.config import RenderConfig
    from raytracing_tpu_torch.geometry.scene import build_default_scene
    from raytracing_tpu_torch.tracer import resolve_backend

    dev = torch.device(args.device)
    cfg = RenderConfig(
        width=args.width, height=args.height,
        samples_per_pixel=args.spp,
        backend=resolve_backend(args.backend),
        chunk_size=args.chunk_size,
        reflect_depth=args.reflect_depth, diffuse_depth=args.diffuse_depth,
        diffuse_scatter=args.diffuse_scatter,
    )
    scene = build_default_scene(t=0.0, obj_path=args.obj, device=dev)
    if cfg.backend == "bruteforce":
        print("accel: none (--backend bruteforce tests every triangle)")
        return cfg, scene, None, None, dev
    t0 = time.perf_counter()
    cache = getattr(args, "accel_cache", None)
    if cache and os.path.exists(cache):
        # A cache of another mesh or cluster size raises instead of
        # rendering stale geometry.
        accel = load_accel(cache, mesh=scene.mesh,
                           cluster_size=args.cluster_size, device=dev)
        how = f"loaded from {cache}"
    else:
        accel = build_cluster_accel(scene.mesh,
                                    cluster_size=args.cluster_size)
        how = "built"
        if cache:
            save_accel(cache, accel, mesh=scene.mesh)
            how += f", saved to {cache}"
    _sync(dev)
    print(f"accel: {accel.num_clusters} clusters of {accel.cluster_size}, "
          f"{how} in {time.perf_counter() - t0:.3f} s")
    gi_accel = None
    if args.gi_cluster_size:
        # A coarser second accel for the bounce levels: the same image.
        gi_accel = build_cluster_accel(scene.mesh,
                                       cluster_size=args.gi_cluster_size)
    return cfg, scene, accel, gi_accel, dev


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def cmd_render(args) -> None:
    from raytracing_tpu_torch.models.whitted import render
    from raytracing_tpu_torch.utils.image import write_png
    from raytracing_tpu_torch.utils.profiling import (device_summary,
                                                      profile_trace)

    multi = _maybe_init_distributed(args)
    cfg, scene, accel, gi_accel, dev = _build(args)
    summary = device_summary(dev)
    print(f"devices: {summary}")
    print(f"triangles: {scene.mesh.num_triangles}")
    if multi:
        _render_distributed(args, cfg, scene, accel, gi_accel, dev, summary)
        return
    with profile_trace(args.profile):
        _sync(dev)
        t0 = time.perf_counter()
        img = render(scene, cfg, accel=accel, gi_accel=gi_accel,
                     generator=_generator(dev, args.seed))
        _sync(dev)
        dt = time.perf_counter() - t0
    rays = cfg.width * cfg.height * cfg.samples_per_pixel
    print(f"frame: {dt * 1e3:.1f} ms ({rays / dt / 1e6:.2f} M primary "
          f"rays/s) on {summary}")
    write_png(args.out, img)
    print(f"wrote {args.out}")


def _render_distributed(args, cfg, scene, accel, gi_accel, dev, summary):
    """This process's shards of the frame to `<out>.shards/`; with
    --assemble, process 0 stitches the frame into `<out>` once every
    process has written. Leaves the group at the end."""
    from raytracing_tpu_torch.parallel import distributed as D
    from raytracing_tpu_torch.utils.image import write_png

    try:
        mesh = D.global_ray_mesh(devices=[dev])
        _sync(dev)
        t0 = time.perf_counter()
        shards = D.render_distributed(scene, cfg, accel=accel, seed=args.seed,
                                      mesh=mesh, gi_accel=gi_accel)
        _sync(dev)
        dt = time.perf_counter() - t0
        out_dir = args.out + ".shards"
        files = D.save_local_shards(shards, out_dir)
        print(f"frame: {dt * 1e3:.1f} ms; wrote {len(files)} shard files "
              f"to {out_dir} (process {mesh.process_index} of "
              f"{mesh.process_count}, shards {[g for g, _, _ in shards]}) "
              f"on {summary}")
        D.barrier()
        if mesh.process_index == 0 and args.assemble:
            write_png(args.out, D.assemble_shards(out_dir, cfg))
            print(f"wrote {args.out}")
    finally:
        D.shutdown()


def cmd_animate(args) -> None:
    """Frame loop with the orbiting sun: a new Scene per frame around the
    same mesh, so the accel and the auto-built bounce accel (cached by
    mesh in `models.whitted`) are reused."""
    from raytracing_tpu_torch.geometry.mesh import Scene
    from raytracing_tpu_torch.geometry.scene import sun_position
    from raytracing_tpu_torch.models.whitted import render
    from raytracing_tpu_torch.utils.image import write_png
    from raytracing_tpu_torch.utils.profiling import RateMeter
    from raytracing_tpu_torch.utils.resilience import classify, with_retry

    cfg, scene, accel, gi_accel, dev = _build(args)
    fps = RateMeter("fps")
    viewer = None
    if args.live:
        from raytracing_tpu_torch.utils.term_view import TermViewer

        viewer = TermViewer(max_cols=args.live_cols)

    def render_frame(frame, t):
        # Under retry, each frame from its own seed: a retried frame is
        # the frame a clean run renders.
        return with_retry(
            lambda: render(Scene(mesh=scene.mesh,
                                 sun=sun_position(t).to(dev)),
                           cfg, accel=accel, gi_accel=gi_accel,
                           generator=_generator(dev, frame)),
            probe=True, device=dev)

    def present(frame, t, img):
        # In live mode the fps line rides the viewer's status bar.
        fps.tick(emit=None if viewer is not None else print)
        if viewer is not None:
            rate = f"{fps.last_rate:.2f}" if fps.last_rate else "..."
            viewer.show(img, status=f"frame {frame}  t={t:6.2f}s  fps {rate}")
        if args.out_pattern:
            write_png(args.out_pattern.format(frame=frame), img)

    def present_safe(frame, t, img):
        # A fault of the frame's last, unsynchronised work surfaces when
        # the host reads it: render that frame again under retry.
        try:
            present(frame, t, img)
        except RuntimeError as e:
            if classify(e) != "transient":
                raise
            present(frame, t, render_frame(frame, t))

    # The loop keeps the JAX CLI's shape, presenting frame n-1 after frame
    # n was queued; the renderer waits for the card at every level, so
    # little of the presenting overlaps the rendering.
    start = time.perf_counter()
    pending = None
    for frame in range(args.frames):
        t = time.perf_counter() - start
        img = render_frame(frame, t)
        if pending is not None:
            present_safe(*pending)
        pending = (frame, t, img)
    if pending is not None:
        present_safe(*pending)
    _sync(dev)
    total = time.perf_counter() - start
    print(f"rendered {args.frames} frames in {total:.2f}s "
          f"({args.frames / total:.2f} fps avg)")


def cmd_bench(args) -> None:
    from raytracing_tpu_torch import bench

    if torch.device(args.device).type != "cuda":
        raise SystemExit("bench measures the card; --device cpu has no "
                         "benchmark")
    bench.main()


def cmd_fit(args) -> None:
    """Fit {"colors": colors * perturb} to the scene's own render (seed
    0) with the port's `models.inverse.fit`. With --checkpoint, the live
    params, Adam's state and the step are written every
    FIT_CHECKPOINT_EVERY steps and at the end; --resume continues from
    them."""
    from raytracing_tpu_torch.models import inverse
    from raytracing_tpu_torch.models.whitted import render
    from raytracing_tpu_torch.utils import checkpoint as ckpt

    cfg, scene, accel, gi_accel, dev = _build(args)
    target = render(scene, cfg, accel=accel, gi_accel=gi_accel,
                    generator=_generator(dev, 0))
    params = {"colors": scene.mesh.colors * args.perturb}
    start_step, opt_state = 0, None
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        params, opt_state, start_step, _ = ckpt.load(args.checkpoint, params)
        print(f"resumed from {args.checkpoint} @ step {start_step}")

    def cb(i, loss):
        step = start_step + i
        if step % 20 == 0:
            print(f"step {step}: loss {loss:.3e}")

    _sync(dev)
    t0 = time.perf_counter()
    res = inverse.fit(
        scene, target, params, cfg, accel=accel, steps=args.steps,
        rays_per_step=args.rays_per_step, learning_rate=args.lr,
        generator=_generator(dev, args.seed), callback=cb,
        checkpoint_path=args.checkpoint,
        checkpoint_every=FIT_CHECKPOINT_EVERY if args.checkpoint else 0,
        opt_state=opt_state, start_step=start_step)
    dt = time.perf_counter() - t0  # each step's loss is read: synchronised
    print(f"fit: {args.steps} steps of {args.rays_per_step} rays in {dt:.2f} "
          f"s ({dt / args.steps * 1e3:.1f} ms a step)")
    if args.checkpoint:
        ckpt.save(args.checkpoint, res.params, res.opt_state,
                  step=start_step + args.steps)
    print(json.dumps({"final_loss": res.losses[-1],
                      "initial_loss": res.losses[0]}))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracing_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--device", default="cuda",
                        help="cuda (the default: the hand-written kernels; "
                             "in a process group, the card LOCAL_RANK, else "
                             "the rank modulo the cards), cuda:i, or cpu "
                             "(their plain PyTorch versions)")
        sp.add_argument("--width", type=int, default=800)
        sp.add_argument("--height", type=int, default=800)
        sp.add_argument("--spp", type=int, default=4)
        sp.add_argument("--backend", default="auto",
                        choices=["auto", "cuda", "pallas", "bruteforce",
                                 "cluster"],
                        help="auto and cuda: the port's kernels; pallas "
                             "names the same role (the TPU kernels these "
                             "port); bruteforce (no accel) and cluster: "
                             "plain PyTorch backends")
        sp.add_argument("--cluster-size", type=int, default=128)
        sp.add_argument("--gi-cluster-size", type=int, default=None,
                        help="build a second, coarser accel for the bounce "
                             "levels — the same image, faster incoherent "
                             "walks")
        sp.add_argument("--chunk-size", type=int, default=16384)
        sp.add_argument("--reflect-depth", type=int, default=4)
        sp.add_argument("--diffuse-depth", type=int, default=2)
        sp.add_argument("--diffuse-scatter", type=int, default=10)
        sp.add_argument("--accel-cache", default=None,
                        help="path to a .npz accel cache: load if present, "
                             "else build once and save "
                             "(accel/packets.save_accel; the JAX package's "
                             "format)")
        sp.add_argument("--obj", default=None,
                        help="OBJ path (default: bundled teapot)")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--profile", default=None,
                        help="torch.profiler logdir: a Chrome trace of the "
                             "frame is written to DIR/trace.json")
        # Multi-process rendering (`render`); explicit flags, else the
        # RTPU_COORDINATOR / RTPU_NUM_PROCESSES / RTPU_PROCESS_ID
        # variables, or --num-processes auto under torchrun.
        sp.add_argument("--coordinator", default=None,
                        help="host:port of process 0's group")
        sp.add_argument("--num-processes", default=None,
                        help="process count (or 'auto': torchrun's)")
        sp.add_argument("--process-id", type=int, default=None)
        sp.add_argument("--dist-backend", default=None,
                        choices=["nccl", "gloo"],
                        help="the group's backend: nccl on a card and "
                             "gloo on the CPU by default; gloo for "
                             "processes sharing one card")

    sp = sub.add_parser("render", help="render one frame to PNG")
    common(sp)
    sp.add_argument("--out", default="frame.png")
    sp.add_argument("--assemble", action="store_true",
                    help="multi-process: process 0 stitches every "
                         "process's shards into --out")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("animate", help="N-frame loop w/ orbiting sun + fps")
    common(sp)
    sp.add_argument("--frames", type=int, default=10)
    sp.add_argument("--out-pattern", default=None,
                    help="e.g. out/frame_{frame:03d}.png")
    sp.add_argument("--live", action="store_true",
                    help="ANSI truecolor live view in the terminal")
    sp.add_argument("--live-cols", type=int, default=100,
                    help="max terminal columns for --live")
    sp.set_defaults(fn=cmd_animate)

    sp = sub.add_parser("bench", help="headline rays/s benchmark (the card)")
    common(sp)
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("fit", help="inverse-rendering demo w/ checkpoints")
    common(sp)
    sp.add_argument("--steps", type=int, default=200)
    sp.add_argument("--rays-per-step", type=int, default=4096)
    sp.add_argument("--lr", type=float, default=1e-2)
    sp.add_argument("--perturb", type=float, default=0.5)
    sp.add_argument("--checkpoint", default=None)
    sp.add_argument("--resume", action="store_true")
    sp.set_defaults(fn=cmd_fit)
    return p


def main(argv: Optional[list] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    dev = _check_args(args)
    from raytracing_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache(dev)
    args.fn(args)
