"""The port's command line (`python -m raytracing_tpu_torch`) on the CPU
(`--device cpu`: the kernels' plain versions), against the JAX package's
CLI where both run: tests/test_utils_app.py's CLI tests, the refusals of
what the port does not do, checkpoint and resume, the accel cache, the
frame loop, the benchmark's code paths, and the entry points' default
device.

Bars: the CLI frame within one u8 count of JAX's `render --backend
pallas` at the same flags (a config that draws no uniforms, so both see
the same rays; the intersectors differ in the last f32 bits), and equal
bit for bit to `to_u8` of `render()` called with the same seed; the
mid-fit checkpoint equal bit for bit to the live params of a fit stopped
there."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracing_tpu.app import build_parser as jax_parser

from raytracing_tpu_torch import app, bench
from raytracing_tpu_torch.models import camera as TC
from raytracing_tpu_torch.utils import checkpoint as ckpt
from raytracing_tpu_torch.utils.image import read_png

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--width", "24", "--height", "24", "--spp", "1",
         "--diffuse-depth", "0", "--cluster-size", "16"]


def _run_port(argv, capsys):
    app.main(argv)
    return capsys.readouterr().out


def test_help_exits_0_and_main_module_runs_nothing_on_import():
    out = subprocess.run([sys.executable, "-m", "raytracing_tpu_torch",
                          "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert all(c in out.stdout for c in ("render", "animate", "bench", "fit"))
    imp = subprocess.run([sys.executable, "-c",
                          "import raytracing_tpu_torch.__main__ as m; "
                          "print('imported', callable(m.main))"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert imp.returncode == 0, imp.stderr
    assert imp.stdout == "imported True\n"


def test_cli_render_matches_jax_pallas_cli(tmp_path, capsys):
    """The parity frame: the port's CLI on the CPU against JAX's
    CLI with its Pallas kernels (interpret mode) at the same flags."""
    ours, theirs = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    out = _run_port(["render", *SMALL, "--out", ours], capsys)
    assert "devices: 1 x cpu" in out and "triangles: 12642" in out
    assert "frame: " in out and f"wrote {ours}" in out
    args = jax_parser().parse_args(
        ["render", *SMALL[2:], "--backend", "pallas", "--out", theirs])
    args.fn(args)
    a = read_png(ours).astype(np.int16)
    b = read_png(theirs).astype(np.int16)
    assert a.shape == b.shape == (24, 24, 4)
    diff = np.abs(a - b)
    assert diff.max() <= 1, (diff.max(), (diff > 0).sum())
    # The file holds what render() gives for the same seed, bit for bit.
    from raytracing_tpu_torch import RenderConfig, build_cluster_accel
    from raytracing_tpu_torch.geometry.scene import build_default_scene
    from raytracing_tpu_torch.models.whitted import render
    from raytracing_tpu_torch.ops.color import to_rgba_frame

    scene = build_default_scene(device="cpu")
    img = render(scene, RenderConfig(width=24, height=24,
                                     samples_per_pixel=1, diffuse_depth=0,
                                     chunk_size=16384),
                 accel=build_cluster_accel(scene.mesh, cluster_size=16),
                 generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(read_png(ours), to_rgba_frame(img))


@pytest.mark.parametrize("argv,msg", [
    (["render", *SMALL, "--reflect-depth", "1", "--backend", "cluster"],
     "accel: 790 clusters of 16"),
    (["render", *SMALL, "--reflect-depth", "1", "--backend", "bruteforce"],
     "accel: none"),
    (["render", *SMALL, "--coordinator", "localhost:1234"], "frame: "),
    (["render", *SMALL, "--assemble"], "frame: "),
    (["fit", *SMALL, "--num-processes", "2", "--steps", "2",
      "--rays-per-step", "16"], "fit: 2 steps"),
    (["bench"], "bench measures the card"),
], ids=["argv0-Queue 1 item 5", "argv1-Queue 1 item 5",
        "argv2-Queue 1 item 4", "argv3-Queue 1 item 4",
        "argv4-Queue 1 item 4", "argv5-bench measures the card"])
def test_cli_refuses_what_the_port_does_not_do(argv, msg, tmp_path, capsys):
    """The CLI refuses only what the port does not do: the benchmark
    without a card. The plain backends and the JAX CLI's multi-process
    flags run (without a process count the flags render in one process,
    and `fit` ignores them, as the JAX CLI does); the rendered frame of a
    backend is `render()`'s under it. (The ids are those of the refusals
    these cases were before the port had the backends and the flags.)"""
    if argv == ["bench"]:
        with pytest.raises(SystemExit) as ei:
            app.main(argv + ["--device", "cpu"])
        assert msg in str(ei.value.code)
        return
    png = str(tmp_path / "f.png")
    out = _run_port(argv + (["--out", png] if argv[0] == "render" else []),
                    capsys)
    assert msg in out
    if "--backend" not in argv:
        return
    from raytracing_tpu_torch import RenderConfig, build_cluster_accel
    from raytracing_tpu_torch.geometry.scene import build_default_scene
    from raytracing_tpu_torch.models.whitted import render
    from raytracing_tpu_torch.ops.color import to_rgba_frame

    backend = argv[argv.index("--backend") + 1]
    scene = build_default_scene(device="cpu")
    img = render(scene, RenderConfig(width=24, height=24,
                                     samples_per_pixel=1, diffuse_depth=0,
                                     reflect_depth=1, chunk_size=16384,
                                     backend=backend),
                 accel=(build_cluster_accel(scene.mesh, cluster_size=16)
                        if backend == "cluster" else None),
                 generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(read_png(png), to_rgba_frame(img))


def test_bench_has_no_suite(capsys):
    """`bench` is the JAX CLI's headline alone: `--suite` is refused by the
    argument parser."""
    with pytest.raises(SystemExit) as ei:
        app.main(["bench", "--suite"])
    assert ei.value.code == 2
    assert "unrecognized arguments: --suite" in capsys.readouterr().err


def test_cli_without_a_card_fails_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("there is a card here: the default device works")
    for cmd in ("render", "animate", "bench", "fit"):
        with pytest.raises(SystemExit) as ei:
            app.main([cmd])
        assert "--device cpu" in str(ei.value.code)


def test_cli_render_accel_cache(tmp_path, capsys):
    """--accel-cache builds and saves once, then loads; the two frames are
    the same bits; a cache of another cluster size is refused."""
    cache = str(tmp_path / "accel.npz")
    pngs = []
    for i in range(2):
        pngs.append(str(tmp_path / f"f{i}.png"))
        out = _run_port(["render", *SMALL, "--accel-cache", cache, "--out",
                         pngs[-1]], capsys)
        assert ("built" if i == 0 else "loaded from") in out
    np.testing.assert_array_equal(read_png(pngs[0]), read_png(pngs[1]))
    with pytest.raises(ValueError, match="cluster_size"):
        app.main(["render", *SMALL[:-1], "64", "--accel-cache", cache])


def test_cli_fit_with_checkpoint_and_resume(tmp_path, capsys):
    """tests/test_utils_app.py:74, then --resume: params, Adam's state and
    the step continue from the checkpoint."""
    ck = str(tmp_path / "fit.npz")
    flags = ["--device", "cpu", "--width", "12", "--height", "12", "--spp",
             "1", "--chunk-size", "144", "--rays-per-step", "32",
             "--diffuse-depth", "1", "--reflect-depth", "1",
             "--checkpoint", ck]
    out = _run_port(["fit", *flags, "--steps", "5"], capsys)
    first = json.loads(out.strip().splitlines()[-1])
    like = {"colors": torch.zeros((12642, 3))}
    params5, opt5, step, _ = ckpt.load(ck, like)
    assert step == 5 and float(opt5["state"][0]["step"]) == 5
    out = _run_port(["fit", *flags, "--steps", "3", "--resume"], capsys)
    assert f"resumed from {ck} @ step 5" in out
    last = json.loads(out.strip().splitlines()[-1])
    params8, opt8, step, _ = ckpt.load(ck, like)
    assert step == 8 and float(opt8["state"][0]["step"]) == 8
    assert not torch.equal(params8["colors"], params5["colors"])
    for rec in (first, last):
        assert set(rec) == {"final_loss", "initial_loss"}
        assert all(np.isfinite(v) for v in rec.values())


def test_cli_mid_fit_checkpoint_holds_the_live_params(tmp_path, capsys,
                                                      monkeypatch):
    """The JAX CLI's mid-fit snapshot stores the starting params
    (app.py:233-240); the port's stores the step's own. With the snapshot
    every 3 steps (the CLI's is every 50), the step-3 snapshot of a 5-step
    fit equals the end of a 3-step fit."""
    flags = ["--device", "cpu", "--width", "8", "--height", "8", "--spp",
             "1", "--rays-per-step", "16", "--diffuse-depth", "0",
             "--reflect-depth", "1"]
    monkeypatch.setattr(app, "FIT_CHECKPOINT_EVERY", 3)
    saved = []
    real = ckpt.save

    def spy(path, params, opt_state=None, step=0, metadata=None):
        saved.append((step, {k: v.clone() for k, v in params.items()}))
        real(path, params, opt_state, step, metadata)

    monkeypatch.setattr(ckpt, "save", spy)
    _run_port(["fit", *flags, "--steps", "3", "--checkpoint",
               str(tmp_path / "a.npz")], capsys)
    live3 = saved[-1]
    saved.clear()
    _run_port(["fit", *flags, "--steps", "5", "--checkpoint",
               str(tmp_path / "b.npz")], capsys)
    assert [s for s, _ in saved] == [3, 5] and live3[0] == 3
    assert torch.equal(saved[0][1]["colors"], live3[1]["colors"])
    assert not torch.equal(saved[0][1]["colors"], saved[1][1]["colors"])


def test_cli_animate_writes_frames(tmp_path, capsys):
    pattern = str(tmp_path / "frame_{frame:03d}.png")
    out = _run_port(["animate", "--device", "cpu", "--width", "16",
                     "--height", "16", "--spp", "1", "--diffuse-depth", "0",
                     "--reflect-depth", "1", "--cluster-size", "16",
                     "--frames", "3", "--out-pattern", pattern, "--live",
                     "--live-cols", "8"], capsys)
    frames = [pattern.format(frame=i) for i in range(3)]
    assert all(os.path.exists(f) for f in frames)
    assert read_png(frames[0]).shape == (16, 16, 4)
    assert "rendered 3 frames in" in out and "fps avg" in out
    assert out.count("\x1b[2J") == 1 and "frame 2" in out


def test_entry_points_default_to_the_card(monkeypatch):
    """camera_rays and block_ray_ids ask for the card unless told
    otherwise; where there is none, the call raises for that reason."""
    from raytracing_tpu_torch import RenderConfig

    cfg = RenderConfig(width=16, height=16, samples_per_pixel=1)
    asked = []
    real = torch.arange

    def spy(*a, **kw):
        asked.append(str(kw.get("device")))
        return real(*a, **{**kw, "device": "cpu"})

    monkeypatch.setattr(TC.torch, "arange", spy)
    TC.camera_rays(cfg)
    TC.block_ray_ids(0, 256, cfg)
    assert asked == ["cuda", "cuda"]
    monkeypatch.undo()
    o, _ = TC.camera_rays(cfg, device="cpu")
    assert o.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            TC.camera_rays(cfg)


def test_bench_code_paths_on_the_cpu():
    """The benchmark's measuring code on CPU tensors at a small size (no
    record: the records are the card's): the headline's rate and hit
    fraction, and no benchmark without a card."""
    from raytracing_tpu_torch import build_cluster_accel
    from raytracing_tpu_torch.geometry.scene import build_default_scene

    scene = build_default_scene(device="cpu")
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    rate, frac = bench.camera_rate(accel, 32, 32, 1, 1)
    assert rate > 0 and 0.2 < frac < 0.9
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            bench.measure()


def test_queries_counted_at_the_query_entry_points():
    """`utils.profiling.COUNTERS` counts the lanes submitted to every
    nearest and shadow query (`rays.nearest`, `rays.shadow`, always) and
    the alive ones (`alive.nearest`, `alive.shadow`) while
    `counting(True)`, no alive lane while off, and resets with the
    launches."""
    from raytracing_tpu_torch import RenderConfig, build_cluster_accel
    from raytracing_tpu_torch.geometry.scene import build_default_scene
    from raytracing_tpu_torch.kernels import traverse as T
    from raytracing_tpu_torch.models.camera import camera_rays
    from raytracing_tpu_torch.ops.sampling import stratified_offsets
    from raytracing_tpu_torch.utils.profiling import COUNTERS, counting

    scene = build_default_scene(device="cpu")
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    cfg = RenderConfig(width=16, height=16, samples_per_pixel=1)
    o, d = (x.reshape(-1, 3) for x in camera_rays(cfg, device="cpu"))
    alive = torch.arange(o.shape[0]) % 3 != 0

    def queries():
        T.nearest_hit_shaded(scene.mesh, accel, o, d, alive=alive)
        T.nearest_hit(scene.mesh, accel, o, d)
        T.any_hit(accel, o, d, alive=alive)
        T.nearest_hit_shaded_camera(accel, stratified_offsets(1), width=16,
                                    height=16, spp=1, tile_base=0, tiles=1)

    def lanes():
        return {k: v for k, v in COUNTERS.read().items()
                if k.split(".")[0] in ("rays", "alive")}

    n, a = o.shape[0], int(alive.sum())
    COUNTERS.reset()
    assert not counting(False)
    queries()
    assert lanes() == {"rays.nearest": 3 * n, "rays.shadow": n}
    COUNTERS.reset()
    counting(True)
    try:
        queries()
        got = lanes()
    finally:
        assert counting(False)
    assert got == {"rays.nearest": 3 * n, "rays.shadow": n,
                   "alive.nearest": 2 * n + a, "alive.shadow": a}
    T.LAUNCHES["walk"] += 1
    COUNTERS.reset()
    assert lanes() == {} and not any(T.LAUNCHES.values())


@pytest.mark.parametrize("device,local_rank,want", [
    ("cuda", None, "cuda:3"),    # rank 7 of a host with 4 cards
    ("cuda", "1", "cuda:1"),     # torchrun's LOCAL_RANK
    ("cuda:2", None, "cuda:2"),  # a named card stays
])
def test_group_render_spreads_its_processes_over_the_cards(
        device, local_rank, want, monkeypatch):
    """In a process group, `--device cuda` becomes this process's card
    (LOCAL_RANK, else the rank modulo the cards) and is made current, so
    that the ranks of a host do not all land on card 0 (NCCL refuses two
    ranks on one card). torch.cuda and the group are stood in for, so
    this runs without a card."""
    from raytracing_tpu_torch.parallel import distributed as D

    current = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(D, "initialize", lambda **kw: True)
    monkeypatch.setattr(D, "process_index", lambda: 7)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    args = app.build_parser().parse_args(
        ["render", "--device", device, "--num-processes", "8"])
    assert app._maybe_init_distributed(args)
    assert args.device == want
    assert current == ([] if device == "cuda:2" else [int(want[-1])])
