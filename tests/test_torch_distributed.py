"""The port's multi-process layer (`parallel/distributed.py`) on gloo
groups of CPU processes: tests/test_distributed_smoke.py:26 ported to 2
processes (tests/helpers/torch_dist_worker.py), the 2-process frame and
train step against one process of 2 shards bit for bit, the shard files
against the JAX package's `assemble_shards` both ways, `initialize`'s
resolution order, `dryrun_multichip`, and the CLI's multi-process render.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracing_tpu_torch import RenderConfig, build_cluster_accel
from raytracing_tpu_torch.geometry.scene import build_default_scene
from raytracing_tpu_torch.parallel import distributed as D
from raytracing_tpu_torch.parallel import shard as S

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(HERE, "helpers"))
import torch_dist_worker as W  # noqa: E402

torch.set_num_threads(2)
SKY = (np.array([0x87, 0xCE, 0xEB]) / 255.0) ** (1 / 2.2)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    env.pop("CUDA_VISIBLE_DEVICES", None)
    for k in ("RTPU_COORDINATOR", "RTPU_NUM_PROCESSES", "RTPU_PROCESS_ID"):
        env.pop(k, None)
    env["OMP_NUM_THREADS"] = "2"
    return env


def _run_pair(argv_of, timeout=300):
    """Start two processes (argv_of(i)), wait for both; their outputs."""
    procs = [subprocess.Popen(argv_of(i), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=_env(), cwd=ROOT)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
    return outs


@pytest.fixture(scope="module")
def two_procs(tmp_path_factory):
    """The worker pair's output directory."""
    out = tmp_path_factory.mktemp("two_procs")
    port = _free_port()
    worker = os.path.join(HERE, "helpers", "torch_dist_worker.py")
    outs = _run_pair(lambda i: [sys.executable, worker, str(i), str(port),
                                str(out)])
    for o in outs:
        assert "WROTE 1" in o and "DONE" in o, o[-2000:]
    return str(out)


def test_two_process_render(two_procs):
    """tests/test_distributed_smoke.py:26: the stitched frame has the sky
    in its corner and geometry in its middle."""
    cfg = RenderConfig(**W.FRAME)
    img = D.assemble_shards(os.path.join(two_procs, "render"), cfg)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img[0, 0], SKY, atol=1e-3)
    assert np.abs(img[10] - SKY).max() > 0.05


def test_two_process_frame_equals_two_shards_in_one(two_procs):
    """2 processes of 1 shard and 1 process of 2 shards render the same
    bits: the same split (`shard_layout`) and the same draws per shard
    (`shard_generator`; the frame draws a 2-ray fan)."""
    cfg = RenderConfig(**W.FRAME)
    scene = build_default_scene(t=0.0, device="cpu")
    accel = build_cluster_accel(scene.mesh, cluster_size=16)
    mesh2 = S.make_device_mesh(2, devices=["cpu"] * 2)
    shards = S.render_shards(scene, cfg, mesh2, accel,
                             S.frame_accels(scene, cfg, accel, None)[1], 3)
    for g, start, rgb in shards:
        rec = np.load(os.path.join(two_procs, "render", f"shard_d{g}.npy"),
                      allow_pickle=True).item()
        assert rec["start"] == start
        np.testing.assert_array_equal(rec["data"], rgb.numpy())
    img = S.render_sharded(scene, cfg, mesh2, accel=accel, seed=3).numpy()
    np.testing.assert_array_equal(
        D.assemble_shards(os.path.join(two_procs, "render"), cfg), img)
    # Another seed is another image.
    other = S.render_sharded(scene, cfg, mesh2, accel=accel, seed=4).numpy()
    assert np.abs(other - img).max() > 1e-3


def test_two_process_train_step(two_procs):
    """tests/test_parallel.py:94 across processes: after each all_reduce'd
    step both ranks hold the same params bit for bit, and they equal one
    process's 2-shard steps."""
    ranks = [np.load(os.path.join(two_procs, f"step_{i}.npz"))
             for i in range(2)]
    for name in ("verts", "losses"):
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name])
    assert int(ranks[0]["all_reduce"]) == W.STEPS
    params, losses = W.train(S.make_device_mesh(2, devices=["cpu"] * 2))
    np.testing.assert_array_equal(ranks[0]["verts"], params["verts"].numpy())
    np.testing.assert_array_equal(ranks[0]["losses"], np.array(losses))
    assert losses[1] < losses[0]


def test_shard_files_interchange_with_jax(two_procs, tmp_path):
    """The port's files through JAX's `assemble_shards`, and JAX's files
    (its `render_distributed` over its 8 virtual devices, written by its
    `save_local_shards`) through the port's: the same image either way."""
    import jax
    import jax.numpy as jnp

    from raytracing_tpu.config import RenderConfig as JaxConfig
    from raytracing_tpu.geometry.mesh import Scene as JaxScene
    from raytracing_tpu.geometry.mesh import concat_objects as jax_concat
    from raytracing_tpu.parallel import distributed as JD
    from raytracing_tpu.parallel.shard import make_device_mesh

    cfg = RenderConfig(**W.FRAME)
    port_dir = os.path.join(two_procs, "render")
    np.testing.assert_array_equal(
        JD.assemble_shards(port_dir, JaxConfig(**W.FRAME)),
        D.assemble_shards(port_dir, cfg))

    ts = W.two_triangles()
    jcfg = dict(W.STEP, reflect_depth=2)
    js = JaxScene(mesh=jax_concat([{
        "verts": ts.mesh.verts.numpy(), "tri_v": ts.mesh.tri_v.numpy(),
        "colors": np.array([0.8, 0.6, 0.4], np.float32),
        "material": (1.0, 0.2, 0.5)}]), sun=jnp.asarray(ts.sun.numpy()))
    rgb = JD.render_distributed(js, JaxConfig(**jcfg),
                                mesh=make_device_mesh(8),
                                key=jax.random.PRNGKey(0))
    jax_dir = str(tmp_path / "jax")
    assert len(JD.save_local_shards(rgb, jax_dir)) == 8
    want = JD.assemble_shards(jax_dir, JaxConfig(**jcfg))
    got = D.assemble_shards(jax_dir, RenderConfig(**jcfg))
    np.testing.assert_array_equal(got, want)
    # ... and that image is the port's sharded frame of the same scene.
    mine = S.render_sharded(ts, RenderConfig(**jcfg),
                            S.make_device_mesh(8, devices=["cpu"] * 8))
    np.testing.assert_allclose(got, mine.numpy(), atol=1e-5)


def test_initialize_resolution_order(monkeypatch):
    """Explicit arguments, then RTPU_*; "auto" reads torchrun's variables;
    at most 1 process it is a no-op; gloo on a CPU-only machine, and an
    explicit backend passes through."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k in ("RTPU_COORDINATOR", "RTPU_NUM_PROCESSES", "RTPU_PROCESS_ID",
              "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert D.initialize() is False
    assert D.initialize("h:1", 1, 0) is False
    monkeypatch.setenv("RTPU_NUM_PROCESSES", "1")
    assert D.initialize() is False
    assert calls == []

    monkeypatch.setenv("RTPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("RTPU_PROCESS_ID", "1")
    monkeypatch.setenv("RTPU_COORDINATOR", "envhost:7")
    assert D.initialize() is True
    assert calls[-1] == ("gloo", dict(init_method="tcp://envhost:7",
                                      world_size=2, rank=1))
    assert D.initialize("arg:9", 4, 3, backend="nccl") is True
    assert calls[-1] == ("nccl", dict(init_method="tcp://arg:9",
                                      world_size=4, rank=3))
    assert D.initialize(num_processes=1) is False  # explicit beats the env

    monkeypatch.setenv("RTPU_NUM_PROCESSES", "auto")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("MASTER_ADDR", "m")
    monkeypatch.setenv("MASTER_PORT", "5")
    assert D.initialize() is True
    assert calls[-1] == ("gloo", dict(init_method="tcp://m:5", world_size=3,
                                      rank=2))
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert D.initialize() is False

    monkeypatch.delenv("RTPU_COORDINATOR")
    with pytest.raises(ValueError, match="coordinator"):
        D.initialize(num_processes=2, process_id=0)
    assert len(calls) == 3
    D._LOCAL_DEVICE_IDS[0] = None


def test_global_ray_mesh_without_a_group():
    """One process, no group: rank 0 of 1 over the named devices."""
    m = D.global_ray_mesh(devices=["cpu", "cpu"])
    assert (m.process_index, m.process_count, m.n_shards) == (0, 1, 2)


def test_dryrun_multichip():
    """`dryrun_multichip(2)` over 2 virtual CPU shards: one Adam step of
    the bumpy grid at CS 8 with its rest set, finite loss and params."""
    from raytracing_tpu_torch.parallel.dryrun import dryrun_multichip, entry

    loss = dryrun_multichip(2, device="cpu")
    assert np.isfinite(loss) and loss > 0
    fn, args = entry(device="cpu", width=8, height=8, chunk=64)
    rgb = fn(*args)
    assert rgb.shape == (64, 3) and bool(torch.isfinite(rgb).all())


def test_cli_render_two_processes(tmp_path):
    """`render --device cpu --num-processes 2 ... --assemble`: process 0
    writes the PNG of the stitched frame, which is the one-process 2-shard
    frame in u8, bit for bit."""
    from raytracing_tpu_torch.ops.color import to_rgba_frame
    from raytracing_tpu_torch.utils.image import read_png

    out = str(tmp_path / "f.png")
    port = _free_port()
    flags = ["--device", "cpu", "--width", "24", "--height", "24", "--spp",
             "1", "--diffuse-scatter", "2", "--cluster-size", "16",
             "--seed", "2"]
    outs = _run_pair(lambda i: [
        sys.executable, "-m", "raytracing_tpu_torch", "render", *flags,
        "--num-processes", "2", "--process-id", str(i), "--coordinator",
        f"localhost:{port}", "--assemble", "--out", out])
    assert f"wrote {out}" in outs[0] and f"wrote {out}" not in outs[1]
    assert "process 1 of 2, shards [1]" in outs[1]
    scene = build_default_scene(t=0.0, device="cpu")
    cfg = RenderConfig(width=24, height=24, samples_per_pixel=1,
                       diffuse_scatter=2, chunk_size=16384)
    img = S.render_sharded(scene, cfg,
                           S.make_device_mesh(2, devices=["cpu"] * 2),
                           accel=build_cluster_accel(scene.mesh,
                                                     cluster_size=16),
                           seed=2)
    np.testing.assert_array_equal(read_png(out), to_rgba_frame(img))
