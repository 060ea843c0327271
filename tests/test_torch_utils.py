"""The port's utils against the JAX package's on the same inputs: u8
quantization and the RGBA frame, the raw PNG bytes, the terminal view, the
accel cache in both directions, and the port's own timing, profiling and
build-ahead helpers.

Bars: u8 values, RGBA frames, PNG bytes and ANSI strings equal bit for bit
(string for string); a cache written by either package loads in the other
with every shared field equal."""

import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu.accel import packets as JP
from raytracing_tpu.geometry.scene import build_default_scene as jax_scene
from raytracing_tpu.ops import color as JCOL
from raytracing_tpu.utils import image as JIMG
from raytracing_tpu.utils import term_view as JTV

from raytracing_tpu_torch.accel import packets as TP
from raytracing_tpu_torch.geometry.scene import build_default_scene
from raytracing_tpu_torch.ops import color as TCOL
from raytracing_tpu_torch.utils import image as TIMG
from raytracing_tpu_torch.utils import term_view as TTV
from raytracing_tpu_torch.utils.profiling import (RateMeter, device_summary,
                                                  profile_trace, timed)

torch.set_num_threads(2)

# tests/test_sampling_color.py:59's [0.5, 1.5, -0.1], extended by NaN, a
# value just under 1, the infinities and huge values.
U8_INPUTS = np.array([[0.5, 1.5, -0.1], [np.nan, 0.9999, 1.0],
                      [np.inf, -np.inf, 1e30], [-1e30, 0.0, 254.9 / 255]],
                     np.float32)


@pytest.fixture(scope="module")
def scenes():
    js = jax_scene(t=0.0)
    ts = build_default_scene(t=0.0, device="cpu")
    return js, ts


@pytest.fixture(scope="module")
def accels(scenes):
    js, ts = scenes
    return (JP.build_cluster_accel(js.mesh, cluster_size=16),
            TP.build_cluster_accel(ts.mesh, cluster_size=16))


def test_gamma_and_u8():
    """tests/test_sampling_color.py:59 on both packages: bit for bit,
    negatives and NaN to 0 (a plain cast wraps -25.5 to 231)."""
    rgb = np.array([[0.0, 0.25, 4.0]], np.float32)
    g = TCOL.gamma_correct(torch.from_numpy(rgb), 2.2).numpy()
    np.testing.assert_array_equal(
        g, np.asarray(JCOL.gamma_correct(jnp.asarray(rgb), 2.2)))
    u = TCOL.to_u8(torch.from_numpy(U8_INPUTS))
    assert u.dtype == torch.uint8
    want = np.asarray(JCOL.to_u8(jnp.asarray(U8_INPUTS)))
    np.testing.assert_array_equal(u.numpy(), want)
    assert u[0].tolist() == [127, 255, 0] and u[1, 0] == 0
    frame = TCOL.to_rgba_frame(torch.ones((2, 2, 3)) * 0.5)
    assert frame.shape == (2, 2, 4) and (frame[..., 3] == 0xFF).all()
    img = np.random.default_rng(0).uniform(-0.2, 1.3, (5, 7, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(TCOL.to_rgba_frame(img),
                                  JCOL.to_rgba_frame(jnp.asarray(img)))


def test_png_raw_writer_bytes_equal_jax(tmp_path):
    """tests/test_utils_app.py:57: the raw encoder's file is JAX's byte for
    byte, and both readers give the frame back."""
    img = np.random.default_rng(0).uniform(size=(16, 16, 3)).astype(
        np.float32)
    rgba = TCOL.to_rgba_frame(img)
    ours, theirs = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    TIMG._write_png_raw(ours, rgba)
    JIMG._write_png_raw(theirs, rgba)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(TIMG._read_png_raw(ours), rgba)
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(ours)), rgba)


def test_png_readers_and_npy(tmp_path):
    """write_png goes through PIL where it is installed (decoded alike by
    read_png); the raw reader refuses what it does not decode; write_npy
    keeps the float frame."""
    img = torch.rand((9, 6, 3), generator=torch.Generator().manual_seed(1))
    p = str(tmp_path / "f.png")
    TIMG.write_png(p, img)
    np.testing.assert_array_equal(TIMG.read_png(p), TCOL.to_rgba_frame(img))
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        TIMG._read_png_raw(bad)
    n = str(tmp_path / "f.npy")
    TIMG.write_npy(n, img)
    np.testing.assert_array_equal(np.load(n), img.numpy())


def _ansi_pair(img):
    return TTV.frame_to_ansi(img), JTV.frame_to_ansi(img)


def test_frame_to_ansi_shape_and_colors():
    img = np.zeros((4, 3, 3), dtype=np.float32)
    img[0:2] = [1.0, 0.0, 0.0]
    img[2:4] = [0.0, 0.0, 1.0]
    s, j = _ansi_pair(img)
    assert s == j
    lines = s.split("\n")
    assert len(lines) == 2
    assert "38;2;255;0;0" in lines[0] and "48;2;255;0;0" in lines[0]
    assert "38;2;0;0;255" in lines[1] and "48;2;0;0;255" in lines[1]
    assert lines[0].endswith("\x1b[0m")
    assert TTV.frame_to_ansi(torch.from_numpy(img)) == j


def test_frame_to_ansi_downsamples_to_max_cols():
    img = np.random.default_rng(0).random((8, 64, 3)).astype(np.float32)
    s = TTV.frame_to_ansi(img, max_cols=16)
    assert s == JTV.frame_to_ansi(img, max_cols=16)
    assert s.split("\n")[0].count("▀") <= 16


def test_frame_to_ansi_accepts_uint8():
    img = np.full((2, 2, 3), 128, dtype=np.uint8)
    s, j = _ansi_pair(img)
    assert s == j and "38;2;128;128;128" in s


def test_viewer_homes_cursor_after_first_frame():
    outs = []
    for viewer in (TTV.TermViewer, JTV.TermViewer):
        buf = io.StringIO()
        v = viewer(max_cols=8, stream=buf)
        img = np.zeros((2, 2, 3), dtype=np.float32)
        v.show(img, status="f0")
        v.show(img, status="f1")
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].count("\x1b[2J") == 1 and outs[0].count("\x1b[H") == 2
    assert "f1" in outs[0]


def test_rate_meter():
    m = RateMeter("x", interval=0.0)
    out = []
    r = m.tick(10, emit=lambda s: out.append(s))
    assert r is not None and out and out[0].startswith("x:")


def test_timed_and_device_summary():
    with timed("op", sync=True) as t:
        _ = torch.ones((8, 8)).sum()
    assert t["seconds"] >= 0
    assert "cpu" in device_summary("cpu")


def test_device_summary_names_the_card(monkeypatch):
    """A card's line carries its count, name and power limit as nvidia-smi
    gives it, and says "unknown" where nvidia-smi does not answer."""
    from raytracing_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(profiling.torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    answers = {"ok": "700.00 W\n", "none": None}

    def run(cmd, **kw):
        if answers["now"] is None:
            raise FileNotFoundError("nvidia-smi")
        assert "--query-gpu=power.limit" in cmd
        return profiling.subprocess.CompletedProcess(cmd, 0, answers["now"],
                                                     "")

    monkeypatch.setattr(profiling.subprocess, "run", run)
    answers["now"] = answers["ok"]
    assert device_summary("cuda") == \
        "1 x NVIDIA H100 80GB HBM3, 700.00 W (cuda)"
    answers["now"] = answers["none"]
    assert device_summary("cuda") == \
        "1 x NVIDIA H100 80GB HBM3, power limit unknown (cuda)"


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "prof")):
        torch.ones((64, 64)).matmul(torch.ones((64, 64)))
    with open(tmp_path / "prof" / "trace.json") as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    with profile_trace(None):
        pass  # no logdir: a no-op


def test_chain_bench_threads_the_state():
    from raytracing_tpu_torch.utils.timing import chain_bench

    seen = []

    def fn(s, k):
        seen.append(int(s))
        return s + k

    ms = chain_bench(fn, torch.zeros(()), torch.ones(()), iters=4, trials=2)
    assert ms >= 0 and seen == [0] + [1, 2, 3, 4] * 2


def test_enable_persistent_cache_builds_nothing_for_the_cpu(monkeypatch):
    from raytracing_tpu_torch.kernels import cuda
    from raytracing_tpu_torch.utils.cache import enable_persistent_cache

    monkeypatch.setattr(cuda, "library", lambda: pytest.fail("built"))
    assert enable_persistent_cache("cpu") == cuda.BUILD_DIR
    monkeypatch.setattr(cuda, "library", lambda: None)
    assert enable_persistent_cache("cuda") == cuda.BUILD_DIR


def test_mesh_fingerprint_is_jax_fingerprint(scenes):
    js, ts = scenes
    np.testing.assert_array_equal(TP._mesh_fingerprint(ts.mesh),
                                  JP._mesh_fingerprint(js.mesh))


def test_jax_written_cache_loads_in_the_port(tmp_path, scenes, accels):
    """A JAX-written cache loads in the port (its five TPU-only tables
    ignored), equal field for field to `accel_from_numpy` of the same
    accel, and validates against the port's mesh."""
    js, ts = scenes
    ja, _ = accels
    p = str(tmp_path / "jax.npz")
    JP.save_accel(p, ja, mesh=js.mesh)
    got = TP.load_accel(p, mesh=ts.mesh, cluster_size=16, device="cpu")
    want = TP.accel_from_numpy({k: np.asarray(v) for k, v in
                                ja._asdict().items() if v is not None},
                               device="cpu")
    for name in TP.ClusterAccel._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), name


def test_port_written_cache_loads_in_jax(tmp_path, scenes, accels):
    """tests/test_utils_app.py:89 across packages: the port's cache
    round-trips in the port bit for bit and loads in JAX's load_accel,
    every shared field equal to JAX's own build."""
    js, ts = scenes
    ja, ta = accels
    p = str(tmp_path / "port.npz")
    TP.save_accel(p, ta, mesh=ts.mesh)
    back = TP.load_accel(p, device="cpu")
    for name in TP.ClusterAccel._fields:
        a, b = getattr(ta, name), getattr(back, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    jb = JP.load_accel(p, mesh=js.mesh, cluster_size=16)
    for name in TP.ClusterAccel._fields:
        a, b = getattr(ja, name), getattr(jb, name)
        if a is None:
            assert b is None, name
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                          err_msg=name)
    for name in ("tri_blocks", "pmt_t_blocks", "woop_blocks",
                 "order_blocks", "attr_t_blocks"):
        assert getattr(jb, name) is None


def test_accel_cache_rejects_wrong_files(tmp_path, scenes, accels):
    """tests/test_utils_app.py:89,118: a wrong version, a foreign .npz, a
    missing field, another mesh and another cluster size raise
    ValueError."""
    _, ts = scenes
    _, ta = accels
    p = str(tmp_path / "accel.npz")
    TP.save_accel(p, ta, mesh=ts.mesh)
    TP.load_accel(p, mesh=ts.mesh, cluster_size=16, device="cpu")
    with pytest.raises(ValueError, match="cluster_size"):
        TP.load_accel(p, mesh=ts.mesh, cluster_size=64, device="cpu")
    moved = ts.mesh._replace(verts=ts.mesh.verts + 0.5)
    with pytest.raises(ValueError, match="fingerprint"):
        TP.load_accel(p, mesh=moved, device="cpu")
    np.savez(str(tmp_path / "bad.npz"), _version=np.int64(999))
    with pytest.raises(ValueError, match="format v999"):
        TP.load_accel(str(tmp_path / "bad.npz"), device="cpu")
    np.savez(str(tmp_path / "foreign.npz"), something=np.arange(3))
    with pytest.raises(ValueError, match="_version"):
        TP.load_accel(str(tmp_path / "foreign.npz"), device="cpu")
    np.savez(str(tmp_path / "part.npz"), _version=np.int64(2),
             order=np.zeros(16, np.int32))
    with pytest.raises(ValueError, match="missing"):
        TP.load_accel(str(tmp_path / "part.npz"), device="cpu")
    TP.save_accel(str(tmp_path / "nofp.npz"), ta)
    with pytest.raises(ValueError, match="no mesh fingerprint"):
        TP.load_accel(str(tmp_path / "nofp.npz"), mesh=ts.mesh,
                      device="cpu")
    assert not os.path.exists(p + ".tmp")
