"""The PyTorch port's package boundary: it never imports jax, its config
matches the JAX package's, and a kernel that cannot build raises."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from raytracing_tpu.config import RenderConfig as JaxConfig
from raytracing_tpu_torch.config import RenderConfig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_package_never_imports_jax():
    """Importing every module of the port loads neither jax nor the JAX
    package, and builds nothing."""
    code = (
        "import importlib, pkgutil, sys, raytracing_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'raytracing_tpu.'))]\n"
        "print(len(bad), bad[:5])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout


def test_config_fields_and_defaults_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(RenderConfig)}
    assert list(jf) == list(tf)
    for name, default in jf.items():
        if name != "backend":
            assert tf[name] == default, name
    assert tf["backend"] == "auto"
    # One dict builds both configs (the port names its own backend).
    kw = dataclasses.asdict(JaxConfig(width=64, gi_wq=False))
    kw["backend"] = "cuda"
    assert RenderConfig(**kw).gi_wq is False
    assert RenderConfig().spp_grid == JaxConfig().spp_grid == (2, 2)


@pytest.mark.parametrize("backend", ["pallas", "cluster", "bruteforce"])
def test_unported_backend_raises(backend):
    """The JAX package's backends are all the port's now ("pallas" names
    the kernel path); a name that is no backend of either raises."""
    assert RenderConfig(backend=backend).backend == backend
    with pytest.raises(ValueError, match="unknown backend"):
        RenderConfig(backend=backend + "_x")


def test_kernel_build_without_nvcc_raises(monkeypatch):
    """No fallback hides a missing toolchain: building raises."""
    from raytracing_tpu_torch.kernels import cuda

    monkeypatch.setattr(cuda.shutil, "which", lambda _: None)
    monkeypatch.setattr(cuda.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda.build()


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; tensors on any
    other device are refused, never silently moved."""
    from raytracing_tpu_torch.kernels import traverse as T

    with pytest.raises(ValueError, match="meta"):
        T.tile_extents(torch.empty((8, 1024), device="meta"))
    meta = torch.empty((1, 4), dtype=torch.int32, device="meta")
    box = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="meta"):
        T.refine_lists(torch.empty((8, 1024), device="meta"), meta,
                       meta[:, 0], box, box)
    with pytest.raises(ValueError, match="cpu.*meta|meta.*cpu"):
        T.walk_camera(torch.zeros((1, 2)), T.Camera(16, 16, 1, 1.0, 16, 16),
                      0, 1, meta, meta[:, 0], box, None, 0, 4, 1e-8)


def test_new_walk_wrappers_refuse_other_devices():
    """The streamed-groups and work-queue wrappers, and a per-ray limit on
    another device than the pack, are refused like the rest."""
    from raytracing_tpu_torch.kernels import traverse as T

    pack = torch.zeros((8, 1024))
    ids = torch.zeros((1, 4), dtype=torch.int32)
    cnt = torch.zeros(1, dtype=torch.int32)
    geo = torch.zeros((4, 12, 16))
    meta = torch.empty((4, 12, 16), device="meta")
    with pytest.raises(ValueError, match="cpu.*meta|meta.*cpu"):
        T.walk_wq(pack, ids, cnt, meta, None, 0, 16, 1e-8, True)
    with pytest.raises(ValueError, match="cpu.*meta|meta.*cpu"):
        T.walk_gstream(pack, ids[None], cnt[None], meta, None, 0, 16, 4,
                       1e-8, True)
    with pytest.raises(ValueError, match="cpu.*meta|meta.*cpu"):
        T.walk(pack, ids, cnt, geo, None, 0, 16, 1e-8, False,
               tmax_row=torch.empty((1, 1024), device="meta"))


def test_lights_go_where_the_scene_goes(monkeypatch):
    """`scene_from_numpy` sends a scene's lights to the card with the rest
    unless `device=` says otherwise, and `Scene.to` moves them."""
    import numpy as np

    from raytracing_tpu_torch.geometry.mesh import (Mesh, Scene, SphereLight,
                                                    scene_from_numpy)

    arrays = {f: np.zeros((1, 3), np.float32) for f in Mesh._fields}
    arrays["sun"] = np.zeros(3, np.float32)
    arrays["lights"] = dict(center=np.zeros((1, 3)), radius=np.ones(1),
                            emission=np.ones((1, 3)))
    asked = []
    monkeypatch.setattr(Scene, "to",
                        lambda self, device: asked.append(str(device)) or self)
    scene = scene_from_numpy(arrays)
    assert asked == ["cuda"] and isinstance(scene.lights, SphereLight)
    monkeypatch.undo()
    moved = []
    monkeypatch.setattr(SphereLight, "to",
                        lambda self, device: moved.append(str(device)) or self)
    scene_from_numpy(arrays, device="cpu")
    assert moved == ["cpu"]


class _CardPack:
    """A stand-in for a CUDA ray pack on card 1 (this machine may have no
    card): what `tile_extents` reads of its tensor before the launch."""

    device = torch.device("cuda", 1)
    dtype = torch.float32
    shape = (8, 2048)

    def dim(self):
        return 2

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 4096


def test_launch_binds_its_tensors_card(monkeypatch):
    """A wrapper launches under `torch.cuda.device(t.device)` on
    `torch.cuda.current_stream(t.device)`: the stream of the launched
    tensors' card, not of the current card (a tensor on cuda:1 while cuda:0
    is current). torch.cuda is stood in for, so this runs without a card;
    every launch site of kernels/traverse.py has the same form."""
    import ctypes
    import inspect
    import re

    from raytracing_tpu_torch.kernels import cuda
    from raytracing_tpu_torch.kernels import traverse as T

    seen = []

    class Stream:
        cuda_stream = 77

    class Device:
        def __init__(self, d):
            self.d = d

        def __enter__(self):
            seen.append(("device", self.d))

        def __exit__(self, *exc):
            seen.append(("exit", self.d))

    class Lib:
        def rt_tile_extents(self, *args):
            seen.append(("launch", args[-1].value))
            return 0

    def current_stream(device=None):
        seen.append(("stream", device))
        return Stream()

    real_empty = torch.empty
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(cuda, "library", lambda: Lib())
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k:
                        real_empty(*a, **k))
    before = T.LAUNCHES["extents"]
    T.tile_extents(_CardPack())
    card = torch.device("cuda", 1)
    assert seen == [("device", card), ("stream", card), ("launch", 77),
                    ("exit", card)]
    assert T.LAUNCHES["extents"] == before + 1
    assert isinstance(T._stream(_CardPack()), ctypes.c_void_p)
    # Every launch: under the device of the tensor whose stream it takes.
    src = inspect.getsource(T)
    sites = re.findall(r"with torch\.cuda\.device\((\w+)\.device\):\n"
                       r"\s+cuda\.check\(lib\.rt_\w+\((?:[^()]|\([^()]*\))*"
                       r"_stream\((\w+)\)\)", src)
    assert len(sites) == src.count("cuda.check(lib.rt_") == 13
    assert all(a == b for a, b in sites), sites
    assert "_stream()" not in src


def test_one_launch_takes_one_cards_tensors():
    """Tensors of two cards in one launch are refused before any launch."""
    from raytracing_tpu_torch.kernels import traverse as T

    class Other(_CardPack):
        device = torch.device("cuda", 0)

    with pytest.raises(ValueError, match="one card"):
        T._on_cpu(_CardPack(), Other())
