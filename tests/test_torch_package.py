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
    with pytest.raises(ValueError, match="ROADMAP"):
        RenderConfig(backend=backend)


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
