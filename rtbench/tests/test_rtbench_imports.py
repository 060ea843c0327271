"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole, so the port, raytracing_tpu_torch, passes), and
the reference imports nothing of the port nor of the harness around it."""

import ast
import os

import pytest

from rtbench import device

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(os.path.relpath(os.path.join(d, f), HERE)
                 for d, _, fs in os.walk(HERE) for f in fs
                 if f.endswith(".py") and "__pycache__" not in d)


def imported(path):
    """Every absolute module name a source imports."""
    with open(os.path.join(HERE, path)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.append(node.module)
    return names


def test_sources_found():
    assert "run.py" in SOURCES and "reference/tracer.py" in SOURCES


@pytest.mark.parametrize("path", SOURCES)
def test_no_jax(path):
    tops = {n.split(".")[0] for n in imported(path)}
    assert not tops & set(device.FORBIDDEN), path


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if p.startswith("reference/")])
def test_reference_imports_nothing_of_the_program(path):
    for name in imported(path):
        assert name.split(".")[0] != "raytracing_tpu_torch", (path, name)
        if name.split(".")[0] == "rtbench":
            assert name.startswith("rtbench.reference"), (path, name)


def test_forbidden_modules_compares_top_level_names_whole():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
            "raytracing_tpu", "raytracing_tpu.models", "raytracing_tpu_torch",
            "raytracing_tpu_torch.kernels", "jaxtyping", "numpy"]
    assert device.forbidden_modules(mods) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "raytracing_tpu", "raytracing_tpu.models"]
