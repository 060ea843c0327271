"""Build and load the port's CUDA kernels (`raytracing_tpu_torch/csrc`).

All `.cu` sources compile in ONE `nvcc` call (`--threads 0`: the sources in
parallel) into one shared library with a plain C interface, loaded with
ctypes. The library lands in
`raytracing_tpu_torch/_build/`, named by a hash of the sources and flags,
so an edited source rebuilds and an unchanged one is reused. Nothing is
built when the package is imported: the first kernel launch (or an
explicit `build()`) does it. `-fmad=false` and no `--use_fast_math` keep
every kernel bit-equal to its plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import NamedTuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "--threads", "0", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# The pack entries take (rays, np, ray_tile, ...): the culling tile at run
# time (csrc/common.cuh's ray_tile_ok).
_SIGNATURES = {
    "rt_tile_extents": [_P, _L, _I, _P, _P, _P],
    "rt_tile_lists": [_P, _L, _I, _P, _P, _I, _F, _P, _P, _P, _P, _P, _P, _P,
                      _P],
    "rt_lists_from_extents": [_P, _P, _P, _P, _L, _P, _L, _I, _P, _P, _I, _I,
                              _F, _P, _L, _P, _P, _P, _P, _P, _P],
    # rt_camera_lists(offs, spp, width, height, bh, bw, aspect, scale,
    # tile0, rows, gy, gx, py, px, bmin, bmax, c, ids, tnear, cnt, scratch,
    # infbits, stream) and the pooled lists' second stage.
    "rt_camera_lists": [_P, _I, _I, _I, _I, _I, _F, _F, _L, _I, _I, _I, _I,
                        _I, _P, _P, _I, _P, _P, _P, _P, _P, _P],
    "rt_camera_member_lists": [_P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I,
                               _I, _P, _L, _P, _I, _P, _P, _P, _P, _P, _P,
                               _P, _P],
    "rt_refine_dense": [_P, _L, _I, _P, _P, _I, _F, _P, _P, _P],
    "rt_refine_dense_extents": [_P, _L, _I, _P, _P, _I, _F, _P, _P, _P, _P],
    "rt_refine_lists": [_P, _L, _I, _P, _P, _I, _I, _I, _P, _P, _F, _P, _P],
    "rt_walk": [_P, _L, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _L, _P, _L,
                _I, _I, _F, _F, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                _P],
    "rt_walk_gstream": [_P, _L, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                        _P, _L, _P, _L, _I, _I, _F, _F, _I, _I, _I, _I, _P,
                        _P, _P, _P, _P, _P, _P],
    "rt_walk_wq": [_P, _L, _I, _P, _P, _P, _I, _I, _P, _L, _P, _L, _I, _I,
                   _F, _F, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    # Resident blocks per multiprocessor of an instance at a block size
    # (cudaOccupancyMaxActiveBlocksPerMultiprocessor): the last argument.
    "rt_extents_occupancy": [_I, _P],
    # rt_lists_occupancy(from, width, *threads, *blocks): the threads a
    # launch over rows of `width` boxes takes, and its resident blocks
    # (from: 0 extents, 1 pack, 2 camera, 3 camera member rows).
    "rt_lists_occupancy": [_I, _I, _P, _P],
    "rt_refine_occupancy": [_I, _I, _I, _I, _P],
    "rt_walk_occupancy": [_I, _I, _I, _I, _I, _P],
    "rt_gstream_occupancy": [_I, _I, _I, _I, _P],
    "rt_wq_occupancy": [_I, _I, _I, _I, _P],
    "rt_walk_camera": [_P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P, _P, _I,
                       _I, _I, _P, _P, _L, _P, _L, _I, _I, _F, _I, _I, _P,
                       _P, _P, _P, _P, _P, _P, _P],
    "rt_rest_merge": [_P, _L, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P, _I, _P,
                      _I, _P, _I, _I, _F, _I, _F, _P, _P, _P, _P, _P, _P],
    "rt_light_sample": [_L, _P, _L, _L, _P, _L, _L, _P, _P, _L, _L, _P, _P,
                        _P, _P, _P, _P, _P, _P],
    "rt_light_fold": [_L, _I, _I, _I, _I, _P, _P, _P, _P, _P, _L, _L, _P, _P,
                      _P, _P, _L, _P, _L, _L, _P, _P],
}


class BuildResult(NamedTuple):
    path: str
    seconds: float  # 0.0 when an up-to-date library was reused
    log: str        # nvcc's output (register and shared-memory use)


_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed (PATH or /usr/local/cuda/bin)")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))


def build() -> BuildResult:
    """Compile the kernels unless an up-to-date library exists. Raises
    RuntimeError with nvcc's output if the build fails."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(glob.glob(os.path.join(SRC_DIR, "*"))):
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR,
                      f"libraytracing_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return BuildResult(so, 0.0, "")
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *_sources()],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, so)
    return BuildResult(so, seconds, log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build().path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, kernel: str) -> None:
    """Raise if a launch entry returned a CUDA error."""
    if rc != 0:
        msg = library().rt_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({rc})")
