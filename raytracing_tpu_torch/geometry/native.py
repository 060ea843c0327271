"""ctypes binding of the framework-neutral host library
`csrc/raytracing_native.cpp`.

Host build code only — OBJ parsing, midpoint subdivision, the SAH cluster
order and the kernel data blocks. The port compiles its own copy of the
library with `g++` at first use, into `raytracing_tpu_torch/_build/`
(named by a hash of the source and flags; nothing is built when the
package is imported). Every entry point returns None when there is no
compiler or the build fails, and the callers use their numpy versions,
which give identical output — minutes instead of seconds on a
million-triangle mesh. `-ffp-contract=off` keeps the library's f32 results
equal to numpy's op by op; no `-march` flag, so a library built on one
machine loads on another.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO_DIR, "csrc", "raytracing_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-fPIC", "-std=c++17", "-shared")
_lib = None
_load_failed = False


def build() -> Optional[str]:
    """Path of the compiled host library, building it if it is not there
    yet; None when the source or a C++ compiler is missing or the compiler
    fails."""
    cxx = shutil.which("g++")
    if cxx is None or not os.path.exists(SOURCE):
        return None
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    so = os.path.join(BUILD_DIR,
                      f"libraytracing_native_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        return None
    os.replace(tmp, so)
    return so


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    path = build()
    try:
        if path is None:
            raise OSError("no host library")
        lib = ctypes.CDLL(path)
    except OSError:
        _load_failed = True
        return None
    lib.rt_parse_obj_count.restype = ctypes.c_int
    lib.rt_parse_obj_count.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long)]
    lib.rt_parse_obj_fill.restype = ctypes.c_int
    lib.rt_parse_obj_fill.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.c_long]
    lib.rt_sah_sweep_order.restype = ctypes.c_int
    lib.rt_sah_sweep_order.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_longlong)]
    lib.rt_kernel_blocks.restype = ctypes.c_int
    lib.rt_kernel_blocks.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_long, ctypes.c_long, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.rt_subdivide_level.restype = ctypes.c_int
    lib.rt_subdivide_level.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong)]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def parse_obj(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = _load()
    if lib is None:
        return None
    nv = ctypes.c_long(0)
    nt = ctypes.c_long(0)
    if lib.rt_parse_obj_count(path.encode(), ctypes.byref(nv),
                              ctypes.byref(nt)) != 0:
        return None
    verts = np.empty((nv.value, 3), dtype=np.float32)
    tris = np.empty((nt.value, 3), dtype=np.int32)
    rc = lib.rt_parse_obj_fill(
        path.encode(), _f32p(verts), nv.value,
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), nt.value)
    return (verts, tris) if rc == 0 else None


def sah_sweep_order(cent: np.ndarray, blo: np.ndarray, bhi: np.ndarray,
                    cs: int) -> Optional[np.ndarray]:
    """Exact-sweep SAH cluster order; identical to the numpy
    `accel.packets._sah_sweep_order`."""
    lib = _load()
    if lib is None:
        return None
    c = np.ascontiguousarray(cent, dtype=np.float32)
    lo = np.ascontiguousarray(blo, dtype=np.float32)
    hi = np.ascontiguousarray(bhi, dtype=np.float32)
    out = np.empty(c.shape[0], dtype=np.int64)
    rc = lib.rt_sah_sweep_order(
        _f32p(c), _f32p(lo), _f32p(hi), c.shape[0], int(cs),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
    return out if rc == 0 else None


def kernel_blocks(tri_verts: np.ndarray, valid: np.ndarray, c: int,
                  cs: int) -> Optional[np.ndarray]:
    """The Baldwin–Weber blocks [C, 12, CS] (the only block family the port
    keeps); identical to the numpy `accel.packets._kernel_blocks_host`
    (the library is built without FMA contraction)."""
    lib = _load()
    if lib is None:
        return None
    tv = np.ascontiguousarray(tri_verts, dtype=np.float32)
    va = np.ascontiguousarray(valid, dtype=np.uint8)
    tri_blocks = np.empty((c, 9, cs), dtype=np.float32)
    pmt = np.empty((c, 12, cs), dtype=np.float32)
    rc = lib.rt_kernel_blocks(
        _f32p(tv), va.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        int(c), int(cs), _f32p(tri_blocks), _f32p(pmt), None)
    return pmt if rc == 0 else None


def subdivide_level(verts: np.ndarray, tri_v: np.ndarray
                    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """One midpoint (1:4) subdivision level; identical to one level of the
    numpy `geometry.subdivide.subdivide_arrays`."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(verts, dtype=np.float32)
    t = np.ascontiguousarray(tri_v, dtype=np.int32)
    nv, nt = v.shape[0], t.shape[0]
    out_v = np.empty((nv + 3 * nt, 3), dtype=np.float32)
    out_t = np.empty((4 * nt, 3), dtype=np.int32)
    new_nv = ctypes.c_longlong(0)
    rc = lib.rt_subdivide_level(
        _f32p(v), nv, t.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), nt,
        _f32p(out_v), out_t.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ctypes.byref(new_nv))
    if rc != 0:
        return None
    return out_v[:new_nv.value].copy(), out_t
