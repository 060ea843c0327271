"""The backward's segment scatter-add on the card (`csrc/scatter.cu`).

`ops.scatter.segment_scatter_add` sends every call on the card here: one
launch adds every lane whose index is in range and skips the rest, the
drop bucket's lanes, without an atomic. Given `order`, the permutation of
a stable sort of the indices, it sums each row in lane order without
atomics instead (the form for deterministic algorithms). The wrapper takes
CUDA tensors of one card only and raises ValueError on a tensor of another
dtype, shape, layout or device before any launch. `LAUNCHES["scatter"]`
counts the launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from raytracing_tpu_torch.kernels import cuda
from raytracing_tpu_torch.utils.profiling import COUNTERS

# `kernels.traverse.LAUNCHES`, which imports this module through
# `ops.scatter`.
COUNTERS.launches.update({"scatter": 0})

# Widest rows the kernel adds: the 9 shading cotangents of a hit.
MAX_COLS = 9


def _refuse(what: str) -> None:
    raise ValueError(f"scatter kernel: {what}")


def scatter_add(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                added: Optional[torch.Tensor] = None,
                order: Optional[torch.Tensor] = None) -> None:
    """In place: out [n_rows, K] f32 (contiguous) += vals [R, K] f32 at rows
    idx [R] (int32 or int64, contiguous); a lane whose index is outside
    [0, n_rows) is skipped. vals' rows may lie any stride apart, each row's
    K values contiguous; 1 <= K <= MAX_COLS. With `added` (int64 []), the
    count of lanes in range is added to it on the card. With `order`
    (int64 [R], contiguous), idx is sorted (stably) and order[j] is the
    lane at place j: each row is summed in lane order, without atomics."""
    if idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1 \
            or not idx.is_contiguous():
        _refuse(f"idx must be contiguous int32 or int64 [R], not "
                f"{idx.dtype} {list(idx.shape)}")
    rows = idx.shape[0]
    if vals.dtype != torch.float32 or vals.dim() != 2 \
            or vals.shape[0] != rows or not 1 <= vals.shape[1] <= MAX_COLS \
            or (vals.shape[1] > 1 and vals.stride(1) != 1) \
            or (rows > 1 and vals.stride(0) < vals.shape[1]):
        _refuse(f"vals must be float32 [{rows}, K <= {MAX_COLS}] with "
                f"contiguous rows, not {vals.dtype} {list(vals.shape)} "
                f"strides {list(vals.stride())}")
    k = vals.shape[1]
    if out.dtype != torch.float32 or out.dim() != 2 or out.shape[1] != k \
            or not out.is_contiguous():
        _refuse(f"out must be contiguous float32 [n_rows, {k}], not "
                f"{out.dtype} {list(out.shape)}")
    if added is not None and (added.dtype != torch.int64
                              or added.shape != ()):
        _refuse(f"added must be int64 [], not {added.dtype} "
                f"{list(added.shape)}")
    if order is not None and (order.dtype != torch.int64
                              or order.shape != (rows,)
                              or not order.is_contiguous()):
        _refuse(f"order must be contiguous int64 [{rows}], not "
                f"{order.dtype} {list(order.shape)}")
    tensors = [out, idx, vals] + [t for t in (added, order) if t is not None]
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        _refuse(f"takes the CUDA tensors of one card, not tensors on "
                f"{sorted(map(str, devs))}")
    if not rows or not out.shape[0]:
        return
    from raytracing_tpu_torch.kernels.traverse import _ptr, _stream

    with torch.cuda.device(out.device):
        cuda.check(cuda.library().rt_segment_scatter_add(
            _ptr(idx), idx.element_size(), rows, out.shape[0], k,
            _ptr(vals), vals.stride(0) if rows > 1 else k, _ptr(out),
            _ptr(added), _ptr(order), _stream(out)), "scatter")
    COUNTERS.launches["scatter"] += 1
