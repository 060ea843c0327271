"""Segment scatter-add (twin of `raytracing_tpu.ops.scatter`).

The backward of the differentiable walk sums per-ray gradients into the
vertex, triangle and object tables through one of these. The JAX package
computes the sum with a sort, a cumulative sum and two boundary gathers
above 32,768 rows, because a scatter-add runs serially on its TPU; that
form is TPU-only and not ported.

Which inputs take which line: on the card every call takes one launch of
`csrc/scatter.cu` (`kernels.scatter`), which skips each lane whose index
is out of range and adds each live lane with one atomic per column; it
takes float32 values [R, K] with 1 <= K <= 9 (every call of the backward)
and raises ValueError on anything else. Atomics add in no fixed order, so
the last bits of a sum vary from run to run and results are held to a
tolerance; under `torch.use_deterministic_algorithms(True)` the indices
are sorted first (stably) and the kernel sums each row in lane order, the
same bits every run. On the CPU (where the tests hold the port to the JAX
package) `index_add_` adds into one extra drop row. Indices are meant to
be non-negative; a negative one, like one at n_rows or beyond, is dropped
on either line.

Under `counting(True)` each call adds its lanes to `scatter.rows` and the
lanes whose index is in range to `scatter.added` (on the card the kernel's
own count of the lanes it added; the rest it skipped).
"""

from __future__ import annotations

import torch

from raytracing_tpu_torch.kernels import scatter as kernel
from raytracing_tpu_torch.utils.profiling import COUNTERS


def _takes_kernel(vals: torch.Tensor) -> bool:
    return vals.is_cuda


def segment_scatter_add(n_rows: int, idx: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """zeros([n_rows, K]) with vals [R, K] added at rows idx [R]; an index
    outside [0, n_rows) (n_rows is the drop bucket that dead lanes point
    at) adds nothing."""
    if COUNTERS.counting:
        COUNTERS.add_device("scatter.rows", idx.shape[0])
    if not _takes_kernel(vals):
        if COUNTERS.counting:
            COUNTERS.add_device("scatter.added",
                                ((idx >= 0) & (idx < n_rows)).sum())
        return index_add_rows(n_rows, idx, vals)
    if vals.dtype != torch.float32 or vals.dim() != 2 \
            or not 1 <= vals.shape[1] <= kernel.MAX_COLS:
        raise ValueError(
            f"segment_scatter_add on the card takes float32 [R, K <= "
            f"{kernel.MAX_COLS}] values, not {vals.dtype} "
            f"{list(vals.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.long()
    k = vals.shape[1]
    if vals.stride(1) != 1 and k > 1 or vals.stride(0) < k:
        vals = vals.contiguous()
    order = None
    if torch.are_deterministic_algorithms_enabled():
        idx, order = torch.sort(idx, stable=True)
    out = torch.zeros((n_rows, k), dtype=vals.dtype, device=vals.device)
    added = (torch.zeros((), dtype=torch.int64, device=vals.device)
             if COUNTERS.counting else None)
    kernel.scatter_add(out, idx.contiguous(), vals, added, order)
    if added is not None:
        # After the launch: the registry sums into a new tensor.
        COUNTERS.add_device("scatter.added", added)
    return out


def index_add_rows(n_rows: int, idx: torch.Tensor,
                   vals: torch.Tensor) -> torch.Tensor:
    """`segment_scatter_add` by `index_add_` into n_rows + 1 rows, the last
    the drop bucket: the CPU's line, and the card tests' reference."""
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < n_rows), idx, n_rows)
    out = torch.zeros((n_rows + 1,) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    out.index_add_(0, idx, vals)
    return out[:n_rows]
