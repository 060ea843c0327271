"""Segment scatter-add (twin of `raytracing_tpu.ops.scatter`).

The backward of the differentiable walk sums per-ray gradients into the
vertex, triangle and object tables through one of these. The JAX package
computes the sum with a sort, a cumulative sum and two boundary gathers
above 32,768 rows, because a scatter-add runs serially on its TPU; that
form is TPU-only and not ported. Here it is `index_add_`: on the card an
atomic add, so the order of the additions (and the last bits of a sum)
varies from run to run, and results are held to a tolerance, never to
bits.
"""

from __future__ import annotations

import torch


def segment_scatter_add(n_rows: int, idx: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """zeros([n_rows, K]) with vals [R, K] added at rows idx [R]; an index
    n_rows (or beyond) is the drop bucket that dead lanes point at."""
    idx = torch.clamp_max(idx.long(), n_rows)
    out = torch.zeros((n_rows + 1,) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    out.index_add_(0, idx, vals)
    return out[:n_rows]
