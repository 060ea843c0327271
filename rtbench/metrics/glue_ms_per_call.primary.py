"""glue_ms_per_call.primary (ms, moves primary_rays_per_s): device ms a
call in the query's PyTorch glue around the port's kernels: elementwise
work, sorts, reductions, gathers, copies."""

from rtbench.metrics_common import layer_ms_per_step

LAYERS = ("sorts", "reductions", "gathers", "memcpy", "glue")


def read(reading):
    return layer_ms_per_step(reading, LAYERS)
