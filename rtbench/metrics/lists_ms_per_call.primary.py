"""lists_ms_per_call.primary (ms, moves primary_rays_per_s): device ms a
call in the list build, pooled or direct (csrc/lists.cu, extents.cu)."""

from rtbench.metrics_common import layer_ms_per_step

LAYERS = ("refine", "lists", "extents")


def read(reading):
    return layer_ms_per_step(reading, LAYERS)
