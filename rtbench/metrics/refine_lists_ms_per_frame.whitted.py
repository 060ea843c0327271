"""refine_lists_ms_per_frame.whitted (ms, moves frame_s): device ms a frame
in the list builds and the refinement (csrc/lists.cu, refine.cu,
extents.cu)."""

from rtbench.metrics_common import layer_ms_per_step

LAYERS = ("refine", "lists", "extents")


def read(reading):
    return layer_ms_per_step(reading, LAYERS)
