"""glue_ms_per_frame.whitted (ms, moves frame_s): device ms a frame in the
shading and binning glue (models/whitted.shade, _children,
kernels/binning): PyTorch elementwise work, sorts, reductions, gathers,
copies."""

from rtbench.metrics_common import layer_ms_per_step

LAYERS = ("sorts", "reductions", "gathers", "memcpy", "glue")


def read(reading):
    return layer_ms_per_step(reading, LAYERS)
