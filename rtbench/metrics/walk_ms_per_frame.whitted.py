"""walk_ms_per_frame.whitted (ms, moves frame_s): device ms a frame in the
walk kernels K1-K4 (csrc/walk.cu, camera.cu, gstream.cu, wq.cu)."""

from rtbench.metrics_common import layer_ms_per_step

LAYERS = ("walk_k1_k2", "walk_k3_k4")


def read(reading):
    return layer_ms_per_step(reading, LAYERS)
