"""walk_ms_per_call.primary (ms, moves primary_rays_per_s): device ms a call
in the camera walk (csrc/camera.cu: K1 / K2 camera; K3 where the groups
exceed the budget)."""

from rtbench.metrics_common import layer_ms_per_step

LAYERS = ("walk_k1_k2", "walk_k3_k4")


def read(reading):
    return layer_ms_per_step(reading, LAYERS)
