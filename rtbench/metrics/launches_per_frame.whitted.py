"""launches_per_frame.whitted (launches, moves frame_s): device operations
(kernels, copies, sets) of a profiled frame: the host's launches."""

from rtbench.metrics_common import launches_per_step as read  # noqa: F401
