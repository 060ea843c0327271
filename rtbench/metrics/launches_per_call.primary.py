"""launches_per_call.primary (launches, moves primary_rays_per_s): device
operations (kernels, copies, sets) of a profiled call."""

from rtbench.metrics_common import launches_per_step as read  # noqa: F401
