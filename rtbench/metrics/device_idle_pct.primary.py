"""device_idle_pct.primary (%, moves primary_rays_per_s): the share of an
unprofiled call in which the card does nothing: 100 (1 - busy per
profiled call / the window's seconds per call)."""

from rtbench.metrics_common import idle_pct as read  # noqa: F401
