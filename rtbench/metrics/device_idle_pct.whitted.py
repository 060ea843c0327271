"""device_idle_pct.whitted (%, moves frame_s): the share of an unprofiled
frame in which the card does nothing: 100 (1 - busy per profiled frame /
the window's seconds per frame)."""

from rtbench.metrics_common import idle_pct as read  # noqa: F401
