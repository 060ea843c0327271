"""Arithmetic the per-layer metrics' readers share. Each returns None
when the trace holds nothing to read."""

from __future__ import annotations


def idle_pct(reading):
    """100 (1 - device-busy seconds per profiled step / the unprofiled
    window's seconds per step)."""
    if reading is None or not reading.steps or reading.busy_s <= 0:
        return None
    return 100.0 * (1.0 - reading.busy_s / reading.steps / reading.step_s)


def launches_per_step(reading):
    if reading is None or not reading.steps or not reading.launches:
        return None
    return reading.launches / reading.steps


def layer_ms_per_step(reading, layers):
    """Device ms per profiled step in the named layers (`layers.py`'s
    keys); None where none of them ran."""
    if reading is None or not reading.steps:
        return None
    if not any(reading.layer_launches[k] for k in layers):
        return None
    return sum(reading.layer_ms[k] for k in layers) / reading.steps
