"""Run-time utilities: checkpoints."""
