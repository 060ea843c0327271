"""Timing of a repeated call (twin of `raytracing_tpu.utils.timing`,
`chain_bench` only).

`chain_bench` times `fn(state, *args) -> state` over `iters` calls, each
taking the previous call's result, best of `trials`. On a card the window
is a pair of CUDA events around the calls, so it measures device time
and not how fast the host queues launches; on the CPU it is
`time.perf_counter`.

The JAX module's `sync` and its reason for the dependency chain (its
docstring's points 1 and 2: the TPU runtime could serve a repeated
dispatch from a cache, and `block_until_ready` could return early) belong
to that runtime and are not ported (ROADMAP "Not to port"). CUDA runs
every launch and its events wait for the work before them. The chained
signature is kept, so a function timed here is the same function as
there; passing the state along costs nothing.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _on_card(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, (list, tuple)):
        return any(_on_card(x) for x in tree)
    if isinstance(tree, dict):
        return any(_on_card(x) for x in tree.values())
    return False


def chain_bench(fn: Callable, state, *args, iters: int = 10,
                trials: int = 3) -> float:
    """ms per call of `fn(state, *args) -> state` over `iters` calls, the
    best of `trials`, after one warm-up call; CUDA events when the state
    or an argument is on a card, else the host clock."""
    state = fn(state, *args)  # warm-up
    card = _on_card((state, args))
    best = float("inf")
    for _ in range(trials):
        s = state
        if card:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                s = fn(s, *args)
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                s = fn(s, *args)
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / iters)
    return best
