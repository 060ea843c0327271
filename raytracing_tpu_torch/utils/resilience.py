"""Failure detection and recovery for long renders and fits (twin of
`raytracing_tpu.utils.resilience`).

Three primitives, as in the JAX package:

  * `device_alive()` — one tiny op on the card under a wall-clock
    deadline, in a worker thread, so a hung device cannot hang the probe;
  * `with_retry(fn)` — reruns `fn` after a fault a retry can cure, with
    exponential backoff; raises `DeviceLost` when the retries are spent,
    or at once when the fault has poisoned the process's CUDA context;
  * `Supervisor` — runs each step of a loop under `with_retry`, starts
    every retry from the state before the failed attempt, and on device
    loss writes a checkpoint before it raises, which a new process resumes
    (`fit --resume`).

CUDA faults fall in three classes, by what a retry can do (`classify`):

  * transient — `torch.cuda.OutOfMemoryError` and a launch entry's "out of
    memory" (the cache is freed before the retry), a busy or unavailable
    device, and the JAX list's transport markers (UNAVAILABLE,
    RESOURCE_EXHAUSTED, DEADLINE_EXCEEDED, ... and "transport",
    "connection") on a RuntimeError, OSError or TimeoutError;
  * sticky — an illegal address or instruction, an unspecified launch
    failure, a misaligned address, a device-side assert, an ECC or NVLink
    error, a launch timeout: the CUDA context is lost for this process, so
    no retry in it can succeed and `with_retry` raises `DeviceLost` at
    once, without spending the retries;
  * deterministic — everything else, among them a launch entry's invalid
    argument (`kernels.cuda.check`), a failed or missing `nvcc`, an
    invalid device function or a missing kernel image (a wrong arch), a
    failed internal assert of torch and a library's internal error
    (`CUBLAS_STATUS_INTERNAL_ERROR`: a bug, not a fault of the link), and
    every ValueError and TypeError: they propagate as they are.

The JAX list counts any message that contains "device" as transient. Every
CUDA error that torch raises carries the words "device-side assertions"
in its advice, so that rule would retry a wrong arch; here only the
markers above count.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Optional

import torch

log = logging.getLogger("raytracing_tpu_torch.resilience")

# cudaGetErrorString's text of the errors that leave the context unusable.
_STICKY_MARKERS = (
    "an illegal memory access was encountered",
    "an illegal instruction was encountered",
    "unspecified launch failure",
    "misaligned address",
    "device-side assert triggered",
    "uncorrectable ECC error",
    "uncorrectable NVLink error",
    "hardware stack error",
    "invalid program counter",
    "the launch timed out and was terminated",
    "operation not supported on global/shared address space",
)
_TRANSIENT_CUDA_MARKERS = (
    "out of memory",
    "busy or unavailable",
)
_DETERMINISTIC_MARKERS = (
    "kernel launch failed",          # kernels.cuda.check, other codes
    "nvcc failed", "nvcc not found",
    "invalid device function",
    "no kernel image is available",
    "invalid argument",
    "invalid configuration argument",
    "too many resources requested for launch",
    # TORCH_INTERNAL_ASSERT's text, and cuBLAS/cuSPARSE/cuSOLVER's own
    # internal error: bugs that the transport marker "INTERNAL" would
    # otherwise retry and then report as device loss.
    "INTERNAL ASSERT FAILED",
    "_STATUS_INTERNAL_ERROR",
)
# The JAX package's runtime markers, without its "device"/"Device".
_TRANSPORT_MARKERS = (
    "RESOURCE_EXHAUSTED", "UNAVAILABLE", "DEADLINE_EXCEEDED", "INTERNAL",
    "ABORTED", "CANCELLED", "transport", "connection",
)


class DeviceLost(RuntimeError):
    """The device is considered gone: the retries are spent, or a sticky
    fault poisoned the CUDA context. Carries `last_error` (the underlying
    exception) and, when a Supervisor is involved, `checkpoint_path` of
    the state written before giving up."""

    def __init__(self, msg: str, last_error: Optional[BaseException] = None,
                 checkpoint_path: Optional[str] = None):
        super().__init__(msg)
        self.last_error = last_error
        self.checkpoint_path = checkpoint_path


def classify(err: BaseException) -> str:
    """"transient", "sticky" or "deterministic" (module docstring)."""
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return "transient"
    if isinstance(err, (FloatingPointError, ValueError, TypeError)):
        return "deterministic"
    if not isinstance(err, (RuntimeError, OSError, TimeoutError)):
        return "deterministic"
    text = f"{type(err).__name__}: {err}"
    if any(m in text for m in _STICKY_MARKERS):
        return "sticky"
    if any(m in text for m in _TRANSIENT_CUDA_MARKERS):
        return "transient"
    if any(m in text for m in _DETERMINISTIC_MARKERS):
        return "deterministic"
    if any(m in text for m in _TRANSPORT_MARKERS):
        return "transient"
    return "deterministic"


def is_transient(err: BaseException) -> bool:
    """Is this a fault that a retry in this process can cure?"""
    return classify(err) == "transient"


def device_alive(timeout_s: float = 30.0, device="cuda") -> bool:
    """Probe `device`: `(torch.ones((), device=dev) + 1).item()` in a
    worker thread with a wall-clock deadline. A hung device makes ordinary
    calls block forever; the deadline turns that into False, as does any
    error."""
    result: list = []

    def probe() -> None:
        try:
            result.append((torch.ones((), device=device) + 1).item() == 2.0)
        except Exception:  # noqa: BLE001 — any failure means "not alive"
            result.append(False)

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout_s)
    return bool(result and result[0])


def with_retry(
    fn: Callable[[], Any],
    retries: int = 3,
    backoff_s: float = 1.0,
    backoff_factor: float = 2.0,
    probe: bool = False,
    probe_timeout_s: float = 30.0,
    before_retry: Optional[Callable[[], None]] = None,
    device="cuda",
) -> Any:
    """Run `fn()`, retrying transient faults up to `retries` times with
    exponential backoff. Before each retry the CUDA cache is freed (after
    an out-of-memory error), `before_retry()` runs (it restores what the
    failed attempt changed), and with `probe=True` `device_alive(device)`
    is asked first. Deterministic errors propagate at once; a sticky fault
    raises DeviceLost at once; DeviceLost also when the retries are
    spent."""
    delay = backoff_s
    last: Optional[BaseException] = None
    for attempt in range(retries + 1):
        if attempt:
            if isinstance(last, torch.cuda.OutOfMemoryError) or \
                    "out of memory" in str(last):
                torch.cuda.empty_cache()
            if probe and not device_alive(probe_timeout_s, device):
                log.warning("device not alive before retry %d", attempt)
            if before_retry is not None:
                before_retry()
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — classified just below
            kind = classify(e)
            if kind == "deterministic":
                raise
            last = e
            if kind == "sticky":
                raise DeviceLost(f"CUDA context lost: {e}",
                                 last_error=e) from e
            if attempt == retries:
                break
            log.warning("transient device fault (attempt %d/%d): %s; "
                        "retrying in %.1fs", attempt + 1, retries, e, delay)
            time.sleep(delay)
            delay *= backoff_factor
    raise DeviceLost(f"device fault persisted through {retries} retries",
                     last_error=last)


def _to_host(tree):
    """A copy of `tree` with every tensor copied to the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class Supervisor:
    """Recovery harness for step loops (fit, animate).

    `run_step(fn)` first copies `state_fn()` (a dict with "params",
    "opt_state" and optionally "metadata") to the host: the state at the
    last good step, read while the device is known healthy. That copy is
    the only state the Supervisor uses after a fault. A transient fault is
    retried (`with_retry`), each retry after `restore_fn(host_copy)` puts
    the state back as it was before the failed attempt — a step that
    changes its state in place (the optimizer) is otherwise applied twice.
    When the device is lost (a sticky fault, or the retries spent), the
    host copy is written to `checkpoint_path` — no device memory is read
    then, since after a sticky fault it cannot be — and DeviceLost is
    raised carrying that path. With `checkpoint_every=k`, the state is
    also written every k good steps.

    Cost per step: one copy of the state to the host (a fit's params and
    Adam's two moments, three times the fitted tables: 455 KB for the
    default scene's colors) and the wait for the step before it.
    """

    def __init__(
        self,
        checkpoint_path: str,
        state_fn: Callable[[], dict],
        retries: int = 3,
        backoff_s: float = 1.0,
        checkpoint_every: int = 0,
        restore_fn: Optional[Callable[[dict], None]] = None,
        step: int = 0,
    ):
        self.checkpoint_path = checkpoint_path
        self.state_fn = state_fn
        self.retries = retries
        self.backoff_s = backoff_s
        self.checkpoint_every = checkpoint_every
        self.restore_fn = restore_fn
        self.step = step

    def _snapshot(self, st: dict) -> str:
        from raytracing_tpu_torch.utils import checkpoint as ckpt

        ckpt.save(self.checkpoint_path, st.get("params"),
                  st.get("opt_state"), step=self.step,
                  metadata=st.get("metadata"))
        return self.checkpoint_path

    def run_step(self, fn: Callable[[], Any]) -> Any:
        """Execute one step under retry; periodic and failure
        checkpoints."""
        host = _to_host(self.state_fn())
        restore = None
        if self.restore_fn is not None:
            def restore():
                self.restore_fn(host)
        try:
            out = with_retry(fn, retries=self.retries,
                             backoff_s=self.backoff_s, before_retry=restore)
        except DeviceLost as e:
            path = self._snapshot(host)
            log.error("device lost at step %d; state checkpointed to %s",
                      self.step, path)
            raise DeviceLost(str(e), last_error=e.last_error,
                             checkpoint_path=path) from e
        self.step += 1
        if self.checkpoint_every and self.step % self.checkpoint_every == 0:
            self._snapshot(self.state_fn())
        return out
