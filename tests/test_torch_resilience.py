"""Failure detection and recovery (the port's `utils.resilience`): the 7
tests of tests/test_resilience.py on the port, each classification held
against the JAX package's where the two agree; the CUDA error classes,
built from the messages torch and `kernels.cuda.check` produce; a retried
fit step against a clean one; a Supervisor that must not read the device
after a fault.

Bars: a retried step ends bit-equal to a clean step (params, Adam's state
and the losses); checkpoints hold the last good step bit for bit."""

import numpy as np
import pytest
import torch

from raytracing_tpu.utils import resilience as JR

from raytracing_tpu_torch import RenderConfig, build_cluster_accel
from raytracing_tpu_torch.geometry.mesh import Scene, concat_objects
from raytracing_tpu_torch.kernels import cuda
from raytracing_tpu_torch.models import inverse
from raytracing_tpu_torch.utils import checkpoint as ckpt
from raytracing_tpu_torch.utils.resilience import (DeviceLost, Supervisor,
                                                   classify, device_alive,
                                                   is_transient, with_retry)

torch.set_num_threads(2)

# What torch appends to every CUDA error it raises (c10/cuda/CUDAException):
# "device" twice, which JAX's marker list would count as transient.
TORCH_ADVICE = (
    "\nCUDA kernel errors might be asynchronously reported at some other "
    "API call, so the stacktrace below might be incorrect.\nFor debugging "
    "consider passing CUDA_LAUNCH_BLOCKING=1\nCompile with "
    "`TORCH_USE_CUDA_DSA` to enable device-side assertions.\n")


def _torch_cuda_error(text):
    return torch.AcceleratorError(f"CUDA error: {text}{TORCH_ADVICE}")


def _check_error(monkeypatch, rc, text, kernel="walk"):
    """The RuntimeError `kernels.cuda.check` raises for a launch entry that
    returned `rc`, whose cudaGetErrorString is `text`."""

    class Lib:
        @staticmethod
        def rt_error_string(code):
            assert code == rc
            return text.encode()

    monkeypatch.setattr(cuda, "library", lambda: Lib)
    with pytest.raises(RuntimeError) as ei:
        cuda.check(rc, kernel)
    return ei.value


def test_device_alive_cpu():
    assert device_alive(timeout_s=60.0, device="cpu")


def test_is_transient_classification():
    """tests/test_resilience.py:22, held against the JAX classifier."""
    cases = [(RuntimeError("UNAVAILABLE: device disconnected"), True),
             (OSError("transport closed"), True),
             (ValueError("bad shape"), False),
             (RuntimeError("some unrelated assertion"), False)]
    for err, want in cases:
        assert is_transient(err) == JR.is_transient(err) == want, err


def test_cuda_error_classes(monkeypatch):
    """Each CUDA fault in the class a retry can do something about. JAX's
    rule ("device" in the message is transient) would retry every one of
    torch's errors, whose advice names device-side assertions."""
    oom = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB. GPU 0 has a total "
        "capacity of 79.11 GiB of which 3.06 GiB is free.")
    transient = [oom, _torch_cuda_error("out of memory"),
                 _check_error(monkeypatch, 2, "out of memory"),
                 _torch_cuda_error("CUDA-capable device(s) is/are busy or "
                                   "unavailable")]
    sticky = [_torch_cuda_error(t) for t in (
        "an illegal memory access was encountered",
        "unspecified launch failure", "misaligned address",
        "device-side assert triggered",
        "uncorrectable ECC error encountered")]
    sticky.append(_check_error(monkeypatch, 700, "an illegal memory access "
                                                 "was encountered"))
    deterministic = [
        _check_error(monkeypatch, 1, "invalid argument"),
        _check_error(monkeypatch, 98, "invalid device function", "refine"),
        _torch_cuda_error("invalid device function"),
        _torch_cuda_error("no kernel image is available for execution on "
                          "the device"),
        _torch_cuda_error("too many resources requested for launch"),
        RuntimeError("nvcc failed (1):\nwalk.cu(12): error"),
        RuntimeError("nvcc not found: the CUDA kernels build only where the "
                      "CUDA toolkit is installed (PATH or /usr/local/cuda/"
                      "bin)"),
        ValueError("wrapper: tensors on cpu and meta"),
        TypeError("bad"), AssertionError("Torch not compiled with CUDA "
                                         "enabled"),
        # c10's TORCH_INTERNAL_ASSERT text, and torch's report of a cuBLAS
        # status: both hold the transport marker "INTERNAL".
        RuntimeError('self.dim() == 2 INTERNAL ASSERT FAILED at "../aten/src/'
                     'ATen/native/cuda/Blas.cpp":279, please report a bug '
                     'to PyTorch. '),
        _torch_cuda_error("CUBLAS_STATUS_INTERNAL_ERROR when calling "
                          "`cublasCreate(handle)`")]
    for errs, kind in ((transient, "transient"), (sticky, "sticky"),
                       (deterministic, "deterministic")):
        for e in errs:
            assert classify(e) == kind, (kind, e)
    assert "kernel launch failed: invalid argument (1)" in str(
        deterministic[0])
    # Where JAX's rule and the port's differ, and why.
    assert JR.is_transient(deterministic[2]) and not is_transient(
        deterministic[2])
    assert all(JR.is_transient(e) for e in deterministic[-2:])


def test_with_retry_recovers_after_transient_faults():
    calls, restored = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return "ok"

    assert with_retry(flaky, retries=3, backoff_s=0.0,
                      before_retry=lambda: restored.append(1)) == "ok"
    assert len(calls) == 3 and len(restored) == 2


def test_with_retry_propagates_deterministic_errors(monkeypatch):
    for err in (ValueError("shape mismatch"),
                _check_error(monkeypatch, 1, "invalid argument")):
        calls = []

        def broken():
            calls.append(1)
            raise err

        with pytest.raises(type(err)):
            with_retry(broken, retries=5, backoff_s=0.0)
        assert len(calls) == 1


def test_with_retry_raises_device_lost_when_exhausted():
    def dead():
        raise RuntimeError("UNAVAILABLE: gone")

    with pytest.raises(DeviceLost) as ei:
        with_retry(dead, retries=2, backoff_s=0.0)
    assert isinstance(ei.value.last_error, RuntimeError)


def test_sticky_fault_spends_no_retry():
    """A poisoned context cannot be cured in the process: DeviceLost at
    once, the retries unspent."""
    calls = []

    def poisoned():
        calls.append(1)
        raise _torch_cuda_error("an illegal memory access was encountered")

    with pytest.raises(DeviceLost) as ei:
        with_retry(poisoned, retries=5, backoff_s=0.0)
    assert len(calls) == 1
    assert "illegal memory access" in str(ei.value.last_error)


def test_supervisor_checkpoints_on_device_loss(tmp_path):
    path = str(tmp_path / "recover.npz")
    state = {"params": {"x": torch.arange(3.0)}, "opt_state": None}
    sup = Supervisor(path, state_fn=lambda: state, retries=1, backoff_s=0.0)

    sup.run_step(lambda: 1.0)  # healthy step
    state["params"]["x"] = torch.arange(3.0) + 7  # progress before the fault

    def dead():
        raise RuntimeError("UNAVAILABLE: device lost")

    with pytest.raises(DeviceLost) as ei:
        sup.run_step(dead)
    assert ei.value.checkpoint_path == path
    params, _, step, _ = ckpt.load(path, state["params"])
    assert step == 1  # one completed step before loss
    np.testing.assert_array_equal(params["x"].numpy(), np.arange(3.0) + 7)


def test_supervisor_periodic_checkpoint(tmp_path):
    path = str(tmp_path / "periodic.npz")
    state = {"params": {"x": torch.zeros(2)}}
    sup = Supervisor(path, state_fn=lambda: state, checkpoint_every=2)
    sup.run_step(lambda: None)
    sup.run_step(lambda: None)
    params, _, step, _ = ckpt.load(path, state["params"])
    assert step == 2


def test_supervisor_snapshot_reads_no_device_after_a_fault(tmp_path):
    """After a sticky fault the state's tensors cannot be read; the
    checkpoint comes from the host copy of the last good step, and the
    fault spends no retry."""
    path = str(tmp_path / "lost.npz")
    state = {"params": {"x": torch.arange(4.0)}, "opt_state": None}
    poisoned = [False]

    def state_fn():
        if poisoned[0]:
            raise _torch_cuda_error("an illegal memory access was "
                                    "encountered")
        return state

    sup = Supervisor(path, state_fn=state_fn, retries=3, backoff_s=0.0)
    sup.run_step(lambda: None)
    state["params"]["x"] = torch.arange(4.0) * 3
    calls = []

    def fault():
        calls.append(1)
        state["params"]["x"].add_(100.0)  # the step got halfway
        poisoned[0] = True
        raise _torch_cuda_error("an illegal memory access was encountered")

    with pytest.raises(DeviceLost) as ei:
        sup.run_step(fault)
    assert len(calls) == 1 and ei.value.checkpoint_path == path
    params, _, step, _ = ckpt.load(path, {"x": torch.zeros(4)})
    assert step == 1
    assert torch.equal(params["x"], torch.arange(4.0) * 3)


@pytest.fixture(scope="module")
def fit_setup():
    """A triangle of its own color before a reflective floor (two objects,
    a CS 8 accel), an 8x8 frame with a diffuse fan: every step draws
    rays and uniforms."""
    tri = {"verts": np.array([[-2.0, -2.0, 5.0], [3.0, -2.0, 5.0],
                              [-2.0, 3.0, 5.0]], np.float32),
           "tri_v": np.array([[0, 2, 1]], np.int32),
           "colors": np.array([0.8, 0.6, 0.4], np.float32),
           "material": (1.0, 0.3, 0.5)}
    floor = {"verts": np.array([[-50, -2, -50], [-50, -2, 50], [50, -2, 50],
                                [50, -2, -50]], np.float32),
             "tri_v": np.array([[0, 1, 2], [0, 2, 3]], np.int32),
             "normals": np.array([[0, 1, 0], [0, 1, 0]], np.float32),
             "colors": np.array([0.6, 0.7, 0.8], np.float32),
             "material": (1.0, 0.4, 0.9)}
    scene = Scene(mesh=concat_objects([tri, floor]),
                  sun=torch.tensor([200.0, 300.0, -1000.0]))
    accel = build_cluster_accel(scene.mesh, cluster_size=8)
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1,
                       diffuse_depth=1, reflect_depth=2)
    target = torch.full((8, 8, 3), 0.4)
    return scene, accel, cfg, target


def _fit(fit_setup, **kw):
    scene, accel, cfg, target = fit_setup
    return inverse.fit(scene, target, {"colors": scene.mesh.colors * 0.5},
                       cfg, accel=accel, steps=3, rays_per_step=32,
                       generator=torch.Generator().manual_seed(5), **kw)


def test_retried_fit_step_equals_a_clean_step(fit_setup, monkeypatch,
                                              tmp_path):
    """A fault raised after `optimizer.step()` has run (step 2 of 3): the
    retry starts from the params, Adam's state and the generator from
    before the attempt, so the fit ends bit-equal to a clean one. A plain
    rerun would apply Adam twice and draw other rays."""
    clean = _fit(fit_setup)
    real = inverse.Fitter.step
    calls = []

    def faulty(self, idx, uniforms):
        loss = real(self, idx, uniforms)
        calls.append(1)
        if len(calls) == 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried "
                                              "to allocate 2.00 GiB.")
        return loss

    monkeypatch.setattr(inverse.Fitter, "step", faulty)
    retried = _fit(fit_setup, retries=2,
                   checkpoint_path=str(tmp_path / "r.npz"))
    assert len(calls) == 4  # 3 steps, one of them twice
    assert retried.losses == clean.losses
    assert torch.equal(retried.params["colors"], clean.params["colors"])
    for i, st in clean.opt_state["state"].items():
        for name, v in st.items():
            assert torch.equal(retried.opt_state["state"][i][name], v), name


def test_fit_writes_the_last_good_step_on_device_loss(fit_setup,
                                                      monkeypatch, tmp_path):
    """Retries spent on step 2 of 3: the checkpoint holds the params and
    Adam's state after step 1 — those of a clean 1-step fit."""
    scene, accel, cfg, target = fit_setup
    clean = inverse.fit(scene, target, {"colors": scene.mesh.colors * 0.5},
                        cfg, accel=accel, steps=1, rays_per_step=32,
                        generator=torch.Generator().manual_seed(5))
    real = inverse.Fitter.step
    calls = []

    def faulty(self, idx, uniforms):
        calls.append(1)
        if len(calls) >= 2:
            real(self, idx, uniforms)
            raise RuntimeError("UNAVAILABLE: device gone")
        return real(self, idx, uniforms)

    monkeypatch.setattr(inverse.Fitter, "step", faulty)
    path = str(tmp_path / "lost.npz")
    with pytest.raises(DeviceLost) as ei:
        _fit(fit_setup, retries=1, checkpoint_path=path)
    assert ei.value.checkpoint_path == path and len(calls) == 3
    params, opt_state, step, _ = ckpt.load(
        path, clean.params, clean.opt_state)
    assert step == 1
    assert torch.equal(params["colors"], clean.params["colors"])
    for i, st in clean.opt_state["state"].items():
        for name, v in st.items():
            assert torch.equal(opt_state["state"][i][name], v), name
