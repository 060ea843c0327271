"""The port's inverse-fit step against the benchmark's plain reference
(`rtbench/reference/fit.py`), on the CPU through the port's plain kernel
versions, as the cell `two_teapots.fit` runs it: its entry, configuration
(the two-teapot scene, two_teapots' depths and fan, the pose of the green
teapot and every vertex fitted, the accel refit every step) and draws, at
a 16x16 frame of 2 spp and 512 rays a step. Steps 0 and 1 move the
geometry; step 2 is compared: its loss, its gradients with respect to
the pose and every vertex, and the change Adam made to them.

Bars: `loss_rel_err` under 1e-5, `pose_grad_rel_err`,
`verts_grad_rel_err` and `step_rel_err` under 1e-4. The two compute the same float32
operations but for t, which the port takes from its walk's Baldwin-Weber
planes and whose derivative it takes at the corners v0, v0 + e1, v0 + e2,
and the order of the loss's sum and of the scatter into the vertices; on
these rays they differ by rounding, ~1e-7 in the loss and up to ~5e-6 in
the gradients (the vertex gradient's norm is a sum over few hit
triangles, so one rounding of a large term shows); Adam's change follows
the gradients through its moments. Two controls must miss a bar by 10x:
the reference computed in bfloat16 in the port's place, and the port's
step 2 without the refit (taken out of `models.inverse`), whose walk and
backward see the geometry the accel was built from."""

import copy

import pytest
import torch

from raytracing_tpu_torch.models import inverse
from rtbench import spec
from rtbench.reference.fit import Numbers, compare

torch.set_num_threads(2)

CELL = "two_teapots.fit"
RENDER = {"width": 16, "height": 16, "samples_per_pixel": 2,
          "chunk_size": 512}
SEED = 2 ** 33 + 5
BARS = {"loss_rel_err": 1e-5, "pose_grad_rel_err": 1e-4,
        "verts_grad_rel_err": 1e-4, "step_rel_err": 1e-4}


@pytest.fixture(scope="module")
def run():
    cell = spec.load_cell(CELL, spec.load_benchmark())
    traffic = dict(cell.traffic, render=RENDER, rays_per_step=512)
    e = spec.entry(traffic).Entry(copy.deepcopy(cell.config), traffic, SEED,
                                  "cpu")
    e.setup()
    kept = [e.keep(k, e.step(k)) for k in range(3)]
    # The same step 2 without the refit: a fit from step 2's parameters
    # and Adam state on the accel built from the start geometry.
    item = kept[2]
    stale = inverse.Fitter(e.fitter.scene, e.target, item.before, e.cfg,
                           accel=e.accel)
    stale.optimizer.load_state_dict(e.fitter.optimizer.state_dict())
    for n, p in stale.params.items():
        st = stale.optimizer.state[p]
        st["step"].fill_(item.adam[n][0])
        st["exp_avg"].copy_(item.adam[n][1])
        st["exp_avg_sq"].copy_(item.adam[n][2])
    with pytest.MonkeyPatch.context() as m:
        m.setattr(inverse, "refit_geometry", lambda acc, mesh: acc)
        stale_loss = stale.step(e.rays(item.k), e.uniforms(item.k))
    stale_item = item._replace(
        loss=stale_loss,
        grads={n: p.grad for n, p in stale.params.items()},
        after={n: p.detach().clone() for n, p in stale.params.items()})
    e.release(kept)
    return e, kept, stale_item


def _within(numbers, scale=1.0):
    return all(numbers[k] <= scale * v for k, v in BARS.items())


def test_the_step_is_the_reference(run):
    e, kept, _ = run
    assert kept[2].before["pose"].ne(torch.tensor(
        e.fit_cfg["start_pose"])).any()  # the geometry has moved
    got = e.check(kept[2])
    assert _within(got), got


def test_the_reference_in_bfloat16_misses(run):
    e, kept, _ = run
    got = e.control(kept[2].k, torch.bfloat16)
    assert not _within(got, 10.0), got


def test_the_step_without_the_refit_misses(run):
    e, _, stale_item = run
    got = e.check(stale_item)
    assert not _within(got, 10.0), got


def test_compare_reads_nan_as_infinite():
    ref = Numbers(1.0, torch.ones(6), torch.ones(4, 3), torch.ones(18))
    got = compare(Numbers(float("nan"), torch.full((6,), float("nan")),
                          torch.ones(4, 3), torch.zeros(18)), ref)
    assert got["loss_rel_err"] == float("inf")
    assert got["pose_grad_rel_err"] == float("inf")
    assert got["verts_grad_rel_err"] == 0.0
    assert got["step_rel_err"] == 1.0       # a state left unchanged
