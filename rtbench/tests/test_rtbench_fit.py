"""The fit cell (`two_teapots.fit`, entry `fit_step`) on the CPU at a
16x16 frame of 2 spp and 512 rays a step: two steps through the harness's
window and reservoir, judged under the cell's limits, come out correct;
the same steps with a fault in what a step produces come out not correct
(half of the vertex gradient's rows left out; the loss 50% off and the
pose gradient twice what it is; the fitted state left unchanged by the
step; Adam's change applied twice); and the reference in bfloat16 put in
the program's place is not correct either, at a kept step and at a step
the reference replays from the start. The entry's faults alter a kept step
(what `test_rtbench_faults.py`'s `FAULTS` cannot name for this entry),
so they are here."""

import pytest
import torch

from rtbench import spec
from rtbench.harness import Reservoir, judge, within

RENDER = {"width": 16, "height": 16, "samples_per_pixel": 2,
          "chunk_size": 512}


def half_grads(item):
    verts = item.grads["verts"].clone()
    verts[verts.shape[0] // 2:] = 0.0      # rows never scattered
    return item._replace(grads=dict(item.grads, verts=verts))


def altered(item):
    return item._replace(loss=item.loss * 1.5,
                         grads=dict(item.grads,
                                    pose=item.grads["pose"] * 2.0))


def unchanged(item):
    return item._replace(after=item.before)   # the optimizer never stepped


def doubled(item):
    return item._replace(after={n: 2 * a - item.before[n]
                                for n, a in item.after.items()})


@pytest.fixture(scope="module")
def run():
    cell = spec.load_cell("two_teapots.fit", spec.load_benchmark())
    traffic = dict(cell.traffic, render=RENDER, rays_per_step=512)
    e = spec.entry(traffic).Entry(cell.config, traffic, 2 ** 40 + 3, "cpu")
    e.setup()
    res = Reservoir(2, 0)
    for k in range(2):
        res.offer(e.keep(k, e.step(k)))
    kept = e.release(res.items)
    return cell, e, kept


def test_the_steps_are_correct(run):
    cell, e, kept = run
    correct, failed, checks = judge([e.check(i) for i in kept], cell.limits)
    assert correct and failed == 0, checks


@pytest.mark.parametrize("fault", [half_grads, altered, unchanged, doubled])
def test_faults_come_out_incorrect(run, fault):
    cell, e, kept = run
    correct, failed, checks = judge([e.check(fault(kept[0]))], cell.limits)
    assert not correct and failed == 1, (fault.__name__, checks)


@pytest.mark.parametrize("kept_step", [True, False])
def test_control_fails(run, kept_step):
    cell, e, kept = run
    k = kept[1].k if kept_step else 3
    numbers = e.control(k, torch.bfloat16)
    assert not within(numbers, cell.limits), numbers
