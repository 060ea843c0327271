"""A run with the timed path broken underneath comes out as not correct:
the harness's look for a card skipped, the rest of a run driven (window,
release, check, judge) on the port's plain versions at a 16x16 frame,
with each fault these cells can have: half of the step's answers left
out, and answers altered where they are produced. (No cell has a state
that a step carries to the next, or an exchange between chips.)"""

import pytest

from rtbench import spec
from rtbench.harness import Reservoir, judge, window
from rtbench.tests.conftest import tiny_cell
from rtbench.tests.test_rtbench_control import CELLS, cut


def half_frame(img):
    img = img.clone()
    img[img.shape[0] // 2:] = 0.0          # rows never rendered
    return img


def altered_frame(img):
    img = img.clone()
    img[::4] += 2.0 / 255.0                # every fourth row off by 2 levels
    return img


def half_call(out):
    offs, t, slot = out
    t = t.clone()
    t[t.shape[0] // 2:] = float("inf")     # the second half never walked
    return offs, t, slot


def altered_call(out):
    offs, t, slot = out
    t = t.clone()
    t[::4] = t[::4] * 1.01                 # every fourth ray 1% too far
    return offs, t, slot


FAULTS = {"whitted_frame": (half_frame, altered_frame),
          "camera_primary": (half_call, altered_call)}


class Broken:
    def __init__(self, entry, fault):
        self.entry, self.fault = entry, fault

    def step(self, k):
        return self.fault(self.entry.step(k))

    def keep(self, k, out):
        return self.entry.keep(k, out)


@pytest.mark.parametrize("name", CELLS)
def test_faults_come_out_incorrect(name):
    cell = cut(tiny_cell(name))
    e = spec.entry(cell.traffic).Entry(cell.config, cell.traffic, 4242, "cpu")
    e.setup()
    faults = FAULTS[cell.traffic["entry"]]
    items = []
    for i, fault in enumerate(faults):
        res = Reservoir(1, i)
        window(Broken(e, fault), 0.0, res)
        items += res.items
    kept = e.release(items)
    for fault, item in zip(faults, kept):
        correct, failed, checks = judge([e.check(item)], cell.limits)
        assert not correct and failed == 1, (fault.__name__, checks)
