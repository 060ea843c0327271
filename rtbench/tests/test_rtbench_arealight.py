"""The area-light cell's entry (`entries/arealight_frame.py`) on the CPU at
a 16x16 frame, the teapot subdivided once: the whole run but the card
agrees with the reference as good as exactly, and the frame faults of
`test_rtbench_faults.py` (half the frame left out, every fourth row off
by two levels) come out as not correct, as they do for `whitted_frame`,
whose steps and pixels this entry shares; so does a program that leaves
the light out, by the light's own number. (The port's former light draws
in sorted order are refused in `tests/test_torch_arealight_reference.py`.)"""

import pytest

from rtbench import spec
from rtbench.harness import Reservoir, judge, window
from rtbench.tests.conftest import tiny_cell
from rtbench.tests.test_rtbench_control import cut
from rtbench.tests.test_rtbench_faults import FAULTS, Broken

CELL = "teapot_1m6.arealight"


def _entry(seed):
    cell = cut(tiny_cell(CELL))
    e = spec.entry(cell.traffic).Entry(cell.config, cell.traffic, seed,
                                       "cpu")
    e.setup()
    return cell, e


def test_port_on_the_cpu_agrees_with_the_reference():
    cell, e = _entry(2 ** 31 + 5)
    res = Reservoir(2, 9)
    window(e, 0.0, res)
    window(e, 0.0, res)
    kept = e.release(res.items)
    correct, failed, checks = judge([e.check(it) for it in kept],
                                    cell.limits)
    assert correct and failed == 0
    for c in checks.values():
        assert c["value"] <= 1e-5


@pytest.mark.parametrize("fault", FAULTS["whitted_frame"],
                         ids=lambda f: f.__name__)
def test_frame_faults_come_out_incorrect(fault):
    cell, e = _entry(4242)
    res = Reservoir(1, 0)
    window(Broken(e, fault), 0.0, res)
    (item,) = e.release(res.items)
    correct, failed, checks = judge([e.check(item)], cell.limits)
    assert not correct and failed == 1, checks


def test_frame_without_the_light_comes_out_incorrect():
    cell, e = _entry(2 ** 40 + 3)
    e.lights = None
    res = Reservoir(2, 1)
    window(e, 0.0, res)
    window(e, 0.0, res)
    kept = e.release(res.items)
    numbers = [e.check(it) for it in kept]
    correct, failed, checks = judge(numbers, cell.limits)
    assert not correct and failed == len(kept), checks
    for n in numbers:
        assert n["light_bad_px_share"] > cell.limits["light_bad_px_share"]
