"""The end-to-end metrics take all the work over all the time of the
window, and the tail is over all its frames; the per-layer readers and
the trace reduction are right on a small synthetic trace."""

import statistics

import pytest

from rtbench import harness, spec, trace
from rtbench.entries import camera_primary, whitted_frame


class Stub:
    """An entry whose step k sleeps for the k-th of `times`."""

    def __init__(self, times):
        self.times = list(times)
        self.done = 0

    def step(self, k):
        import time
        t = time.perf_counter()
        while time.perf_counter() - t < self.times[k % len(self.times)]:
            pass
        self.done += 1
        return k

    def keep(self, k, out):
        return k


def test_window_counts_every_step_and_all_its_time():
    stub = Stub([0.01, 0.03])
    res = harness.Reservoir(3, 7)
    times, window_s = harness.window(stub, 0.2, res)
    assert stub.done == len(times) and len(times) >= 6
    assert window_s >= 0.2 and window_s == pytest.approx(sum(times), rel=0.05)
    assert len(res.items) == 3 and len(set(res.items)) == 3
    assert all(0 <= k < len(times) for k in res.items)


def test_reservoir_is_uniform_and_seeded():
    picks = []
    for seed in range(400):
        r = harness.Reservoir(2, seed)
        for k in range(10):
            r.offer(k)
        picks += r.items
    counts = [picks.count(k) for k in range(10)]
    assert min(counts) > 50 and max(counts) < 110
    a, b = harness.Reservoir(2, 5), harness.Reservoir(2, 5)
    for k in range(50):
        a.offer(k)
        b.offer(k)
    assert a.items == b.items


def test_frame_metrics_are_all_work_over_all_time():
    e = whitted_frame.Entry.__new__(whitted_frame.Entry)
    times = [0.5] * 18 + [1.0, 2.0]
    m = e.end_to_end(times, 12.0)
    assert m["frame_s"] == 12.0 / 20
    assert m["frame_p90_s"] == statistics.quantiles(
        times, n=10, method="inclusive")[8]
    assert 0.5 < m["frame_p90_s"] < 1.0 + 1e-12
    assert e.end_to_end([0.7], 0.7) == {"frame_s": 0.7, "frame_p90_s": 0.7}


def test_primary_rate_is_all_rays_over_all_time():
    e = camera_primary.Entry.__new__(camera_primary.Entry)
    e.width, e.height, e.spp = 800, 800, 4
    m = e.end_to_end([0.005] * 1000, 6.0)
    assert m == {"primary_rays_per_s": 2_560_000 * 1000 / 6.0}


def ops_of_two_steps():
    """Two steps; device ops of several layers and idle gaps in which the
    host was in a sort, a launch, or nothing."""
    Op = trace.Op
    host = [Op("step", 0, 1000, False, 1),
            Op("aten::sort", 100, 300, False, 1),
            Op("cudaLaunchKernel", 120, 130, False, 1),
            Op("aten::add", 600, 650, False, 1),
            Op("other thread", 0, 1000, False, 2)]
    dev = [Op("void walk_kernel<1>", 50, 100, True),
           Op("void refine_kernel", 300, 340, True),
           Op("void lists_kernel", 330, 400, True),     # overlaps the last
           Op("DeviceRadixSortOnesweep", 400, 420, True),
           Op("Memcpy DtoH", 500, 510, True),
           Op("elementwise_kernel<add>", 650, 700, True),
           Op("void gstream_kernel", 700, 800, True)]
    return host + dev


def test_reduction_of_a_synthetic_trace():
    r = trace.reduce_ops(ops_of_two_steps(), steps=2, step_s=0.001,
                         window_s=0.0012)
    assert r.launches == 7
    assert r.busy_s == pytest.approx((50 + 100 + 20 + 10 + 150) / 1e6)
    assert r.layer_ms["walk_k1_k2"] == pytest.approx(0.05)
    assert r.layer_ms["walk_k3_k4"] == pytest.approx(0.1)
    assert r.layer_ms["refine"] == pytest.approx(0.04)
    assert r.layer_ms["lists"] == pytest.approx(0.07)
    assert r.layer_ms["sorts"] == pytest.approx(0.02)
    assert r.layer_ms["memcpy"] == pytest.approx(0.01)
    assert r.layer_ms["glue"] == pytest.approx(0.05)
    assert r.device_ops[0] == ["gstream_kernel", pytest.approx(1e-4)]
    gaps = dict((n, s) for n, s in r.idle_gaps)
    # 0-50 in "step", 100-300 in the sort, 420-500 and 510-650 in "step"
    # (600-650's midpoint 580 falls outside aten::add), 800-1000 in "step"
    assert gaps["aten::sort"] == pytest.approx(200e-6)
    assert gaps["step"] == pytest.approx((50 + 80 + 140 + 200) * 1e-6)
    assert "other thread" not in gaps


def test_layer_readers_on_a_synthetic_trace():
    r = trace.reduce_ops(ops_of_two_steps(), steps=2, step_s=0.001,
                         window_s=0.0012)
    read = {m: spec.metric_reader(m) for m in (
        "device_idle_pct.whitted", "launches_per_frame.whitted",
        "walk_ms_per_frame.whitted", "refine_lists_ms_per_frame.whitted",
        "glue_ms_per_frame.whitted", "device_idle_pct.primary",
        "launches_per_call.primary", "walk_ms_per_call.primary",
        "lists_ms_per_call.primary", "glue_ms_per_call.primary")}
    busy = 330e-6
    assert read["device_idle_pct.whitted"](r) == pytest.approx(
        100 * (1 - busy / 2 / 0.001))
    assert read["device_idle_pct.primary"](r) == pytest.approx(
        100 * (1 - busy / 2 / 0.001))
    assert read["launches_per_frame.whitted"](r) == 3.5
    assert read["launches_per_call.primary"](r) == 3.5
    assert read["walk_ms_per_frame.whitted"](r) == pytest.approx(0.075)
    assert read["walk_ms_per_call.primary"](r) == pytest.approx(0.075)
    assert read["refine_lists_ms_per_frame.whitted"](r) == pytest.approx(
        0.055)
    assert read["glue_ms_per_frame.whitted"](r) == pytest.approx(0.04)
    assert read["lists_ms_per_call.primary"](r) == pytest.approx(0.055)
    assert read["glue_ms_per_call.primary"](r) == pytest.approx(0.04)


def test_readers_find_nothing_in_an_empty_trace():
    r = trace.reduce_ops([trace.Op("step", 0, 10, False)], steps=1,
                         step_s=1.0, window_s=1.0)
    for m in spec.load_benchmark()["per_layer"]:
        assert spec.metric_reader(m["name"])(r) is None
