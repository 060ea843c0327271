"""The port's spans and counters (`utils.profiling`) on the CPU, through
the plain versions of the kernels, and the reduction of a trace with spans
(`tools/trace_cells.py`) on synthetic traces.

Bars: with tracing off a span is the one shared no-op and a profiled frame
holds no `rt.*` event; with it on the frame's spans nest rt.frame >
rt.chunk > rt.level > rt.query > rt.walk, one `rt.sync` for each host
sync the test counts itself, and the image is the same; `rays.level<d>`,
`alive.level<d>` and the walks' visits equal what the test counts at the
level's boundaries; an area light's `rt.area_light` a level around its
shadow queries, `rays.area_light` and `alive.area_light` as the test
counts them, and the same operations with the spans on as off; an
inverse-fit step's rt.fit around rt.refit, rt.backward (rt.grad inside)
and rt.optim, and its `fit.steps`, `grad.rays`, `refit.slots` and
`grad.hit`; the reduction's self times, idle attribution (the innermost
span over every host thread) and the harness's own reading of the same
trace are exact on small traces.
"""

import collections
import contextlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracing_tpu_torch import RenderConfig, build_cluster_accel
from raytracing_tpu_torch.geometry.scene import build_default_scene
from raytracing_tpu_torch.kernels import traverse as T
from raytracing_tpu_torch.models import path_tracer, whitted
from raytracing_tpu_torch.utils import profiling as P
from rtbench import trace as RT
from tools import trace_cells as TC

torch.set_num_threads(2)

# Two chunks; level 1 has reflect and fan children, level 2 reflect ones,
# level 3 none: two host syncs a chunk where level 2 runs.
CFG = RenderConfig(width=16, height=16, samples_per_pixel=1, chunk_size=128,
                   reflect_depth=3, diffuse_depth=2, diffuse_scatter=2)


@pytest.fixture(scope="module")
def scene_accel():
    scene = build_default_scene(t=0.0, device="cpu")
    return scene, build_cluster_accel(scene.mesh, cluster_size=16)


@pytest.fixture(autouse=True)
def switches_off():
    """Every test starts and ends with tracing and counting off."""
    P.tracing(False)
    P.counting(False)
    yield
    assert not P.tracing(False) and not P.counting(False)


def _frame(scene_accel, cfg=CFG):
    scene, accel = scene_accel
    return whitted.render(scene, cfg, accel=accel,
                          generator=torch.Generator().manual_seed(7))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("rt.")]


def test_span_off_is_the_shared_no_op_and_records_nothing(scene_accel):
    """Tracing off: `span` returns one shared object whatever it is given,
    `spanned` calls straight through, and a profiled frame of the plain
    backend holds no rt.* event; `host_sync` still counts."""
    assert P.span("rt.a") is P.span("rt.b", depth=2) is P._NO_SPAN
    with P.span("rt.a") as s:
        assert s is None
    assert P.spanned("rt.x")(lambda a, b=1: a + b)(1, b=2) == 3
    P.COUNTERS.reset()
    _, spans = _profiled(lambda: _frame(scene_accel))
    assert spans == []
    assert P.COUNTERS.read()["syncs.level"] > 0


def _parents(spans):
    """Each span's innermost enclosing span (by time; None at the top)."""
    evs = sorted(spans, key=lambda e: (e.time_range.start,
                                       -e.time_range.end))
    out, stack = {}, []
    for e in evs:
        while stack and stack[-1].time_range.end <= e.time_range.start:
            stack.pop()
        out[id(e)] = stack[-1] if stack else None
        stack.append(e)
    return out


def test_spans_nest_by_layer_and_mark_every_sync(scene_accel, monkeypatch):
    """Tracing on: rt.frame > rt.chunk > rt.level > rt.query > rt.walk,
    the glue's spans under a level, one rt.sync for each sync the test
    counts: one a chunk per level with children that runs, and one a
    gathered refinement's list narrowing (`_REFINE_DENSE_MAX_C` 0 sends
    every bounce query there), each counted by a wrapper of its own. The
    image equals the untraced one."""
    want = _frame(scene_accel)
    monkeypatch.setattr(T, "_REFINE_DENSE_MAX_C", 0)
    narrowed, children = [], []
    real_narrow, real_children = T._narrow_lists, whitted._children

    def narrow(*a):
        narrowed.append(1)
        return real_narrow(*a)

    def kids(*a):
        out = real_children(*a)
        children.append(bool(out[2].any()))
        return out

    monkeypatch.setattr(T, "_narrow_lists", narrow)
    monkeypatch.setattr(whitted, "_children", kids)
    P.COUNTERS.reset()
    P.tracing(True)
    try:
        got, spans = _profiled(lambda: _frame(scene_accel))
    finally:
        P.tracing(False)
    assert torch.equal(got, want)
    names = [e.name for e in spans]
    assert names.count("rt.frame") == 1 and names.count("rt.chunk") == 2
    parent = _parents(spans)
    chain = {"rt.chunk": "rt.frame", "rt.level": ("rt.chunk", "rt.radiance",
                                                  "rt.level"),
             "rt.query": ("rt.level", "rt.shade"),
             "rt.walk": ("rt.query", "rt.walk")}
    for e in spans:
        if e.name in chain:
            up = parent[id(e)]
            assert up is not None and up.name in chain[e.name], (e.name, up)
    for e in spans:  # every span lies inside the frame
        top = e
        while parent[id(top)] is not None:
            top = parent[id(top)]
        assert top.name == "rt.frame"
    assert {"rt.lists", "rt.pack", "rt.merge", "rt.shade", "rt.children",
            "rt.bin", "rt.unsort", "rt.radiance",
            "rt.camera_rays"} <= set(names)
    syncs = len(children) + len(narrowed)
    assert len(narrowed) > 0 and names.count("rt.sync") == syncs
    counts = P.COUNTERS.read()
    assert counts["syncs.level"] == len(children)
    assert counts["syncs.narrow_lists"] == len(narrowed)


def test_level_counters_equal_the_level_sizes(scene_accel, monkeypatch):
    """`rays.level<d>` is the sum of level d's sizes over the chunks (the
    chunk at level 1, the children a level made at the next), always;
    `alive.level<d>` their alive lanes, under counting only."""
    made = {}
    real = whitted._children

    def kids(d_l, h, sh, config, depth, uniforms):
        out = real(d_l, h, sh, config, depth, uniforms)
        if bool(out[2].any()):
            n, a = made.get(depth + 1, (0, 0))
            made[depth + 1] = (n + out[2].shape[0], a + int(out[2].sum()))
        return out

    monkeypatch.setattr(whitted, "_children", kids)
    P.COUNTERS.reset()
    _frame(scene_accel)
    counts = P.COUNTERS.read()
    assert not any(k.startswith("alive.") for k in counts)
    made.clear()
    P.COUNTERS.reset()
    P.counting(True)
    try:
        _frame(scene_accel)
        counts = P.COUNTERS.read()
    finally:
        P.counting(False)
    rays = 16 * 16
    assert counts["rays.level1"] == counts["alive.level1"] == rays
    assert made[2][0] == 3 * rays  # a reflect ray and a fan of 2 each
    for depth, (n, a) in made.items():
        assert counts[f"rays.level{depth}"] == n
        assert counts[f"alive.level{depth}"] == a
    assert {k for k in counts if k.startswith("rays.level")} == {
        f"rays.level{d}" for d in [1, *made]}


def test_walk_counters_on_the_plain_walks(scene_accel):
    """Under counting a walk adds its listed visits, its visits (every
    listed one: the plain versions exit nothing early) and the lane tests
    (visits x the tile's rays x the cluster size); off, nothing."""
    scene, accel = scene_accel
    from raytracing_tpu_torch.models.camera import (block_ray_ids,
                                                    camera_rays_for_ids)

    o, d = camera_rays_for_ids(block_ray_ids(0, 2048, CFG.replace(
        width=64, height=64), device="cpu"), CFG.replace(width=64, height=64))
    rp, _ = T._pad_rays_soa(T.rays_to_soa(o, d))
    args, kw = T._groups_walk_args(accel, rp, 1e-8, True, T.INF, 0)
    P.COUNTERS.reset()
    T.walk(*args, **kw)
    assert not P.COUNTERS.device
    P.counting(True)
    try:
        T.walk(*args, **kw)
        counts = P.COUNTERS.read()
    finally:
        P.counting(False)
    cnt = args[2]
    listed = int(torch.clamp(cnt, 0, args[1].shape[1]).sum())
    assert counts["walk.listed"] == counts["walk.visits"] == listed > 0
    assert counts["walk.lane_tests"] == listed * T.RAY_TILE * 16


def test_path_tracer_marks_its_sync(scene_accel):
    """The path tracer's `alive.any()` a bounce is a counted host sync."""
    scene, accel = scene_accel
    P.COUNTERS.reset()
    path_tracer.render(scene, RenderConfig(width=8, height=8),
                       path_tracer.PathTracerConfig(max_bounces=3,
                                                    samples_per_pixel=1),
                       accel=accel)
    assert 1 <= P.COUNTERS.read()["syncs.path_alive"] <= 2


def test_profile_trace_shows_the_spans(scene_accel, tmp_path):
    """The CLI's `--profile` exporter switches the spans on for its block,
    so its Chrome trace names them, and restores the switch."""
    scene, accel = scene_accel
    from raytracing_tpu_torch.utils.profiling import profile_trace

    with profile_trace(str(tmp_path)):
        whitted.render(scene, CFG.replace(reflect_depth=1, diffuse_depth=1),
                       accel=accel)
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"rt.frame", "rt.chunk", "rt.level", "rt.query",
            "rt.walk"} <= names


def test_counters_read_and_reset():
    """Host counts add as ints, device counts as tensors read in one go;
    reset zeroes the launches and drops the rest."""
    P.COUNTERS.reset()
    P.COUNTERS.add("syncs.x")
    P.COUNTERS.add("syncs.x", 2)
    P.COUNTERS.add_device("alive.x", torch.tensor([True, False, True]).sum())
    P.COUNTERS.add_device("alive.x", 4)
    P.COUNTERS.add_device("walk.y", 5)
    T.LAUNCHES["walk"] += 2
    got = P.COUNTERS.read()
    assert got["syncs.x"] == 3 and got["alive.x"] == 6 and got["walk.y"] == 5
    assert got["launches.walk"] == 2
    assert all(isinstance(v, int) for v in got.values())
    P.COUNTERS.reset()
    assert P.COUNTERS.read() == {f"launches.{k}": 0 for k in T.LAUNCHES}


# --- the reduction of a trace with spans (tools/trace_cells.py) ----------

Op = RT.Op


def synthetic_ops():
    """One step: a frame span over 0-1000 with a level, inside it a query
    (a walk in it) and a shade span; the host's aten ops; device ops
    leaving gaps 100-200 (under rt.walk), 300-450 (rt.shade, midpoint 375),
    600-700 (rt.level, its own time), 800-1000 (rt.frame, the level
    closed at 850); a GPU-side
    annotation of rt.walk that is no device operation."""
    host = [Op("rt.frame", 0, 1000, False, 1),
            Op("rt.level", 50, 850, False, 1),
            Op("rt.query", 60, 250, False, 1),
            Op("rt.walk", 80, 240, False, 1),
            Op("rt.shade", 260, 500, False, 1),
            Op("rt.sync", 700, 760, False, 1),
            Op("aten::add", 300, 320, False, 1),
            Op("cudaLaunchKernel", 90, 95, False, 1),
            Op("step", 0, 1000, False, 1)]
    dev = [Op("walk_kernel", 0, 100, True),
           Op("elementwise_kernel", 200, 300, True),
           Op("sort", 450, 600, True),
           Op("Memcpy DtoH", 700, 800, True),
           Op("rt.walk", 95, 240, True)]
    return host + dev


def test_self_time_of_nested_spans():
    got = TC.self_us([o for o in synthetic_ops() if o.name.startswith("rt.")
                      and not o.device])
    assert got == {"rt.frame": 200.0, "rt.level": 800 - 190 - 240 - 60,
                   "rt.query": 30.0, "rt.walk": 160.0, "rt.shade": 240.0,
                   "rt.sync": 60.0}


def test_idle_by_innermost_span_and_the_layer_shares():
    r = TC.span_reading(synthetic_ops(), steps=1)
    assert r["launches"] == 4 and r["spans"] == 6
    assert r["busy_s"] == pytest.approx(450e-6)
    idle = r["idle_by_span_s"]
    assert idle == pytest.approx({"rt.walk": 100e-6, "rt.shade": 150e-6,
                                  "rt.level": 100e-6, "rt.frame": 200e-6})
    assert r["idle_s"] == pytest.approx(550e-6)
    assert r["idle_in_glue_pct"] == pytest.approx(100 * 150 / 550)
    assert r["idle_in_layer_pct"] == pytest.approx(100 * 250 / 550)
    assert r["sync_ms"] == pytest.approx(0.06)
    assert r["launch_calls_by_span"] == {"rt.walk": 1}
    assert r["glue_host_ms"] == pytest.approx(0.24)


def test_the_harness_reading_is_the_same_without_the_spans():
    """The spans are left out of what the harness's reduction reads: the
    trace with spans, split by `split_ops`, reads as the one without."""
    ops = synthetic_ops()
    dev, host, _ = TC.split_ops(ops)
    bare = [o for o in ops if not o.name.startswith("rt.")]
    a = RT.reduce_ops(dev + host, steps=1, step_s=0.001, window_s=0.001)
    b = RT.reduce_ops(bare, steps=1, step_s=0.001, window_s=0.001)
    assert a == b and a.launches == 4
    assert TC.idle_gaps(dev, host) == [(100, 200), (300, 450), (600, 700),
                                       (800, 1000)]


def test_layer_numbers_of_a_counted_step():
    reading = dict(sync_ms=1.5, glue_host_ms=20.0, idle_in_glue_pct=40.0)
    counts = {"syncs.level": 100, "syncs.narrow_lists": 20,
              "rays.level1": 10, "rays.level2": 30, "rays.level3": 10,
              "alive.level1": 10, "alive.level2": 12, "alive.level3": 3,
              "walk.lane_tests": 99}
    got = TC.layer_numbers("whitted", reading, counts)
    assert got == {"syncs_per_frame.whitted": 120,
                   "sync_wait_ms_per_frame.whitted": 1.5,
                   "glue_host_ms_per_frame.whitted": 20.0,
                   "idle_in_glue_pct.whitted": 40.0,
                   "bounce_alive_pct.whitted": pytest.approx(37.5),
                   "walk_lane_tests_per_frame.whitted": 99}
    got = TC.layer_numbers("primary", reading, {"walk.lane_tests": 7})
    assert got["walk_lane_tests_per_call.primary"] == 7
    assert got["syncs_per_call.primary"] == 0


def test_area_light_span_and_counters(scene_accel, monkeypatch):
    """A frame with an area light: one `rt.area_light` a level (lights,
    samples and the level's rays as args), inside its level and holding
    each of its shadow queries; `rays.area_light` is the levels' rays x
    lights x samples, and under counting `alive.area_light` the shadow rays
    alive after the hit and n.l > 0 mask, as the test counts them itself.
    Spans on or off, the frame dispatches the same operations but the
    spans' own and makes the same image; counting off, there is no device
    count. (A recording wrapper of the module's `span` reads the nesting,
    and a dispatch mode the operations: a profiler over the plain walks'
    operations takes minutes.)"""
    from torch.utils._python_dispatch import TorchDispatchMode

    from raytracing_tpu_torch.geometry.mesh import Scene, SphereLight

    scene, accel = scene_accel
    lit = Scene(scene.mesh, scene.sun, SphereLight(
        torch.tensor([[1.0, 8.0, 7.0]]), torch.tensor([1.5]),
        torch.tensor([[1.5, 1.5, 1.5]])))
    cfg = CFG.replace(width=8, height=8, chunk_size=32, reflect_depth=2,
                      light_samples=2)
    stack, seen, queries, alive = [], [], [], []
    real_span, real_any, real_rays = (whitted.span, whitted.any_hit,
                                      whitted.light_shadow_rays)

    @contextlib.contextmanager
    def span(name, **args):
        seen.append((name, stack[-1] if stack else None, args))
        stack.append(name)
        try:
            with real_span(name, **args):
                yield
        finally:
            stack.pop()

    def any_hit(*a, **kw):
        queries.append("rt.area_light" in stack)
        return real_any(*a, **kw)

    def shadow_rays(*a):
        out = real_rays(*a)
        alive.append(int(out[2].sum()))
        return out

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not str(func).startswith("profiler."):
                self.names[str(func)] += 1
            return func(*args, **(kwargs or {}))

    def frame(ops=None):
        with ops or contextlib.nullcontext():
            return whitted.render(lit, cfg, accel=accel,
                                  generator=torch.Generator().manual_seed(7))

    monkeypatch.setattr(whitted, "span", span)
    monkeypatch.setattr(whitted, "any_hit", any_hit)
    monkeypatch.setattr(whitted, "light_shadow_rays", shadow_rays)
    frame()  # what a first frame builds once is left out below
    P.COUNTERS.reset()
    off = Ops()
    want = frame(off)
    counts = P.COUNTERS.read()
    assert not any(k.startswith("alive.") for k in counts)
    levels = sum(v for k, v in counts.items() if k.startswith("rays.level"))
    assert counts["rays.area_light"] == levels * 1 * 2
    seen.clear()
    queries.clear()
    P.tracing(True)
    try:
        on = Ops()
        got = frame(on)
    finally:
        P.tracing(False)
    assert torch.equal(got, want) and on.names == off.names
    lights = [(up, args) for name, up, args in seen
              if name == "rt.area_light"]
    level_rays = sorted(args["rays"] for name, _, args in seen
                        if name == "rt.level")
    assert len(lights) == len(level_rays) == 4  # 2 chunks, 2 levels
    assert all(up == "rt.level" for up, _ in lights)
    assert sorted(a["rays"] for _, a in lights) == level_rays
    assert all(a["lights"] == 1 and a["samples"] == 2 for _, a in lights)
    assert sum(queries) == 2 * len(lights) and not all(queries)
    alive.clear()
    P.COUNTERS.reset()
    P.counting(True)
    try:
        frame()
        counts = P.COUNTERS.read()
    finally:
        P.counting(False)
    assert len(alive) == 2 * len(lights)
    assert counts["alive.area_light"] == sum(alive) > 0


def test_idle_under_the_area_light_span():
    """`idle_in_area_light_pct` takes the gaps whose midpoint lies inside an
    `rt.area_light` span at any depth; the area-light numbers appear only
    where the counts have area-light rays."""
    ops = synthetic_ops() + [Op("rt.area_light", 255, 520, False, 1)]
    r = TC.span_reading(ops, steps=1)
    assert r["idle_in_area_light_pct"] == pytest.approx(100 * 150 / 550)
    assert TC.span_reading(synthetic_ops(), 1)["idle_in_area_light_pct"] == 0
    reading = dict(sync_ms=0.0, glue_host_ms=0.0, idle_in_glue_pct=0.0,
                   idle_in_area_light_pct=12.5)
    got = TC.layer_numbers("whitted", reading, {"rays.area_light": 40,
                                                "alive.area_light": 10})
    assert got["area_light_alive_pct.arealight"] == pytest.approx(25.0)
    assert got["idle_in_area_light_pct.arealight"] == 12.5
    assert "area_light_alive_pct.arealight" not in TC.layer_numbers(
        "whitted", reading, {})


def test_fit_spans_and_counters():
    """A pose + vertex fit step with the refit: rt.fit around
    rt.refit, rt.backward (the backward functions' rt.grad inside it: on
    the CPU autograd runs them on the calling thread) and rt.optim;
    `fit.steps`, `grad.rays` (the differentiated nearest queries' lanes,
    every level's), `refit.slots`; under counting `grad.hit`, the hit
    lanes the backward scatters from, at most those lanes. Spans off, the
    step records no span and gives the same loss."""
    import numpy as np

    from raytracing_tpu_torch.geometry.mesh import Scene, concat_objects
    from raytracing_tpu_torch.models import inverse

    # A tetrahedron (one cluster of 4) over a floor (the rest set).
    tet = {"verts": np.array([[-1, -1, 4], [1, -1, 4], [0, -1, 6],
                              [0, 1, 5]], np.float32),
           "tri_v": np.array([[0, 3, 1], [1, 3, 2], [2, 3, 0], [0, 1, 2]],
                             np.int32),
           "colors": np.array([0.9, 0.3, 0.2], np.float32),
           "material": (1.0, 0.5, 0.5)}
    floor = {"verts": np.array([[-9, -1, 0], [-9, -1, 9], [9, -1, 9],
                                [9, -1, 0]], np.float32),
             "tri_v": np.array([[0, 1, 2], [0, 2, 3]], np.int32),
             "colors": np.array([0.8, 0.8, 0.8], np.float32),
             "normals": np.array([[0, 1, 0], [0, 1, 0]], np.float32),
             "material": (1.0, 0.0, 1.0)}
    scene = Scene(concat_objects([tet, floor]),
                  torch.tensor([3.0, 9.0, 1.0]))
    accel = build_cluster_accel(scene.mesh, cluster_size=4)
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1,
                       diffuse_scatter=2)
    target = torch.full((8, 8, 3), 0.5)
    params = {"pose": torch.tensor([0.0, 0.02, 0.0, 0.01, 0.0, 0.0]),
              "verts": scene.mesh.verts}
    idx = torch.arange(64)

    def step():
        f = inverse.Fitter(scene, target, params, cfg, accel=accel)
        return f.step(idx, lambda tag, shape: torch.full(shape, 0.25))

    P.COUNTERS.reset()
    loss_off, events = _profiled(step)
    assert not events
    counts = P.COUNTERS.read()
    assert counts["fit.steps"] == 1
    assert counts["grad.rays"] == sum(v for k, v in counts.items()
                                      if k.startswith("rays.level"))
    n_rest = accel.rest_ids.shape[0]
    assert counts["refit.slots"] == accel.order.shape[0] + n_rest
    P.tracing(True)
    try:
        loss_on, events = _profiled(step)
    finally:
        P.tracing(False)
    assert loss_on == loss_off
    names = collections.Counter(e.name for e in events)
    assert names["rt.fit"] == names["rt.backward"] == names["rt.optim"] == 1
    assert names["rt.refit"] == 1 and names["rt.grad"] >= 1
    fit = next(e for e in events if e.name == "rt.fit")
    back = next(e for e in events if e.name == "rt.backward")
    for e in events:
        if e.name in ("rt.refit", "rt.backward", "rt.optim"):
            assert fit.time_range.start <= e.time_range.start \
                and e.time_range.end <= fit.time_range.end, e.name
        if e.name == "rt.grad":
            assert back.time_range.start <= e.time_range.start \
                and e.time_range.end <= back.time_range.end
    P.counting(True)
    try:
        P.COUNTERS.reset()
        step()
        counts = P.COUNTERS.read()
    finally:
        P.counting(False)
    assert 0 < counts["grad.hit"] <= counts["grad.rays"]


def test_innermost_span_over_threads_and_the_backward_shares():
    """The backward's spans on autograd's thread: a gap under both the
    main thread's rt.backward and the other thread's rt.grad is rt.grad's;
    `idle_in_backward_pct` and `backward_device_pct` read rt.backward at
    any depth; the fit's layer numbers."""
    host = [Op("rt.fit", 0, 1000, False, 1),
            Op("rt.backward", 300, 900, False, 1),
            Op("rt.optim", 900, 950, False, 1),
            Op("rt.grad", 350, 700, False, 7),
            Op("cudaLaunchKernel", 360, 365, False, 7),
            Op("cudaLaunchKernel", 910, 915, False, 1),
            Op("step", 0, 1000, False, 1)]
    dev = [Op("walk_kernel", 0, 300, True),
           Op("elementwise_kernel", 500, 800, True),
           Op("elementwise_kernel", 920, 940, True)]
    r = TC.span_reading(host + dev, steps=1)
    assert r["idle_by_span_s"] == pytest.approx(
        {"rt.grad": 200e-6, "rt.backward": 120e-6, "rt.fit": 60e-6})
    assert r["launch_calls_by_span"] == {"rt.grad": 1, "rt.optim": 1}
    assert r["idle_in_backward_pct"] == pytest.approx(100 * 320 / 380)
    assert r["backward_device_pct"] == pytest.approx(100 * 300 / 620)
    assert r["idle_in_glue_pct"] == pytest.approx(100 * 200 / 380)
    assert TC.innermost(host, [320, 400, 920, 2000]) == [
        "rt.backward", "rt.grad", "rt.optim", "no host operation"]
    got = TC.layer_numbers("fit", dict(r, refit_ms=1.5),
                           {"grad.rays": 40, "grad.hit": 10,
                            "syncs.level": 3})
    assert got["grad_hit_pct.fit"] == pytest.approx(25.0)
    assert got["refit_host_ms_per_step.fit"] == 1.5
    assert got["syncs_per_step.fit"] == 3
    assert got["idle_in_backward_pct.fit"] == r["idle_in_backward_pct"]
