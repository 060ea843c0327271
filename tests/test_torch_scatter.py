"""The backward's segment scatter-add off the card: which line
`ops.scatter.segment_scatter_add` takes, and how the kernel's wrapper
refuses what it cannot take.

On the card every call goes to csrc/scatter.cu (`kernels.scatter`);
tests/test_torch_gpu.py holds it to `index_add_` there. Here, on the CPU:
the call never reaches the kernel's entry and gives the bits of
`index_add_` into one extra drop row; an index at or beyond the table's
rows, or below 0, is dropped; under counting `scatter.rows` and
`scatter.added` count the lanes given and those in range (in a backward,
the skipped lanes are the three corners of every lane without a hit); the
arguments the card's route hands the kernel, sorted under deterministic
algorithms; what the card's route refuses; and the wrapper raises
ValueError on a wrong dtype, shape, layout or device before it loads the
library.
"""

import numpy as np
import pytest
import torch

from raytracing_tpu_torch.kernels import cuda
from raytracing_tpu_torch.kernels import scatter as SK
from raytracing_tpu_torch.kernels import traverse as T
from raytracing_tpu_torch.ops import scatter as S
from raytracing_tpu_torch.utils import profiling as P

torch.set_num_threads(2)


def _no_kernel(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the scatter kernel's entry was reached")

    monkeypatch.setattr(SK, "scatter_add", refuse)
    monkeypatch.setattr(cuda, "library", refuse)


def _inputs(rows, k, n_rows, dtype, share=0.3, seed=0):
    g = torch.Generator().manual_seed(seed)
    vals = torch.randn(rows, k, generator=g)
    idx = torch.randint(0, n_rows, (rows,), generator=g)
    idx = torch.where(torch.rand(rows, generator=g) < share, idx, n_rows)
    return idx.to(dtype), vals


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64],
                         ids=["i32", "i64"])
@pytest.mark.parametrize("k", [1, 3, 6, 9])
def test_cpu_takes_index_add_bit_for_bit(monkeypatch, k, dtype):
    """Off the card the kernel's entry is never reached and the table is
    `index_add_` into n_rows + 1 rows, the last dropped, bit for bit."""
    _no_kernel(monkeypatch)
    idx, vals = _inputs(5000, k, 311, dtype)
    want = torch.zeros(312, k)
    want.index_add_(0, torch.clamp_max(idx.long(), 311), vals)
    got = S.segment_scatter_add(311, idx, vals)
    assert got.shape == (311, k)
    assert torch.equal(got, want[:311])


def test_cpu_takes_index_add_for_float64_and_1d(monkeypatch):
    """float64 values and values without a column axis take the plain
    line too (on the card they are refused)."""
    _no_kernel(monkeypatch)
    idx, vals = _inputs(800, 3, 50, torch.int64)
    got = S.segment_scatter_add(50, idx, vals.double())
    assert got.dtype == torch.float64 and got.shape == (50, 3)
    got1 = S.segment_scatter_add(50, idx, vals[:, 0].contiguous())
    want1 = torch.zeros(51).index_add_(0, idx, vals[:, 0])
    assert torch.equal(got1, want1[:50])


@pytest.mark.parametrize("case", ["at_bucket", "beyond", "far", "empty",
                                  "negative"])
def test_out_of_range_indices_are_dropped(case):
    """An index at n_rows, past it, far past it (2**40) or below 0 adds
    nothing and is not counted as added; no lanes give a table of zeros."""
    rng = np.random.default_rng(4)
    n_rows = 9
    idx = rng.integers(0, n_rows, 300)
    out_of_range = {"at_bucket": n_rows, "beyond": n_rows + 3,
                    "far": 2 ** 40, "empty": n_rows, "negative": -3}[case]
    idx[rng.uniform(size=300) < 0.6] = out_of_range
    vals = rng.standard_normal((300, 4)).astype(np.float32)
    if case == "empty":
        idx, vals = idx[:0], vals[:0]
    live = (idx >= 0) & (idx < n_rows)
    want = np.zeros((n_rows, 4), np.float32)
    np.add.at(want, idx[live], vals[live])
    P.COUNTERS.reset()
    was = P.counting(True)
    try:
        got = S.segment_scatter_add(n_rows, torch.from_numpy(idx),
                                    torch.from_numpy(vals))
        c = P.COUNTERS.read()
    finally:
        P.counting(was)
    assert got.shape == (n_rows, 4)
    assert c["scatter.added"] == int(live.sum())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_counting_counts_the_lanes_given_and_in_range():
    """Under counting: `scatter.rows` the lanes given, `scatter.added` the
    lanes whose index is in range; off, neither is counted."""
    idx, vals = _inputs(1000, 3, 40, torch.int64, share=0.25)
    P.COUNTERS.reset()
    S.segment_scatter_add(40, idx, vals)
    assert "scatter.rows" not in P.COUNTERS.read()
    was = P.counting(True)
    try:
        S.segment_scatter_add(40, idx, vals)
        S.segment_scatter_add(40, idx[:100], vals[:100])
        c = P.COUNTERS.read()
    finally:
        P.counting(was)
    assert c["scatter.rows"] == 1100
    assert c["scatter.added"] == int((idx < 40).sum()
                                     + (idx[:100] < 40).sum())


def test_backward_skips_the_corners_of_lanes_without_a_hit(monkeypatch):
    """A differentiated render of verts under counting: the scatters skip
    exactly the three corners of every lane without a hit, and add three
    for each hit plus each query's corner rows into the vertices."""
    from raytracing_tpu_torch import RenderConfig, build_cluster_accel
    from raytracing_tpu_torch.geometry.mesh import concat_objects
    from raytracing_tpu_torch.models.whitted import render_rays

    mesh = concat_objects([{
        "verts": np.array([[-2.0, -2.0, 5.0], [3.0, -2.0, 5.0],
                           [-2.0, 3.0, 5.0], [4.0, 3.0, 6.0]], np.float32),
        "tri_v": np.array([[0, 2, 1], [1, 2, 3]], np.int32),
        "colors": np.array([0.8, 0.6, 0.4], np.float32),
        "material": (1.0, 0.5, 0.5)}])
    acc = build_cluster_accel(mesh, cluster_size=8)
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1,
                       reflect_depth=2, diffuse_depth=1, diffuse_scatter=2)
    xs = torch.linspace(-0.5, 0.5, 32)
    o = torch.zeros(32, 3)
    d = torch.stack([xs, xs * 0.5, torch.ones(32)], dim=-1)
    verts = mesh.verts.clone().requires_grad_()
    g = torch.Generator().manual_seed(1)
    tables = []

    def spy(n_rows, idx, vals):
        tables.append(n_rows)
        return S.segment_scatter_add(n_rows, idx, vals)

    monkeypatch.setattr(T, "segment_scatter_add", spy)
    P.COUNTERS.reset()
    was = P.counting(True)
    try:
        rgb = render_rays(mesh._replace(verts=verts), acc,
                          torch.tensor([200.0, 300.0, -1000.0]), o, d, cfg,
                          lambda tag, shape: torch.rand(shape, generator=g))
        (rgb * rgb).sum().backward()
        c = P.COUNTERS.read()
    finally:
        P.counting(was)
    queries = tables.count(4)        # each query's scatter into 4 verts
    assert queries >= 2 and len(tables) == 2 * queries
    assert 0 < c["grad.hit"] < c["grad.rays"]
    assert c["scatter.rows"] - c["scatter.added"] == 3 * (
        c["grad.rays"] - c["grad.hit"])
    assert c["scatter.added"] == 3 * c["grad.hit"] + queries * 3 * 2


def test_card_route_hands_the_kernel_its_arguments(monkeypatch):
    """The card's route, with a stand-in for the kernel: a table of n_rows
    rows (no drop row), int32 indices as they are, other integer indices
    as int64, rows a stride apart as they are, column-strided values made
    contiguous, no sort order; under counting an int64 [] count on the
    values' device."""
    seen = []

    def fake(out, idx, vals, added=None, order=None):
        assert order is None
        seen.append((tuple(out.shape), idx.dtype, idx.is_contiguous(),
                     vals.stride(), added))
        S.index_add_rows(out.shape[0], idx, vals)

    monkeypatch.setattr(S, "_takes_kernel", lambda vals: True)
    monkeypatch.setattr(SK, "scatter_add", fake)
    idx, vals = _inputs(64, 9, 20, torch.int32)
    S.segment_scatter_add(20, idx, vals[:, 0:6])
    S.segment_scatter_add(20, idx.to(torch.int16), vals[:, 0:3])
    S.segment_scatter_add(20, idx.long(), vals.T.contiguous().T[:, 0:3])
    was = P.counting(True)
    try:
        S.segment_scatter_add(20, idx, vals)
    finally:
        P.counting(was)
    assert seen[0][:4] == ((20, 6), torch.int32, True, (9, 1))
    assert seen[1][:4] == ((20, 3), torch.int64, True, (9, 1))
    assert seen[2][:4] == ((20, 3), torch.int64, True, (3, 1))
    assert all(s[4] is None for s in seen[:3])
    added = seen[3][4]
    assert added.dtype == torch.int64 and added.shape == ()


@pytest.mark.parametrize("case", ["f64", "f16", "k10", "k0", "1d"])
def test_card_route_refuses_what_the_kernel_cannot_take(monkeypatch, case):
    """On the card a call the kernel cannot take (values not float32, more
    than 9 or no columns, no column axis) raises ValueError before the
    kernel: nothing on the card falls back to another line."""
    def refuse(*a, **kw):
        raise AssertionError("the scatter kernel was called")

    monkeypatch.setattr(S, "_takes_kernel", lambda vals: True)
    monkeypatch.setattr(SK, "scatter_add", refuse)
    monkeypatch.setattr(S, "index_add_rows", refuse)
    idx, vals = _inputs(64, 3, 20, torch.int64)
    vals = {"f64": vals.double(), "f16": vals.half(),
            "k10": torch.ones(64, 10), "k0": torch.ones(64, 0),
            "1d": vals[:, 0].contiguous()}[case]
    with pytest.raises(ValueError, match="on the card takes float32"):
        S.segment_scatter_add(20, idx, vals)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64],
                         ids=["i32", "i64"])
def test_card_route_sorts_under_deterministic_algorithms(monkeypatch,
                                                         dtype):
    """Under deterministic algorithms the card's route hands the kernel
    the indices sorted and the stable sort's permutation (each row's lanes
    in lane order), so the kernel sums each row in one order."""
    seen = []

    def fake(out, idx, vals, added=None, order=None):
        seen.append((idx, order))

    monkeypatch.setattr(S, "_takes_kernel", lambda vals: True)
    monkeypatch.setattr(SK, "scatter_add", fake)
    idx, vals = _inputs(500, 3, 7, dtype, share=0.5)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        S.segment_scatter_add(7, idx, vals)
    finally:
        torch.use_deterministic_algorithms(was)
    (got_idx, order), = seen
    assert got_idx.dtype == dtype and order.dtype == torch.int64
    assert bool((got_idx[1:] >= got_idx[:-1]).all())
    assert torch.equal(idx[order], got_idx)
    same = got_idx[1:] == got_idx[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())


_OK = dict(out=lambda: torch.zeros(8, 3),
           idx=lambda: torch.zeros(16, dtype=torch.int64),
           vals=lambda: torch.ones(16, 3))
_BAD = {
    "idx_float": dict(idx=torch.zeros(16)),
    "idx_int16": dict(idx=torch.zeros(16, dtype=torch.int16)),
    "idx_2d": dict(idx=torch.zeros(16, 1, dtype=torch.int64)),
    "idx_strided": dict(idx=torch.zeros(32, dtype=torch.int64)[::2]),
    "vals_f64": dict(vals=torch.ones(16, 3, dtype=torch.float64)),
    "vals_k10": dict(vals=torch.ones(16, 10), out=torch.zeros(8, 10)),
    "vals_k0": dict(vals=torch.ones(16, 0), out=torch.zeros(8, 0)),
    "vals_rows": dict(vals=torch.ones(15, 3)),
    "vals_columns_strided": dict(vals=torch.ones(3, 16).T),
    "out_k": dict(out=torch.zeros(8, 4)),
    "out_strided": dict(out=torch.zeros(3, 8).T),
    "out_f64": dict(out=torch.zeros(8, 3, dtype=torch.float64)),
    "added_i32": dict(added=torch.zeros((), dtype=torch.int32)),
    "added_1d": dict(added=torch.zeros(1, dtype=torch.int64)),
    "order_i32": dict(order=torch.arange(16, dtype=torch.int32)),
    "order_short": dict(order=torch.arange(15)),
    "order_strided": dict(order=torch.arange(32)[::2]),
    "cpu": {},
}


@pytest.mark.parametrize("case", list(_BAD))
def test_wrapper_refuses_before_any_launch(monkeypatch, case):
    """Each wrong input raises ValueError naming the kernel before the
    library is loaded or a launch counted; right dtypes and shapes on the
    CPU are refused for their device."""
    _no_kernel_lib = []

    def refuse():
        _no_kernel_lib.append(1)
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(cuda, "library", refuse)
    args = {k: f() for k, f in _OK.items()}
    args["added"] = args["order"] = None
    args.update(_BAD[case])
    before = T.LAUNCHES.get("scatter", 0)
    match = "CUDA tensors" if case == "cpu" else "scatter kernel"
    with pytest.raises(ValueError, match=match):
        SK.scatter_add(args["out"], args["idx"], args["vals"], args["added"],
                       args["order"])
    assert not _no_kernel_lib
    assert T.LAUNCHES.get("scatter", 0) == before
