"""Cells, configurations, traffic mixes, entries, limits and per-layer
metrics are found by name from files, and a new one is added by adding
files and BENCHMARK.json entries only."""

import json
import os
import shutil

import pytest

from rtbench import spec

CELLS = ("two_teapots.whitted", "teapot_1m6.whitted", "teapot_1m6.primary",
         "two_teapots.primary")


def test_benchmark_holds_the_cells_in_order():
    bench = spec.load_benchmark()
    assert tuple(w["name"] for w in bench["workloads"]) == CELLS
    assert all(w["chips"] == 1 for w in bench["workloads"])
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_from_its_files(name):
    bench = spec.load_benchmark()
    cell = spec.load_cell(name, bench)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer and cell.limits
    mod = spec.entry(cell.traffic)
    assert hasattr(mod, "Entry")
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in e2e


def test_every_file_named_exists():
    bench = spec.load_benchmark()
    root = spec.ROOT
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(root, c["file"]))
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(root, "rtbench", "metrics",
                                           m["name"] + ".py"))


def test_a_new_cell_is_files_and_entries_only(tmp_path):
    """A new configuration, mix, cell and metric in a copy of the
    benchmark: new files and new BENCHMARK.json entries, no edit."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "rtbench"), root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    conf = json.loads((root / "rtbench/configs/two_teapots.json").read_text())
    conf["render"]["width"] = conf["render"]["height"] = 1600
    (root / "rtbench/configs/two_teapots_1600.json").write_text(
        json.dumps(conf))
    (root / "rtbench/traffic/whitted_still.json").write_text(json.dumps(
        dict(json.loads((root / "rtbench/traffic/whitted_anim.json")
                        .read_text()), fps=1e9)))
    (root / "rtbench/limits/two_teapots_1600.still.json").write_text(
        json.dumps({"bad_px_share": 0.5, "mean_abs_err": 0.5}))
    (root / "rtbench/metrics/frames_profiled.py").write_text(
        "def read(reading):\n    return reading.steps\n")
    bench["configs"].append({"name": "two_teapots_1600", "source": "x",
                             "file": "rtbench/configs/two_teapots_1600.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "two_teapots_1600.still",
                               "config": "two_teapots_1600",
                               "traffic": "whitted_still", "chips": 1,
                               "why": "x"})
    bench["end_to_end"][1]["workloads"].append("two_teapots_1600.still")
    bench["per_layer"].append({"name": "frames_profiled", "unit": "frames",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "frame_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("two_teapots_1600.still", bench, str(root))
    assert cell.config["render"]["width"] == 1600
    assert cell.traffic["fps"] == 1e9
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "frame_s"]
    assert [m["name"] for m in cell.per_layer] == ["frames_profiled"]
    assert spec.metric_reader("frames_profiled", str(root))(
        type("R", (), {"steps": 3})()) == 3
    # the metric without a workloads list reaches every cell of frame_s
    old = spec.load_cell("two_teapots.whitted", bench, str(root))
    assert "frames_profiled" in [m["name"] for m in old.per_layer]
    assert spec.entry(cell.traffic, str(root)).Entry
