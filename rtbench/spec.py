"""Everything a run reads from files, found by name: the cell in
`BENCHMARK.json`, its configuration (`configs/<config>.json`, the file the
configuration entry names), its traffic mix (`traffic/<mix>.json`), the
entry that mix drives (`entries/<entry>.py`), the cell's limits of the
output check (`limits/<cell>.json`) and each per-layer metric's reader
(`metrics/<metric>.py`). Adding a cell, configuration, mix or metric adds
files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic mix's parameters
    limits: dict          # number compared -> its limit
    end_to_end: list      # the BENCHMARK.json metrics this cell reports
    per_layer: list


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def reports(metric: dict, cell: str, bench: dict) -> bool:
    """Whether `cell` reports `metric`: its `workloads` list, or without
    one every cell that reports the end-to-end metric it moves (an
    end-to-end metric without a list: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        moved = [m for m in bench["end_to_end"] if m["name"] == metric["moves"]]
        return bool(moved) and reports(moved[0], cell, bench)
    return True


def load_cell(name: str, bench: dict, root: str = ROOT) -> Cell:
    here = os.path.join(root, "rtbench")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"rtbench: no cell {name!r} in BENCHMARK.json "
                         f"(cells: {', '.join(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    limits = _json(os.path.join(here, "limits", name + ".json"))
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if reports(m, name, bench)],
                [m for m in bench["per_layer"] if reports(m, name, bench)])


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(traffic: dict, root: str = ROOT):
    """The module of the entry a traffic mix drives."""
    name = traffic["entry"]
    return _module(os.path.join(root, "rtbench", "entries", name + ".py"),
                   f"rtbench_entry_{name}")


def metric_reader(name: str, root: str = ROOT):
    """The `read(reading)` function of a per-layer metric."""
    return _module(os.path.join(root, "rtbench", "metrics", name + ".py"),
                   "rtbench_metric_" + name.replace(".", "_")).read
