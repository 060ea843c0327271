"""Each cell once on the card, as its command line runs it, with a short
window: the result line has the contract's keys and reads correct."""

import json
import os
import subprocess
import sys

import pytest

from rtbench import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct_on_the_card(card, name, traced):
    p = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 11), "--seconds", "2", "--trace", str(traced)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    cell = spec.load_cell(name, spec.load_benchmark())
    want = cell.per_layer if traced else cell.end_to_end
    assert set(line["metrics"]) == {m["name"] for m in want}
    if traced:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert len(line["breakdown"]["device_ops"]) <= 10


def test_no_card_no_result(tmp_path):
    """Without a card, or without the program beside it, a run exits
    with an error and prints no result."""
    import shutil

    shutil.copytree(os.path.join(spec.ROOT, "rtbench"), tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()
