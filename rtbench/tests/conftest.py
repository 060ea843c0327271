"""The benchmark's own tests, on the CPU (the port's plain kernel versions
at tiny sizes), and those marked `gpu`, which run a cell on a card and
skip without one:

    python -m pytest -q rtbench/tests            # from the root of a checkout
    python -m pytest -q -m gpu rtbench/tests     # on a machine with a card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: runs on a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs a cell on the card")
    return torch.device("cuda", 0)


TINY = {"width": 16, "height": 16, "samples_per_pixel": 4, "chunk_size": 512}


def tiny_cell(name: str, **traffic):
    """The cell as BENCHMARK.json has it, its frame cut to 16x16 so that
    the port's plain versions run it on the CPU in seconds."""
    from rtbench import spec

    cell = spec.load_cell(name, spec.load_benchmark())
    return cell._replace(traffic=dict(cell.traffic, render=TINY,
                                      check_pixels=128, check_rays=512,
                                      **traffic))
