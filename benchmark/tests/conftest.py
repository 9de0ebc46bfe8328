"""The benchmark's own tests: on the CPU, at tiny sizes, through the
port's plain versions. A test that needs the card is marked ``card``
and decides in a fixture whether there is one.

    python -m pytest benchmark/tests -q
"""

import copy
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; runs on the card's machine")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def bench():
    from benchmark import harness

    return harness.load_benchmark()


def tiny(bench, workload: str):
    """The cell at a size the CPU decodes in well under a second a call:
    48x64 frames of the same picture, 9 frames (10 for a range mix)."""
    from benchmark import harness

    cell, config, mix = harness.find_cell(bench, workload)
    config, mix = copy.deepcopy(config), dict(mix)
    config["height"], config["width"] = 48, 64
    mix["clip_frames"] = 10 if mix["kind"] == "range" else 9
    return cell, config, mix


@pytest.fixture(scope="session")
def tiny_cell(bench):
    return lambda workload: tiny(bench, workload)
