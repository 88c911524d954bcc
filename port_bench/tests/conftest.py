"""Shared set-up of the benchmark's own tests: the CPU at tiny sizes, one
thread, and the marker of tests that need a CUDA card."""

import copy
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# each cell at a size a test run holds; every pixel checked, so the frame's
# queries are compared exactly
TINY = {
    "cornell_box.offline": {"cfg": {"image_width": 16},
                            "mix": {"spp": 4, "check": {"units": 2,
                                                        "pixels": 256},
                                    "trace": {"units": 2}}},
    "final_scene.progressive": {"cfg": {"image_width": 12, "max_depth": 6},
                                "mix": {"spp": 2, "check": {"units": 2,
                                                            "pixels": 144},
                                        "trace": {"units": 2}}},
    "cornell_box.grad": {"cfg": {"image_width": 16, "max_depth": 4},
                         "mix": {"spp": 2, "check": {"units": 1},
                                 "trace": {"units": 1}}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without one")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny():
    return lambda cell: copy.deepcopy(TINY[cell])
