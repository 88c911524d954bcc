"""On a CUDA card: one short run of each cell through the command line, its
result line read as the contract reads it. Skips inside the test where
there is no card."""

import json
import subprocess
import sys

import pytest
import torch

from .conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("cell", ["cornell_box.offline",
                                  "final_scene.progressive",
                                  "cornell_box.grad"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", cell,
         "--seed", "2147483659", "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    if trace:
        assert line["device"]["busy_s"] > 0 and line["breakdown"]
