"""The control: the reference in bfloat16 in the program's place fails the
comparison under each cell's limits (here at a size a test run holds; on
the card at the cells' own sizes, ``python3 -m port_bench.control``)."""

import pytest
import torch

from port_bench import check, control, lookup

from .conftest import ROOT


@pytest.mark.parametrize("cell", ["cornell_box.offline",
                                  "final_scene.progressive",
                                  "cornell_box.grad"])
def test_bfloat16_reference_is_not_correct(cell, tiny):
    c = lookup.find_cell(ROOT, cell)
    t = tiny(cell)
    c.cfg.update(t["cfg"])
    c.mix.update(t["mix"])
    nums = control.control_numbers(c, 11, torch.device("cpu"))
    assert not check.verdict(nums, c.limits), nums
