"""The control: the reference in the precision below the configuration's
(its path state in bfloat16) put in the program's place reads above every
cell's limit, at a test's size on the CPU and, on a card, at the cell's own
size (``python3 rtbench/control.py`` prints the readings the limits were
set from)."""

import pytest

from rtbench import bench, control
from rtbench_cells import small_cell


@pytest.mark.parametrize("config", ["atrium", "bistro"])
def test_control_fails_the_check_at_a_small_size(config):
    cell = small_cell(config, width=48, height=27, pixels=32)
    limit = bench.load_cell(cell.name).check["limits"]["image_gap"]
    got = control.control_gap(cell, 2**31 + 9, 12, "cpu")
    assert got["image_gap"] > 3 * limit, got


@pytest.mark.card
@pytest.mark.parametrize("workload", ["atrium.accumulate-1080p-d4", "bistro.accumulate-1080p-d4"])
def test_control_fails_the_check_at_the_cell_size(card, workload):
    cell = bench.load_cell(workload)
    got = control.control_gap(cell, 2**31 + 19, 60, card)
    assert got["image_gap"] > 3 * cell.check["limits"]["image_gap"], got
