"""The control at a size a CPU test holds: the reference computed one
precision below the configuration's (bfloat16 values, float32 sums) must
fail one of each cell's numbers, while the configuration's own precision
(float32 values, float64 sums) reads within every limit. On the card the
control runs at the cell's own size through `gpubench/control.py`."""

import argparse
import io
import json
from pathlib import Path

import pytest

from gpubench.control import control_numbers
from gpubench.harness import load_cell
from gpubench.tests.conftest import ROOT, SMALL

CELLS = ["tcga_bulk_em", "tcga_cells_em"]


def _cell(name):
    cell = load_cell(Path(ROOT), name)
    for k, v in SMALL.items():
        (cell.traffic if k in cell.traffic else cell.config)[k] = v
    return cell


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_number(cell):
    c = _cell(cell)
    nums = control_numbers(c, 2**31 + 5, 1, "cpu")
    limits = c.workload["limits"]
    assert any(nums[k] > v for k, v in limits.items()), nums


@pytest.mark.parametrize("cell", CELLS)
def test_stated_precision_within_limits(cell):
    c = _cell(cell)
    nums = control_numbers(c, 2**31 + 5, 1, "cpu", "stated")
    for k, v in c.workload["limits"].items():
        assert nums[k] <= v, (k, nums[k], v)


@pytest.mark.cuda
def test_short_run_on_the_card(card):
    from gpubench import harness

    a = argparse.Namespace(workload="tcga_cells_em", seed=2**31 + 7,
                           seconds=2, trace=1, override=dict(SMALL))
    out = io.StringIO()
    assert harness.run(a, device=card, root=Path(ROOT), out=out,
                       err=io.StringIO()) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
