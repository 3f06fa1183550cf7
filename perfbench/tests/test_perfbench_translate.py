"""The translation cell's faults (``perfbench/harness/moe_faults.py``), each
planted in the program at toy width on the CPU: ``correct`` has to catch
every one."""

from perfbench.harness import moe_faults
from perfbench.tests.conftest import run_cell
import pytest


@pytest.mark.parametrize("fault", sorted(moe_faults.FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    undo = moe_faults.plant(fault)
    try:
        line = run_cell("translate.moe_beam5")
    finally:
        undo()
    assert line["correct"] is False, line["checks"]


def test_the_toy_cell_is_correct_and_reads_its_metrics():
    line = run_cell("translate.moe_beam5", trace=1)
    assert line["correct"] is True
    assert "mfu.translate" in line["metrics"]
