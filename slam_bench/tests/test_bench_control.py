"""The control: the bfloat16 references put in the program's place come
out as not correct, at a size a CPU test run holds (tests/small.py). The
chip readings at the cells' sizes come from slam_bench/control.py."""
import pytest

from slam_bench.check import judge
from slam_bench.tests.small import CELLS, small_run


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    out = small_run(cell, control=True)
    limits = {n: lim for n, _, lim in out["rows"]}
    ok, rows = judge(out["control"], limits)
    assert not ok, rows
    ctrl = out["control"]
    assert ctrl["features"] > limits["features"]
    assert ctrl["k2_rows"] > limits["k2_rows"]
    if "k3_px" in limits:
        assert ctrl["k3_px"] > limits["k3_px"]
