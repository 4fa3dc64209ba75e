"""The control, the reference one step below the configuration's precision
in the program's place, fails each cell's check; at a size where the
int64 sums exceed int32's range, as they do at the cells' own sizes."""
import pytest

from portbench.control import control
from portbench.tests.common import CELLS

# clickbench's sums pass 2^31 from about 1.3M rows on
SCALE = {"tpch-sf10-chains": 1e-3, "tpch-sf10-scan": 1e-3,
         "clickbench-hits-sums": 0.02}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check(cell):
    out = control(cell, 2 ** 31 + 99, "cpu", SCALE[cell])
    assert out["failed"], out
    assert out["check"]["wrong_cells"]["value"] > 0


def test_the_control_fails_the_float_limit_too():
    out = control("tpch-sf10-chains", 4, "cpu", SCALE["tpch-sf10-chains"])
    n = out["check"]["float_rel_err"]
    assert n["value"] > n["limit"]
