"""On the card: each cell's whole run at a small scale, correct, with its
metrics; and the traced run's kernel check finds every launch."""
import pytest

from portbench import harness
from portbench.tests.common import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_small_run_on_the_card(card, cell, trace):
    # a traced window long enough that one chunk left out for lost kernel
    # events stays under the share a run may leave out, as at full size
    r = harness.run(cell, 2 ** 31 + 5, 10.0 if trace else 1.0, trace, card,
                    scale=0.01, log=lambda *a: None)
    assert r["correct"], r["check"]
    assert r["device"]["platform"] == "gpu"
    if trace:
        assert r["device"]["busy_s"] > 0
        assert r["breakdown"]["device_ops"]
