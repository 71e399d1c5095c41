"""On a card (``python -m pytest -q bench/tests -m cuda`` there): a cell's
run at the configurations' widths with the tables cut, correct, with its
per-layer metrics read from the device trace, and the control (TF32 on
the card's own path for MT-WnD) not correct.  Skips without a card."""
import pytest

from bench import harness
from bench.tests.util import small_cell

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", ["rm2.bulk", "mtwnd.bulk", "rm2.retrieval"])
def test_small_cell_on_the_card(name, cuda_device):
    cell = small_cell(name, batch=8192)
    out = harness.run_cell(cell, 31, 1.0, True, cuda_device)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    for base in ("k1_roofline", "step_mfu", "idle_share", "dense_ms"):
        (value,) = [v["value"] for k, v in m.items() if k.startswith(base)]
        assert value > 0
        if base in ("k1_roofline", "step_mfu"):
            assert value <= 105
    dev = out["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    control = harness.control_reading(cell, 31, cuda_device)
    assert not control.correct
