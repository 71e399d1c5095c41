"""The control comes out not correct: the reference, computed in the
precision just below the one the configuration states (fp8 for the
bfloat16 dlrm-rm2, TF32 for the float32 MT-WnD; TF32 emulated on the
CPU by rounding the operands), put in the program's place, fails the
configuration's limit, while the program passes it on the same inputs.
At the configurations' widths, the tables cut to a few thousand rows."""
import pytest

from bench import harness
from bench.tests.util import small_cell

SEEDS = [11, 2**31 + 7, 912345678901]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["rm2.bulk", "mtwnd.bulk"])
def test_control_fails_the_limit(name, seed, cpu):
    cell = small_cell(name, batch=512)
    control = harness.control_reading(cell, seed, cpu)
    gap = control.checks["score_gap"]
    assert not control.correct and gap["value"] > gap["limit"]
    program = harness.run_cell(cell, seed, 0.2, False, cpu)
    assert program["correct"]
    assert program["checks"]["score_gap"]["value"] < gap["limit"]
