"""The control, the plain reference in TF32 (the precision below the
cells' float32) in the program's place, has to come out not correct: it
breaks a limit of the cell where the program's answers keep every one.
At a tiny size on the CPU; TF32 is emulated by rounding the matrix
product's inputs to its 10-bit mantissa, as the card's tensor cores do."""

import pytest

from portbench import control
from portbench.tests import tiny


@pytest.mark.parametrize("name", sorted(tiny.SIZES))
def test_control_is_not_correct(name):
    c = tiny.cell(name)
    got = control.readings(c, 2**31 + 3, tiny.CPU)
    assert all(got["program"][n] <= c.limits[n] for n in c.limits), got
    assert any(got["control"][n] > c.limits[n] for n in c.limits), got
