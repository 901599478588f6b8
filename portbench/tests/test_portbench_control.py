"""The control (the plain reference put in the program's place, in float32
with TF32 matrix products) comes out not correct, at the cells' own size
(a few seconds a cell on the card).  Needs the card: it skips without
one."""
import pytest

from portbench import control, harness
from portbench.tests._tiny import ROOT


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (TF32 exists only there)")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["clinical.cohort16", "clinical.severe16"])
def test_control_is_not_correct(card, cell):
    ok, rows = control.control_readings(harness.load_cell(ROOT, cell),
                                        2147483901, card)
    assert not ok, rows
    assert dict((k, v > lim) for k, v, lim in rows)["n4_rel"]
