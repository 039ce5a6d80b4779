"""The control of each cell's comparison, on the card at the cell's own
sizes: the plain reference in the program's place, computed in the
precision below the configuration's (calibrate.CONTROL), must come out not
correct against the reference under the cell's limits, while the program
comes out correct. Run on a card with `python -m pytest portbench/tests -m gpu`."""

import pytest
import torch

from portbench import calibrate, compare, harness, spec

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("cell", ["sndcgan-b128", "cyclegan-b4"])
def test_the_control_fails_and_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own sizes")
    out = calibrate.readings(cell, [2147483701], [2147483801], [])
    limits = harness.Cell(spec.Spec.load(harness.ROOT), cell).limits
    program = {k: v[0] for k, v in out["program"][2147483701].items() if k != "raw"}
    control = {k: v[0] for k, v in out["control_runs"][2147483801].items() if k != "raw"}
    assert compare.verdict(program, limits), program
    assert not compare.verdict(control, limits), control
