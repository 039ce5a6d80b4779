"""The plain reference against the program's own CPU path (its kernels'
plain versions) on seeded weights at a small size, with the program in
float32: the two are the same mathematics, so every number compared is
float32 rounding, far under the cells' limits."""

import pytest

from portbench import compare, harness
from portbench.tests.small import CELLS, CONFIG_OF, SmallSpec

# float32 rounding of three steps, summed in other orders; a change can also
# flip the first, sign-like Adam step of an element whose gradient is near 0
FLOAT32_GAP = 1e-3


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_float32_program(cell):
    spec = SmallSpec({CONFIG_OF[cell]: {"dtype": "float32"}})
    result = harness.run(cell, 2**31 + 7, 0.2, False, spec=spec, device="cpu")
    assert result["correct"]
    for name, check in result["checks"].items():
        assert check["value"] < min(FLOAT32_GAP, check["limit"]), (name, result["checks"])


def test_reference_step_is_deterministic():
    spec = SmallSpec()
    cell, dev = harness.open_cell("sndcgan-b128", spec, "cpu")
    runs = []
    for _ in range(2):
        inputs = harness.Inputs(cell, 11, dev)
        for _ in range(compare.CHECKED_STEPS):
            inputs.checked_rows.append([r.clone() for r in inputs.order.next()])
        runs.append(harness.reference_readings(cell, inputs))
    assert runs[0] == runs[1]


def test_reflect_pad_is_the_reflect_mode():
    import torch
    import torch.nn.functional as F

    from portbench.reference import common
    x = torch.randn(2, 3, 7, 9)
    for pad in (1, 3):
        assert torch.equal(common.reflect_pad(x, pad), F.pad(x, (pad,) * 4, mode="reflect"))
