"""adam_roofline (kernels: adam): the share of the roofline that the Adam
applies of one step reach, in percent: the least time the card could take
for them (the larger of their bytes at the HBM bandwidth and their
operations at the float32 peak) over the device time per step of the
kernels that do them in the profiled sub-window.

The work, counted from the configuration's leaves (the reference's
param_specs) and the applies a step makes of each model (ADAM_APPLIES):
every element of every optimized leaf reads p, g, m and v and writes p, m
and v, float32 each (28 bytes), and takes 12 operations (the two moments'
updates, the square root, epsilon, the step). The step size, computed once
an apply, is left out.

Kernels: `adam_multi_kernel` of csrc/adam.cu, by name (KERNELS)."""

import math
import re

from portbench import peaks

KERNELS = re.compile(r"\badam_multi_kernel\b")
BYTES_PER_ELEMENT = 7 * 4
OPS_PER_ELEMENT = 12


def elements(cell) -> int:
    """Optimized elements a step updates, counted once per apply."""
    applies = cell.reference.ADAM_APPLIES
    return sum(math.prod(shape) * applies[name.split(".")[0]]
               for name, shape, _, trainable in cell.reference.param_specs(cell.cfg) if trainable)


def read(cell):
    w = cell.profiled
    if w is None or not cell.profiled_steps:
        return None
    seconds = w.kernel_us(KERNELS) * 1e-6 / cell.profiled_steps
    n = elements(cell)
    return peaks.roofline_pct(cell.kind, "float32", BYTES_PER_ELEMENT * n, OPS_PER_ELEMENT * n,
                              seconds)
