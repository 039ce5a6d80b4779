"""dropout_roofline (kernels: dropout): the share of the roofline that the
fused LeakyReLU + dropout work of one step reaches, in percent: the least
time the card could take for it (the larger of its bytes at the HBM
bandwidth and its operations at the compute dtype's peak) over the device
time per step of the kernels that do it in the profiled sub-window.

The work, counted from the cell's shapes whatever kernel does it: at each
of the discriminator's dropout sites (the output of each trunk conv), in
each of the step's D passes, one forward (read x, write y) and one
backward (read x and the incoming gradient, write dx), every element in
the compute dtype, and the site's two key words read. Operations: 2 an
element each way (the slope and the keep scale); the mask's integer hash
has no published peak and is not counted.

Kernels: those of csrc/leaky_relu_dropout.cu, by name (KERNELS)."""

import re

from portbench import peaks

KERNELS = re.compile(r"\blrd_(fwd|bwd)_(vector|scalar)_kernel\b")
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def site_elements(cell) -> list[int]:
    """Elements of each dropout site's activation, one entry per site."""
    h, w, _ = cell.cfg["image_size"]
    out = []
    for filters, _, stride in cell.reference.DISC_TRUNK:
        h, w = -(-h // stride), -(-w // stride)
        out.append(cell.batch * filters * h * w)
    return out


def work(cell) -> tuple[float, float, float, float]:
    """(forward bytes, backward bytes, forward ops, backward ops) of one step."""
    e = ELEMENT_BYTES[cell.cfg["dtype"]]
    n = sum(site_elements(cell)) * cell.reference.PASSES
    sites = len(cell.reference.DISC_TRUNK) * cell.reference.PASSES
    return 2 * e * n + 16 * sites, 3 * e * n + 16 * sites, 2.0 * n, 2.0 * n


def read(cell):
    w = cell.profiled
    if w is None or not cell.profiled_steps or not hasattr(cell.reference, "PASSES"):
        return None
    seconds = w.kernel_us(KERNELS) * 1e-6 / cell.profiled_steps
    fwd_b, bwd_b, fwd_o, bwd_o = work(cell)
    return peaks.roofline_pct(cell.kind, cell.cfg["dtype"], fwd_b + bwd_b, fwd_o + bwd_o, seconds)
