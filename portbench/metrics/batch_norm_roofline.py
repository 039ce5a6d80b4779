"""batch_norm_roofline (kernels: batch norm): the share of the roofline that
the generator's BatchNorm + activation work of one SNDCGAN step reaches, in
percent: the least time the card could take for it (the larger of its
bytes at the HBM bandwidth and its operations at the compute dtype's peak)
over the device time per step of the kernels that do it in the profiled
sub-window.

The work, counted from the cell's shapes whatever kernel does it. The
generator has four BatchNorm sites, each followed by its ReLU: the stem's
(B, base * H/8 * W/8) output and the maps after the three transposed
convs, (B, base/2, H/4, W/4), (B, base/4, H/2, W/2) and (B, base/8, H, W).
The step's G pass runs one forward and one backward through each. A
forward reads x and writes y in the compute dtype, and reads the scale,
the bias and the running statistics and writes those and the saved mean
and inverse deviation (eight float32 vectors of C); a backward reads x
and dy and writes dx, and reads the scale, the bias, the mean and the
deviation and writes dscale and dbias (six vectors). Operations: 7 an
element forward (the two sums, the normalisation and the affine, the
activation), 12 backward.

Kernels: those of csrc/batch_norm.cu, by name (KERNELS). A program without
them (before the kernels) reads nothing here."""

import re

from portbench import peaks

KERNELS = re.compile(r"\bbn_(fwd|bwd)_(stats|apply|reduce)_kernel\b")
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}
G_FORWARDS, G_BACKWARDS = 1, 1  # the G pass of a step, through each site
FWD_VECTORS, BWD_VECTORS = 8, 6
FWD_OPS, BWD_OPS = 7, 12


def site_shapes(cell) -> list[tuple[int, int]]:
    """(elements, channels) of each BatchNorm site of the generator."""
    h, w, _ = cell.cfg["image_size"]
    base, b = cell.cfg["base_width"], cell.batch
    stem = base * (h // 8) * (w // 8)
    out = [(b * stem, stem)]
    for i, c in enumerate((base // 2, base // 4, base // 8)):
        scale = 2 ** (i + 1)
        out.append((b * c * (h // 8) * scale * (w // 8) * scale, c))
    return out


def work(cell) -> tuple[float, float]:
    """(bytes, operations) of one step."""
    e = ELEMENT_BYTES[cell.cfg["dtype"]]
    sites = site_shapes(cell)
    fwd = sum(2 * e * n + FWD_VECTORS * 4 * c for n, c in sites) * G_FORWARDS
    bwd = sum(3 * e * n + BWD_VECTORS * 4 * c for n, c in sites) * G_BACKWARDS
    ops = sum(FWD_OPS * n * G_FORWARDS + BWD_OPS * n * G_BACKWARDS for n, _ in sites)
    return fwd + bwd, ops


def read(cell):
    w = cell.profiled
    if w is None or not cell.profiled_steps or cell.cfg.get("family") != "sndcgan":
        return None
    seconds = w.kernel_us(KERNELS) * 1e-6 / cell.profiled_steps
    nbytes, ops = work(cell)
    return peaks.roofline_pct(cell.kind, cell.cfg["dtype"], nbytes, ops, seconds)
