"""instance_norm_roofline (kernels: instance norm): the share of the
roofline that the InstanceNorm work of one CycleGAN step reaches, in
percent: the least time the card could take for it (the larger of its
bytes at the HBM bandwidth and its operations at the compute dtype's peak)
over the device time per step of the kernels that do it in the profiled
sub-window.

The work, counted from the cell's shapes whatever kernel does it. A
generator holds 3 + 2 n + 3 norms (the stem, the two downsamplings, two in
each of the n residual blocks, the two upsamplings, the output); a
discriminator 3. The step runs 6 generator and 4 discriminator forwards,
and backward through 8 generator passes (each generator's total reaches
its own three passes and the other generator's pass on its fake) and 6
discriminator passes (one for each generator's adversarial term, four for
the discriminators' losses): 156 forward and 210 backward norms at the
headline sizes. A forward reads x, the scale and the offset and writes y
and the per-(sample, channel) mean and inverse deviation; a backward reads
x, dy, the scale, the offset, the mean and the deviation and writes dx,
dscale and doffset. Operations: 7 an element forward (the mean, the centred
square sum, the normalisation and the affine), 12 backward.

Kernels: those of csrc/instance_norm.cu, by name (KERNELS)."""

import re

from portbench import peaks

KERNELS = re.compile(r"\bin_(fwd|bwd)(_partial|_apply)?_kernel\b")
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}
G_FORWARDS, D_FORWARDS = 6, 4
G_BACKWARDS, D_BACKWARDS = 8, 6


def norm_shapes(cell) -> tuple[list[tuple], list[tuple]]:
    """(generator norms, discriminator norms) as (B, C, H, W)."""
    cfg, b = cell.cfg, cell.batch
    h, w, c = cfg["image_size"]
    base, res = cfg["base_width"], cfg["n_res_blocks"]
    gen = [(b, base, h, w), (b, 2 * base, -(-h // 2), -(-w // 2)),
           (b, 4 * base, -(-h // 4), -(-w // 4))]
    gen += [(b, 4 * base, -(-h // 4), -(-w // 4))] * (2 * res)
    gen += [(b, 2 * base, -(-h // 4) * 2, -(-w // 4) * 2), (b, base, -(-h // 4) * 4, -(-w // 4) * 4),
            (b, 3, -(-h // 4) * 4, -(-w // 4) * 4)]
    disc = []
    hh, ww = h, w
    for filters, norm in cell.reference.DISC_TRUNK:
        hh, ww = (hh - 4) // 2 + 1, (ww - 4) // 2 + 1
        if norm:
            disc.append((b, filters, hh, ww))
    return gen, disc


def work(cell) -> tuple[float, float, int, int]:
    """(bytes, operations, forward norms, backward norms) of one step."""
    e = ELEMENT_BYTES[cell.cfg["dtype"]]
    gen, disc = norm_shapes(cell)
    fwd = gen * G_FORWARDS + disc * D_FORWARDS
    bwd = gen * G_BACKWARDS + disc * D_BACKWARDS
    nbytes = sum(2 * e * b * c * h * w + 2 * 4 * c + 2 * 4 * b * c for b, c, h, w in fwd)
    nbytes += sum(3 * e * b * c * h * w + 4 * 4 * c + 2 * 4 * b * c for b, c, h, w in bwd)
    ops = sum(7 * b * c * h * w for b, c, h, w in fwd) + sum(12 * b * c * h * w for b, c, h, w in bwd)
    return nbytes, ops, len(fwd), len(bwd)


def read(cell):
    w = cell.profiled
    if w is None or not cell.profiled_steps or "n_res_blocks" not in cell.cfg:
        return None
    seconds = w.kernel_us(KERNELS) * 1e-6 / cell.profiled_steps
    nbytes, ops, _, _ = work(cell)
    return peaks.roofline_pct(cell.kind, cell.cfg["dtype"], nbytes, ops, seconds)
