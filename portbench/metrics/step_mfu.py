"""step_mfu (step): model FLOPs of the steps of the traced run's
free-running part over that part's seconds times the card's dense peak in
the configuration's compute dtype (peaks.py), in percent.

The FLOPs of one step are counted once by torch's FlopCounterMode over the
benchmark's own plain reference step (reference/<family>.py) at the cell's
shapes, on the meta device: every convolution, transposed convolution and
matrix product of the forward, of the backward passes the step takes, and
of the spectral-norm power step, with nothing recomputed."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import peaks, weights


def step_flops(cell) -> int:
    ref, cfg = cell.reference, cell.cfg
    w = weights.make(ref.param_specs(cfg), 0, "meta")
    trainer = ref.Trainer(cfg, w, {"z": 0, "model": 0}, "meta", cell.batch)
    batches = [torch.empty((cell.batch, *cfg["image_size"]), dtype=torch.uint8, device="meta")
               for _ in range(cell.traffic["domains"])]
    with FlopCounterMode(display=False) as counter:
        trainer.step(*batches)
    return counter.get_total_flops()


def read(cell):
    free = cell.free
    peak = peaks.flops(cell.kind, cell.cfg["dtype"])
    if not free or peak is None:
        return None
    return 100.0 * step_flops(cell) * free["steps"] / (free["seconds"] * peak)
