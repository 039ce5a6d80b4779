"""Train steps on data-parallel ranks, for comparison with one process.

`run_steps(group, family, cfg, inputs, init=None, device=None)` builds a
family's train state (the port's seeded init, or a state in the JAX
package's numpy form, loaded through `bridge`), replicates it over the
group, runs one step per global batch of `inputs` with this rank's rows,
and returns what a comparison needs: the per-step metrics averaged over
the ranks (one all-reduce), the final state in the JAX package's numpy
form, the state's digest (checked equal on every rank), the collectives
and the hand-kernel launches this rank made. With `group=None` it is the
one-process run of the same steps on `device`. The state before the
first step and after every step come back too (`state0`, `states`), and
`init` may be such a list of states, one per step: each step then starts
from its own state (a trajectory replayed step by step). Under a spatial
partition each rank's batches are also cut to its block of image rows.

The inputs are global numpy arrays, one entry per step:
- sndcgan: `batches` (S, B, H, W, C) uint8, `z` (S, B, z_size), `kw`
  (21, 2) dropout key words (the same each step);
- wgan: `batches`, `z_fake`, `z_gan` (S, B, z_size) and, with the
  gradient penalty, `gp_eps` (S, B, 1, 1, 1);
- cyclegan: `batches_x`, `batches_y` (S, B, H, W, C) uint8.

tests/test_torch_dp.py holds the ranks against the JAX package's
one-device step on the CPU, and chip_smoke.py holds them against the
one-process step on a card.
"""

from __future__ import annotations

import numpy as np
import torch

from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.core import mesh as meshlib
from imagegeneration_tpu_torch.ops import adam, dropout
from imagegeneration_tpu_torch.ops import batch_norm as bnorm
from imagegeneration_tpu_torch.ops import instance_norm as inorm
from imagegeneration_tpu_torch.parallel import dp
from imagegeneration_tpu_torch.train import cyclegan_step, sndcgan_step, wgan_step

FAMILIES = {
    "sndcgan": (sndcgan_step, bridge.load_jax_train_state, bridge.jax_train_state),
    "wgan": (wgan_step, bridge.load_jax_wgan_state, bridge.jax_wgan_state),
    "cyclegan": (cyclegan_step, bridge.load_jax_cyclegan_state, bridge.jax_cyclegan_state),
}
LAUNCH_COUNTERS = (dropout.LAUNCHES, adam.LAUNCHES, adam.BF16_LAUNCHES, inorm.LAUNCHES,
                   inorm.SPLIT_LAUNCHES, bnorm.LAUNCHES)


def launches() -> dict[str, int]:
    return {k: v for counts in LAUNCH_COUNTERS for k, v in counts.items()}


def _step_args(family: str, inputs: dict, i: int, rows: slice, image_rows: slice,
               device) -> tuple:
    def t(key, local=False):
        a = inputs[key][i]
        return torch.from_numpy(np.ascontiguousarray(
            a[rows, image_rows] if local else a)).to(device)

    if family == "sndcgan":
        return t("batches", True), t("z"), torch.from_numpy(inputs["kw"]).to(device)
    if family == "wgan":
        eps = t("gp_eps") if "gp_eps" in inputs else None
        return t("batches", True), t("z_fake"), t("z_gan"), eps
    return t("batches_x", True), t("batches_y", True)


def run_steps(group, family: str, cfg, inputs: dict, init: dict | None = None,
              device: str | None = None) -> dict:
    steplib, load, dump = FAMILIES[family]
    dev = group.device if group is not None else torch.device(device or "cpu")
    state = steplib.init_state(cfg, dev)
    replay = init if isinstance(init, list) else None
    if init is not None and replay is None:
        load(state, init)
    dp.replicate_state(state, group)
    state0 = dump(state)
    step = steplib.make_train_step(cfg, group)
    first = next(iter(inputs.values()))
    n_steps = first.shape[0]
    images = inputs["batches"] if "batches" in inputs else inputs["batches_x"]
    lo, hi = meshlib.process_row_range(group, images.shape[1])
    image_rows = slice(*meshlib.spatial_row_range(group, images.shape[2]))
    before = launches()
    counts = {} if group is None else dict(group.counts)
    per_step, states = [], []
    for i in range(n_steps):
        if replay is not None:
            load(state, replay[i])
        state, m = step(state, *_step_args(family, inputs, i, slice(lo, hi), image_rows, dev))
        per_step.append(m)
        states.append(dump(state))
    stacked = {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}
    stacked = dp.reduce_metrics(stacked, group)
    after = launches()
    if group is not None:
        counts = {k: group.counts[k] - counts[k] for k in group.counts}
    metrics = [{k: float(v[i]) for k, v in stacked.items()} for i in range(n_steps)]
    digest = dp.check_replicated(state, group)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {
        "rank": 0 if group is None else group.rank,
        "metrics": metrics,
        "state": states[-1],
        "state0": state0,
        "states": states,
        "digest": digest,
        # the steps' collectives and the metrics' one all-reduce
        "collectives": counts,
        "launches": {k: after[k] - before[k] for k in after},
    }
