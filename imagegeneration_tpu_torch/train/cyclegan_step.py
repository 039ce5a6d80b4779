"""The CycleGAN train step: one shared forward, four simultaneous updates.

The counterpart of imagegeneration_tpu/train/cyclegan_step.py (reference:
cyclegan/CycleGAN.py:325-382). One forward computes fake_y = G_g(x),
cycled_x = G_f(fake_y), fake_x = G_f(y), cycled_y = G_g(fake_x), the
identity images same_x = G_f(x), same_y = G_g(y), four discriminator passes
and the losses:

    gen_g = BCE(1, D_y(fake_y));  gen_f = BCE(1, D_x(fake_x))
    total_cycle = 10*L1(x, cycled_x) + 10*L1(y, cycled_y)   (in BOTH totals)
    identity_g = 5*L1(y, same_y);  identity_f = 5*L1(x, same_x)
    total_gen_g = gen_g + total_cycle + identity_g   (likewise total_gen_f)
    disc_x = 0.5*(BCE(1, D_x(x)) + BCE(0, D_x(fake_x)))  (likewise disc_y)

The gradients come from three pulls over the one graph, as the JAX step's
three vjp cotangents: d total_gen_g / d G_g, d total_gen_f / d G_f, and
d (disc_x + disc_y) / d (D_x, D_y) in one pull (the two discriminator
losses have disjoint parameters). A single summed pull would be wrong: the
cycle term is in both generator totals, and the generator losses depend on
the discriminator parameters. `inputs=` keeps each pull off the parameters
it does not update (pull 3 does not enter the generators). Then four
Keras-form Adam applies (lr 2e-4, b1 0.5) against the same pre-update
graph, through the Adam kernel on a card.

Parameters and moments are updated in place (PyTorch idiom; the JAX step
returns new arrays). No host sync happens inside a step: the step counter,
Adam's alpha and the metrics stay on the device.

Data parallelism (`group`, a core.mesh.DataGroup; parallel/dp.py): each
rank takes its block of rows of both global batches, and the gradients are
averaged over the ranks before each of the four Adam applies. InstanceNorm
normalizes each sample alone, so the forward needs no collective; its dγ
and dβ are summed over the rank's own samples and then averaged with the
other gradients.

Spatial partitioning (a group with spatial > 1; the JAX engine's
`spatial=True`): both batches are the rank's block of image rows too, and
the models are partitioned each step (nn/layers.partition): the
generators run on the rows (halo exchanges, the split InstanceNorm), the
PatchGANs gather their input's rows and run whole on every spatial peer
(models/cyclegan.py). So:
- the L1 terms are means over the whole image: each rank sums |a - b| over
  its rows, `dp.spatial_sum`s the sum and divides by the whole count;
- the BCE terms are taken on the PatchGANs' whole logits, equal on the
  peers, as are all the metrics;
- the PatchGANs' parameter gradients are the whole gradient on every peer,
  so they are counted on spatial rank 0 only (`count_once`) before the
  world sum; the generators' are each rank's part, summed over the world
  and divided by the data size as for the other families.
"""

from __future__ import annotations

import dataclasses

import torch

from imagegeneration_tpu_torch.core import rng as rnglib
from imagegeneration_tpu_torch.core import trace
from imagegeneration_tpu_torch.core.data import normalize
from imagegeneration_tpu_torch.models import cyclegan
from imagegeneration_tpu_torch.nn.layers import partition
from imagegeneration_tpu_torch.parallel import dp
from imagegeneration_tpu_torch.train import common

LAMBDA = 10.0  # cyclegan/CycleGAN.py:186
METRIC_KEYS = (
    "gen_g_loss", "gen_f_loss", "identity_loss_g", "identity_loss_f",
    "total_gen_g_loss", "total_gen_f_loss", "total_cycle_loss",
    "disc_x_loss", "disc_y_loss",
)


@dataclasses.dataclass(frozen=True)
class CycleGANTrainConfig:
    model: cyclegan.CycleGANConfig = cyclegan.CycleGANConfig()
    batch_size: int = 1
    learning_rate: float = 2e-4  # CycleGAN.py:229-233
    beta1: float = 0.5
    seed: int = rnglib.DEFAULT_MODEL_SEED


@dataclasses.dataclass
class CycleGANState:
    step: torch.Tensor  # 0-d int64 on the device
    gen_g: cyclegan.Generator  # G: X -> Y
    gen_f: cyclegan.Generator  # F: Y -> X
    disc_x: cyclegan.Discriminator
    disc_y: cyclegan.Discriminator
    gg_opt: common.AdamState
    gf_opt: common.AdamState
    dx_opt: common.AdamState
    dy_opt: common.AdamState

    _PARTS = ("gen_g", "gen_f", "disc_x", "disc_y", "gg_opt", "gf_opt", "dx_opt", "dy_opt")

    @property
    def device(self) -> torch.device:
        return self.step.device

    def state_dict(self) -> dict:
        return {"step": self.step,
                **{k: getattr(self, k).state_dict() for k in self._PARTS}}

    def load_state_dict(self, sd: dict) -> None:
        with torch.no_grad():
            self.step.copy_(sd["step"])
        for k in self._PARTS:
            getattr(self, k).load_state_dict(sd[k])


def init_state(cfg: CycleGANTrainConfig, device: torch.device | str) -> CycleGANState:
    """Initial state; the four models' weights are drawn on the CPU from the
    "params" stream, so they are the same on every device for a seed."""
    chain = rnglib.KeyChain(cfg.seed)
    models = cyclegan.make_models(
        cfg.model, [chain.generator("params", step=i) for i in range(4)])
    for m in models:
        common.place(m, device, cfg.model.dtype)
    gen_g, gen_f, disc_x, disc_y = models
    return CycleGANState(
        step=torch.zeros((), dtype=torch.int64, device=device),
        gen_g=gen_g, gen_f=gen_f, disc_x=disc_x, disc_y=disc_y,
        gg_opt=common.adam_init(list(gen_g.parameters())),
        gf_opt=common.adam_init(list(gen_f.parameters())),
        dx_opt=common.adam_init(list(disc_x.parameters())),
        dy_opt=common.adam_init(list(disc_y.parameters())),
    )


def _sharded(group) -> bool:
    return group is not None and group.sharded


def _l1(a: torch.Tensor, b: torch.Tensor, group=None) -> torch.Tensor:
    """mean|a - b| over the whole image: under a spatial partition, this
    rank's sum over its rows, summed over the spatial peers, over the whole
    count."""
    dt = torch.promote_types(torch.promote_types(a.dtype, b.dtype), torch.float32)
    d = torch.abs(a.to(dt) - b.to(dt))
    if not _sharded(group):
        return torch.mean(d)
    return dp.spatial_sum(d.sum().reshape(1), group)[0] / (d.numel() * group.spatial)


def cycle_loss(real: torch.Tensor, cycled: torch.Tensor, group=None) -> torch.Tensor:
    """10 * mean|real - cycled| (CycleGAN.py:201-203)."""
    return LAMBDA * _l1(real, cycled, group)


def identity_loss(real: torch.Tensor, same: torch.Tensor, group=None) -> torch.Tensor:
    """5 * mean|real - same| (CycleGAN.py:206-208)."""
    return LAMBDA * 0.5 * _l1(real, same, group)


def count_once(grads, group) -> list:
    """The gradients of a model that every spatial peer runs whole (the
    PatchGAN) are the whole gradient on each peer: kept on spatial rank 0
    and zeroed elsewhere (in place), so that the world sum counts them
    once. Exact, as is the Dense heads' bias rule (nn/layers.dense)."""
    grads = list(grads)
    if _sharded(group):
        torch._foreach_mul_(grads, float(group.s == 0))
    return grads


def discriminator_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    """0.5*(BCE(1, real) + BCE(0, fake)) over patch logits (CycleGAN.py:190-194)."""
    return 0.5 * (
        common.bce_logits_mean(torch.ones_like(logits_real), logits_real)
        + common.bce_logits_mean(torch.zeros_like(logits_fake), logits_fake)
    )


def generator_adv_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    """BCE(1, fake) (CycleGAN.py:197-198)."""
    return common.bce_logits_mean(torch.ones_like(logits_fake), logits_fake)


def make_train_step(cfg: CycleGANTrainConfig, group=None):
    """Build `train_step(state, batch_x_u8, batch_y_u8) -> (state, metrics)`.
    Batches: (B, H, W, C) uint8 on the state's device (with a group, this
    rank's rows of the global batches, and under a spatial partition its
    image rows). Metrics are 0-d float32 device tensors, keyed by
    METRIC_KEYS."""
    dt = cfg.model.dtype

    def train_step(state: CycleGANState, batch_x_u8: torch.Tensor,
                   batch_y_u8: torch.Tensor):
        real_x = normalize(batch_x_u8, dt).permute(0, 3, 1, 2)
        real_y = normalize(batch_y_u8, dt).permute(0, 3, 1, 2)
        g_g, g_f, d_x, d_y = state.gen_g, state.gen_f, state.disc_x, state.disc_y
        for model in (g_g, g_f, d_x, d_y):
            partition(model, group)

        with trace.span("train.forward"):
            fake_y = g_g(real_x)
            cycled_x = g_f(fake_y)
            fake_x = g_f(real_y)
            cycled_y = g_g(fake_x)
            same_x = g_f(real_x)
            same_y = g_g(real_y)

            disc_real_x = d_x(real_x)
            disc_real_y = d_y(real_y)
            disc_fake_x = d_x(fake_x)
            disc_fake_y = d_y(fake_y)

            gen_g_loss = generator_adv_loss(disc_fake_y)
            gen_f_loss = generator_adv_loss(disc_fake_x)
            total_cycle = cycle_loss(real_x, cycled_x, group) + cycle_loss(real_y, cycled_y, group)
            id_g = identity_loss(real_y, same_y, group)
            id_f = identity_loss(real_x, same_x, group)
            total_gen_g = gen_g_loss + total_cycle + id_g
            total_gen_f = gen_f_loss + total_cycle + id_f
            disc_x_loss = discriminator_loss(disc_real_x, disc_fake_x)
            disc_y_loss = discriminator_loss(disc_real_y, disc_fake_y)

        gg, gf = list(g_g.parameters()), list(g_f.parameters())
        dx, dy = list(d_x.parameters()), list(d_y.parameters())
        with trace.span("train.backward"):
            gg_grads = torch.autograd.grad(total_gen_g, gg, retain_graph=True)
        with trace.span("train.backward"):
            gf_grads = torch.autograd.grad(total_gen_f, gf, retain_graph=True)
        with trace.span("train.backward"):
            d_grads = torch.autograd.grad(disc_x_loss + disc_y_loss, dx + dy)
        d_grads = count_once(d_grads, group)

        lr, b1 = cfg.learning_rate, cfg.beta1
        common.adam_apply(gg, gg_grads, state.gg_opt, lr, b1=b1, group=group)
        common.adam_apply(gf, gf_grads, state.gf_opt, lr, b1=b1, group=group)
        common.adam_apply(dx, d_grads[:len(dx)], state.dx_opt, lr, b1=b1, group=group)
        common.adam_apply(dy, d_grads[len(dx):], state.dy_opt, lr, b1=b1, group=group)

        with torch.no_grad():
            state.step.add_(1)
        losses = (gen_g_loss, gen_f_loss, id_g, id_f, total_gen_g, total_gen_f,
                  total_cycle, disc_x_loss, disc_y_loss)
        return state, {k: v.detach() for k, v in zip(METRIC_KEYS, losses)}

    return train_step


def make_translators():
    """(translate_g, translate_f): `(state, images) -> images`, (B, H, W, C)
    float in [-1, 1] to (B, H, W, C) float32 in [-1, 1], without gradients."""

    def translator(attr: str):
        @torch.no_grad()
        def translate(state: CycleGANState, x: torch.Tensor) -> torch.Tensor:
            gen = getattr(state, attr)
            partition(gen, None)  # whole images on this process alone
            return gen(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

        return translate

    return translator("gen_g"), translator("gen_f")


def make_epoch_runner(cfg: CycleGANTrainConfig, group=None):
    """`run_epoch(state, images_x_u8, images_y_u8, perm_x, perm_y) -> (state,
    metrics)` over two device-resident uint8 datasets (N, H, W, C) and two
    (nb, B) device index tables (with a group, this rank's columns of the
    global tables); metrics come back stacked per batch, still on the
    device."""
    step_fn = make_train_step(cfg, group)

    def run_epoch(state: CycleGANState, images_x_u8: torch.Tensor,
                  images_y_u8: torch.Tensor, perm_x: torch.Tensor,
                  perm_y: torch.Tensor):
        per_step = []
        for b in range(perm_x.shape[0]):
            with trace.span(trace.STEP):
                state, m = step_fn(state, images_x_u8.index_select(0, perm_x[b]),
                                   images_y_u8.index_select(0, perm_y[b]))
            per_step.append(m)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in METRIC_KEYS}

    return run_epoch
