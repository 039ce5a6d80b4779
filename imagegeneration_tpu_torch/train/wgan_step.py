"""The WGAN train step: two critic updates per batch, a gan update every
n_critic batches.

The counterpart of imagegeneration_tpu/train/wgan_step.py (reference:
wasserstein_gan/WGAN.py:279-326), in its order:

1. A fake batch from G in inference mode (running BN statistics; the
   reference's `predict`), without gradients.
2. Critic update on the real batch, label -1: a train-mode forward (the
   critic's BN running statistics update in place), the Wasserstein loss,
   one RMSprop apply, then the ±0.01 clip of the conv weights. With
   `gp_lambda > 0` the loss adds gp_lambda * E[(||grad D(x_hat)|| - 1)^2]
   on interpolates x_hat = eps*x_real + (1-eps)*x_fake, through an
   inference-mode critic, and nothing is clipped. The penalty is computed
   before the train-mode forward: the JAX step hands it the statistics the
   update started from, and that forward overwrites them here.
3. Critic update on the fake batch, label +1, on the real-updated critic
   and statistics; no penalty.
4. `critic_count += 1`; when it reaches n_critic (the counter carries
   across batches, epochs and a resume) it is reset to 0 and the gan
   update runs: G in train mode (G's BN statistics update only here), the
   critic in train mode (its statistics update too), label -1; gradients
   reach G and the critic's BN scale and bias only (`inputs=`: no weight
   gradient for the frozen conv and head weights), and one RMSprop apply
   over every G and critic parameter, the frozen ones with a zero gradient
   (their nu decays by 0.9, their weights keep every bit). No clip here.

Latents come from the state's device generator (z_fake every step, the
gp interpolation weights with gp_lambda > 0, z_gan on gan steps) unless the
caller passes them. Parameters, RMSprop state and BN statistics are
updated in place; `train_step` returns the same state object.

No host sync happens inside a step. The cadence is deterministic, so
`critic_count` is a host integer (the JAX step keeps it on the device and
branches with lax.cond); the step counter, the losses and
`did_gan_update` are device tensors, and `g_loss` is float32 0 on steps
without a gan update.

Data parallelism (`group`, a core.mesh.DataGroup; parallel/dp.py): each
rank takes its block of rows of the global batch; z_fake, the gp
interpolation weights and z_gan are drawn for the global batch, in the
one-device order, from `z_gen`, seeded alike on every rank, and each rank
keeps its rows; both models' BatchNorms take global statistics in train
mode; the gradients are averaged over the ranks before every RMSprop
apply; the weight clip stays elementwise on each rank's replica, and the
n_critic cadence is a host integer that is the same on every rank.

Spatial partitioning (a group with spatial > 1): `batch_u8` is the rank's
block of image rows too (the feed cuts it), the models are partitioned
(nn/layers.partition), and the gradient penalty's per-image squared norm
of grad D(x_hat) is summed over the spatial peers (`dp.spatial_sum`)
before its square root.
"""

from __future__ import annotations

import dataclasses

import torch

from imagegeneration_tpu_torch.core import rng as rnglib
from imagegeneration_tpu_torch.core import trace
from imagegeneration_tpu_torch.core.data import normalize
from imagegeneration_tpu_torch.models import wgan
from imagegeneration_tpu_torch.nn.layers import partition
from imagegeneration_tpu_torch.parallel import dp
from imagegeneration_tpu_torch.train import common

METRIC_KEYS = ("c_loss_real", "c_loss_fake", "g_loss", "did_gan_update")


@dataclasses.dataclass(frozen=True)
class WGANTrainConfig:
    model: wgan.WGANConfig = wgan.WGANConfig()
    batch_size: int = 32
    n_critic: int = 5  # wasserstein_gan/Trainer.py:49
    learning_rate: float = 5e-5  # WGAN.py:99,150
    # > 0: WGAN-GP (arXiv:1704.00028) in place of the reference's weight clip.
    gp_lambda: float = 0.0
    seed: int = rnglib.DEFAULT_MODEL_SEED


@dataclasses.dataclass
class WGANState:
    step: torch.Tensor  # 0-d int64 on the device
    critic_count: int  # batches since the last gan update
    gen: wgan.Generator
    critic: wgan.Critic
    c_opt: common.RMSpropState  # over the critic's parameters
    gan_opt: common.RMSpropState  # over G's parameters, then the critic's
    z_gen: torch.Generator  # the "z" stream, on the device

    @property
    def device(self) -> torch.device:
        return self.step.device

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "critic_count": self.critic_count,
            "gen": self.gen.state_dict(),
            "critic": self.critic.state_dict(),
            "c_opt": self.c_opt.state_dict(),
            "gan_opt": self.gan_opt.state_dict(),
            "z_gen": self.z_gen.get_state(),
        }

    def load_state_dict(self, sd: dict) -> None:
        with torch.no_grad():
            self.step.copy_(sd["step"])
        self.critic_count = int(sd["critic_count"])
        self.gen.load_state_dict(sd["gen"])
        self.critic.load_state_dict(sd["critic"])
        self.c_opt.load_state_dict(sd["c_opt"])
        self.gan_opt.load_state_dict(sd["gan_opt"])
        self.z_gen.set_state(sd["z_gen"].cpu())


def init_state(cfg: WGANTrainConfig, device: torch.device | str) -> WGANState:
    """Initial state; weights are drawn on the CPU from the "params" stream,
    so they are the same on every device for a seed."""
    chain = rnglib.KeyChain(cfg.seed)
    gen, critic = wgan.make_models(
        cfg.model, (chain.generator("params", step=0), chain.generator("params", step=1)))
    common.place(gen, device, cfg.model.dtype)
    common.place(critic, device, cfg.model.dtype)
    c_params = list(critic.parameters())
    return WGANState(
        step=torch.zeros((), dtype=torch.int64, device=device),
        critic_count=0,
        gen=gen,
        critic=critic,
        c_opt=common.rmsprop_init(c_params),
        gan_opt=common.rmsprop_init(list(gen.parameters()) + c_params),
        z_gen=chain.generator("z", device),
    )


def gradient_penalty(critic: wgan.Critic, x_real: torch.Tensor, x_fake: torch.Tensor,
                     eps: torch.Tensor, group=None) -> torch.Tensor:
    """mean((sqrt(sum(g^2) + 1e-12) - 1)^2) with g = d sum(D(x_hat)) / d x_hat
    through an inference-mode critic; the graph is kept, so the penalty's
    gradient reaches the critic's parameters (double backward). Under a
    spatial partition each rank holds its image rows of g, and sum(g^2) is
    summed over the spatial peers."""
    x_hat = (eps * x_real + (1.0 - eps) * x_fake).detach().requires_grad_(True)
    (g,) = torch.autograd.grad(critic(x_hat, train=False).sum(), x_hat, create_graph=True)
    g = g.float()
    sq = torch.sum(g * g, dim=(1, 2, 3))
    if group is not None and group.sharded:
        sq = dp.spatial_sum(sq, group)
    norms = torch.sqrt(sq + 1e-12)
    return torch.mean((norms - 1.0) ** 2)


def make_train_step(cfg: WGANTrainConfig, group=None):
    """Build `train_step(state, batch_u8, z_fake=None, z_gan=None,
    gp_eps=None) -> (state, metrics)`. batch_u8: (B, H, W, C) uint8 on the
    state's device; z_fake, z_gan: (B, z_size); gp_eps: (B, 1, 1, 1), used
    with gp_lambda > 0. Metrics are 0-d device tensors keyed by
    METRIC_KEYS. With a group, batch_u8 is this rank's rows (and under a
    spatial partition its image rows) of the global batch and z_fake, z_gan
    and gp_eps (drawn or passed) cover the global batch."""
    mcfg = cfg.model
    lr = cfg.learning_rate
    use_gp = cfg.gp_lambda > 0.0

    def critic_update(state: WGANState, x: torch.Tensor, label: float,
                      gp_inputs: tuple[torch.Tensor, torch.Tensor] | None = None):
        critic = state.critic
        params = list(critic.parameters())
        with trace.span("train.forward"):
            penalty = None
            if gp_inputs is not None:
                penalty = gradient_penalty(critic, x, *gp_inputs, group=group)
            scores = critic(x, train=True)
            loss = common.wasserstein_loss(torch.full_like(scores, label), scores)
            if penalty is not None:
                loss = loss + cfg.gp_lambda * penalty
        with trace.span("train.backward"):
            grads = torch.autograd.grad(loss, params)
        common.rmsprop_apply(params, grads, state.c_opt, lr, group=group)
        if not use_gp:
            wgan.clip_critic_kernels_(critic)
        return loss.detach()

    def gan_update(state: WGANState, z: torch.Tensor) -> torch.Tensor:
        gen, critic = state.gen, state.critic
        g_params = list(gen.parameters())
        bn_params = wgan.critic_bn_params(critic)
        with trace.span("train.forward"):
            scores = critic(gen(z, train=True), train=True)
            loss = common.wasserstein_loss(torch.full_like(scores, -1.0), scores)
        with trace.span("train.backward"):
            grads = torch.autograd.grad(loss, g_params + bn_params)
        bn_grads = dict(zip(map(id, bn_params), grads[len(g_params):]))
        c_params = list(critic.parameters())
        common.rmsprop_apply(
            g_params + c_params,
            list(grads[:len(g_params)]) + [bn_grads.get(id(p)) for p in c_params],
            state.gan_opt, lr, group=group)
        return loss.detach().float()

    def train_step(state: WGANState, batch_u8: torch.Tensor,
                   z_fake: torch.Tensor | None = None,
                   z_gan: torch.Tensor | None = None,
                   gp_eps: torch.Tensor | None = None):
        device, bsz = state.device, batch_u8.shape[0]
        rows = common.shard_rows(group, bsz)
        partition(state.gen, group)
        partition(state.critic, group)
        x_real = normalize(batch_u8, mcfg.dtype).permute(0, 3, 1, 2)
        if z_fake is None:
            z_fake = rnglib.normal_z(state.z_gen, rows[1], mcfg.z_size, device)
        with torch.no_grad(), trace.span("train.forward"):
            x_fake = state.gen(common.global_draw(z_fake, rows, bsz), train=False)

        gp_inputs = None
        if use_gp:
            if gp_eps is None:
                gp_eps = torch.rand((rows[1], 1, 1, 1), generator=state.z_gen, device=device)
            gp_inputs = (x_fake, common.global_draw(gp_eps, rows, bsz))
        c_loss_real = critic_update(state, x_real, -1.0, gp_inputs)
        c_loss_fake = critic_update(state, x_fake, 1.0)

        state.critic_count += 1
        did_gan = state.critic_count >= cfg.n_critic
        if did_gan:
            if z_gan is None:
                z_gan = rnglib.normal_z(state.z_gen, rows[1], mcfg.z_size, device)
            g_loss = gan_update(state, common.global_draw(z_gan, rows, bsz))
            state.critic_count = 0
        else:
            g_loss = torch.zeros((), dtype=torch.float32, device=device)

        with torch.no_grad():
            state.step.add_(1)
        return state, {
            "c_loss_real": c_loss_real,
            "c_loss_fake": c_loss_fake,
            "g_loss": g_loss,
            "did_gan_update": torch.full((), float(did_gan), device=device),
        }

    return train_step


def make_sampler(cfg: WGANTrainConfig):
    """`sample(state, z) -> (B, H, W, C)` float32 images in [0, 1]: G(z)
    with inference-mode BN, (x + 1) / 2 (WGAN.py:232-234)."""

    @torch.no_grad()
    def sample(state: WGANState, z: torch.Tensor) -> torch.Tensor:
        partition(state.gen, None)  # whole images on this process alone
        imgs = state.gen(z, train=False)
        return ((imgs + 1.0) / 2.0).permute(0, 2, 3, 1)

    return sample


def make_epoch_runner(cfg: WGANTrainConfig, group=None):
    """`run_epoch(state, images_u8, perm) -> (state, metrics)` over a
    device-resident uint8 dataset (N, H, W, C) and a (nb, B) device index
    table (with a group, this rank's columns of the global table); metrics
    come back stacked per batch, still on the device."""
    step_fn = make_train_step(cfg, group)

    def run_epoch(state: WGANState, images_u8: torch.Tensor, perm: torch.Tensor):
        per_step = []
        for b in range(perm.shape[0]):
            with trace.span(trace.STEP):
                state, m = step_fn(state, images_u8.index_select(0, perm[b]))
            per_step.append(m)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in METRIC_KEYS}

    return run_epoch
