"""The SNDCGAN train step: one G update and two D updates per batch.

The counterpart of imagegeneration_tpu/train/sndcgan_step.py, in the
reference's order (sndcgan/SNDCGAN.py:241-269):

1. G pass: G(z) with train-mode BN (its running statistics update here,
   once per step), D on the fresh fake at the OLD spectral-norm `u` without
   writing it, the G loss, G gradients, G Adam apply.
2. D-real pass: D on the real batch, writing the new `u`; D gradients; D
   Adam apply.
3. D-fake pass: the real-updated D, at the new `u` (not written again), on
   the fake batch of step 1 (the PRE-update generator's); D gradients; D
   Adam apply. With `d_updates=1` steps 2 and 3 are one combined loss and
   one apply.

Dropout sites are numbered G-pass 0-6, D-real 7-13, D-fake 14-20; their key
words come from a (21, 2) table `kw`, derived on the device from the step
counter (core/rng.py) unless the caller passes one. The latent `z` comes
from the state's device generator unless passed. Parameters, moments, BN
statistics and `u` are updated in place (PyTorch idiom; the JAX step
returns new arrays); `train_step` returns the same state object.

No host sync happens inside a step: the step counter, the key words, Adam's
alpha and the metrics all stay on the device.

Two options of the JAX step's config: `opt_moments="bf16"` stores Adam's m
and v in bfloat16 (the update arithmetic stays float32; the Adam kernel's
bfloat16-moment form, ops/adam.py), and `remat_d=True` runs D on the fake
batch in the G pass and, with d_updates=2, the D-fake pass under
`torch.utils.checkpoint.checkpoint` (where the JAX step puts
`jax.checkpoint`): its activations are recomputed in the backward instead
of kept. The recompute draws the same dropout masks, from the key words
passed in, and writes no spectral-norm `u` (both passes run with
update_sn=False), so the state is bit-equal to a run without it; with
d_updates=2 the dropout forward kernel runs 14 more times a step (21 + 14
forwards, 21 backwards) and, under a spatial partition, those passes' halo
exchanges run again.

Data parallelism (`group`, a core.mesh.DataGroup; parallel/dp.py): each
rank takes its block of rows of the global batch. `z` is drawn for the
global batch from `z_gen`, seeded alike on every rank, and each rank keeps
its rows; the dropout key words are the same on every rank and each site's
mask is the global batch's at the rank's rows; the generator's BatchNorm
takes global statistics; the gradients are averaged over the ranks before
each of the three Adam applies, and the Adam kernel then runs on every
rank over the same gradients, so the replicated state stays bit-equal.
The metrics are the rank's own means: the engine averages them over the
ranks once per epoch.

Spatial partitioning (a group with spatial > 1): `batch_u8` is the rank's
block of image rows too (core/mesh.spatial_row_range; the feed cuts it),
the models are partitioned (nn/layers.partition: halo exchanges, the
stem's rows, the head's sum over the spatial peers), each dropout site's
mask is the whole map's at the rank's rows and image rows, and the
gradients are summed over the world and divided by the data size.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import checkpoint

from imagegeneration_tpu_torch.core import rng as rnglib
from imagegeneration_tpu_torch.core import trace
from imagegeneration_tpu_torch.core.data import normalize
from imagegeneration_tpu_torch.models import sndcgan
from imagegeneration_tpu_torch.nn.layers import partition
from imagegeneration_tpu_torch.train import common

N_SITES = 3 * sndcgan.N_DROPOUT_SITES
METRIC_KEYS = (
    "g_loss", "d_loss", "d_loss_real", "d_loss_fake", "d_prob_real",
    "d_prob_fake",
)


@dataclasses.dataclass(frozen=True)
class SNDCGANTrainConfig:
    model: sndcgan.SNDCGANConfig = sndcgan.SNDCGANConfig()
    batch_size: int = 32
    lr_gen: float = 2e-4  # sndcgan/Trainer.py:26-27
    lr_disc: float = 2e-4
    loss: str = "bce"  # "bce" (reference) | "hinge" (SN-GAN)
    # D optimizer applies per batch: 2 = the reference's (real, then the
    # stale fake on the real-updated D); 1 = one combined update.
    d_updates: int = 2
    # Recompute D's activations on the fake batch in the backwards of the G
    # pass and the D-fake pass instead of keeping them (the same state).
    remat_d: bool = False
    # Adam m/v storage: "f32" (the Keras trajectory) or "bf16" (float32
    # arithmetic, moments rounded to bfloat16 after each apply).
    opt_moments: str = "f32"
    seed: int = rnglib.DEFAULT_MODEL_SEED

    def __post_init__(self) -> None:
        if self.loss not in ("bce", "hinge"):
            raise ValueError(f"unknown loss {self.loss!r}")
        if self.d_updates not in (1, 2):
            raise ValueError(f"d_updates must be 1 or 2, got {self.d_updates}")
        if self.opt_moments not in ("f32", "bf16"):
            raise ValueError(f"opt_moments must be 'f32' or 'bf16', got {self.opt_moments!r}")

    @property
    def moment_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.opt_moments == "bf16" else torch.float32


@dataclasses.dataclass
class SNDCGANState:
    step: torch.Tensor  # 0-d int64 on the device
    gen: sndcgan.Generator
    disc: sndcgan.Discriminator
    g_opt: common.AdamState
    d_opt: common.AdamState
    z_gen: torch.Generator  # the "z" stream, on the device

    @property
    def device(self) -> torch.device:
        return self.step.device

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "gen": self.gen.state_dict(),
            "disc": self.disc.state_dict(),
            "g_opt": self.g_opt.state_dict(),
            "d_opt": self.d_opt.state_dict(),
            "z_gen": self.z_gen.get_state(),
        }

    def load_state_dict(self, sd: dict) -> None:
        with torch.no_grad():
            self.step.copy_(sd["step"])
        self.gen.load_state_dict(sd["gen"])
        self.disc.load_state_dict(sd["disc"])
        self.g_opt.load_state_dict(sd["g_opt"])
        self.d_opt.load_state_dict(sd["d_opt"])
        self.z_gen.set_state(sd["z_gen"].cpu())


def init_state(cfg: SNDCGANTrainConfig, device: torch.device | str) -> SNDCGANState:
    """Initial state; weights are drawn on the CPU from the "params" stream,
    so they are the same on every device for a seed."""
    chain = rnglib.KeyChain(cfg.seed)
    gen = sndcgan.Generator(cfg.model, chain.generator("params", step=0))
    disc = sndcgan.Discriminator(cfg.model, chain.generator("params", step=1))
    common.place(gen, device, cfg.model.dtype)
    common.place(disc, device, cfg.model.dtype)
    return SNDCGANState(
        step=torch.zeros((), dtype=torch.int64, device=device),
        gen=gen,
        disc=disc,
        g_opt=common.adam_init(list(gen.parameters()), cfg.moment_dtype),
        d_opt=common.adam_init(list(disc.parameters()), cfg.moment_dtype),
        z_gen=chain.generator("z", device),
    )


def make_train_step(cfg: SNDCGANTrainConfig, group=None):
    """Build `train_step(state, batch_u8, z=None, kw=None) -> (state,
    metrics)`. batch_u8: (B, H, W, C) uint8 on the state's device; z: (B,
    z_size) float32; kw: (21, 2) int64 dropout key words. Metrics are 0-d
    float32 device tensors. With a group, batch_u8 is this rank's rows (and
    under a spatial partition its image rows) of the global batch and z
    (drawn or passed) covers the global batch."""
    chain = rnglib.KeyChain(cfg.seed)
    mcfg = cfg.model
    hinge = cfg.loss == "hinge"

    def loss_real(logits):
        if hinge:
            return common.hinge_d_loss_real(logits)
        return common.bce_logits_mean(torch.ones_like(logits), logits)

    def loss_fake(logits):
        if hinge:
            return common.hinge_d_loss_fake(logits)
        return common.bce_logits_mean(torch.zeros_like(logits), logits)

    def train_step(state: SNDCGANState, batch_u8: torch.Tensor,
                   z: torch.Tensor | None = None,
                   kw: torch.Tensor | None = None):
        gen, disc, device = state.gen, state.disc, state.device
        g_params = list(gen.parameters())
        d_params = list(disc.parameters())
        local = batch_u8.shape[0]
        first, global_batch = common.shard_rows(group, local)
        rows = None if group is None else (first, global_batch)
        partition(gen, group)
        partition(disc, group)
        x_real = normalize(batch_u8, mcfg.dtype).permute(0, 3, 1, 2)
        if kw is None:
            kw = chain.dropout_kw(state.step, N_SITES)
        if z is None:
            z = rnglib.uniform_z(state.z_gen, global_batch, mcfg.z_size, device)
        z = common.global_draw(z, (first, global_batch), local)
        n = sndcgan.N_DROPOUT_SITES
        kw_g, kw_real, kw_fake = kw[:n], kw[n:2 * n], kw[2 * n:3 * n]

        def apply(params, grads, opt, lr):
            common.adam_apply(params, grads, opt, lr, group=group)

        def d_on_fake(x, kw_pass):
            """D on a fake batch, at the current `u` (not written); under
            remat_d recomputed in the backward (no torch RNG inside: the
            masks come from kw_pass)."""
            run = functools.partial(disc, update_sn=False, rows=rows)
            if cfg.remat_d:
                return checkpoint(run, x, kw_pass, use_reentrant=False,
                                  preserve_rng_state=False)
            return run(x, kw_pass)

        # ---- Generator update (D at the old `u`, not written).
        with trace.span("train.forward"):
            fake = gen(z, train=True)
            logits_g = d_on_fake(fake, kw_g)
            if hinge:
                g_loss = common.hinge_g_loss(logits_g)
            else:
                g_loss = common.bce_logits_mean(torch.ones_like(logits_g), logits_g)
        with trace.span("train.backward"):
            g_grads = torch.autograd.grad(g_loss, g_params)
        apply(g_params, g_grads, state.g_opt, cfg.lr_gen)
        fake = fake.detach()  # the PRE-update generator's batch

        if cfg.d_updates == 1:
            with trace.span("train.forward"):
                logits_real = disc(x_real, kw_real, update_sn=True, rows=rows)
                logits_fake = disc(fake, kw_fake, update_sn=False, rows=rows)
                d_loss_real = loss_real(logits_real)
                d_loss_fake = loss_fake(logits_fake)
            with trace.span("train.backward"):
                d_grads = torch.autograd.grad(d_loss_real + d_loss_fake, d_params)
            apply(d_params, d_grads, state.d_opt, cfg.lr_disc)
        else:
            # ---- D update #1: real batch, writes the new `u`.
            with trace.span("train.forward"):
                logits_real = disc(x_real, kw_real, update_sn=True, rows=rows)
                d_loss_real = loss_real(logits_real)
            with trace.span("train.backward"):
                d_grads = torch.autograd.grad(d_loss_real, d_params)
            apply(d_params, d_grads, state.d_opt, cfg.lr_disc)
            # ---- D update #2: stale fake batch on the real-updated D.
            with trace.span("train.forward"):
                logits_fake = d_on_fake(fake, kw_fake)
                d_loss_fake = loss_fake(logits_fake)
            with trace.span("train.backward"):
                d_grads = torch.autograd.grad(d_loss_fake, d_params)
            apply(d_params, d_grads, state.d_opt, cfg.lr_disc)

        with torch.no_grad():
            state.step.add_(1)
            metrics = {
                "g_loss": g_loss.detach(),
                "d_loss": (d_loss_real + d_loss_fake).detach(),
                "d_loss_real": d_loss_real.detach(),
                "d_loss_fake": d_loss_fake.detach(),
                "d_prob_real": torch.mean(torch.sigmoid(logits_real.float())),
                "d_prob_fake": torch.mean(torch.sigmoid(logits_fake.float())),
            }
        return state, metrics

    return train_step


def make_sampler(cfg: SNDCGANTrainConfig):
    """`sample(state, z) -> (B, H, W, C)` float32 images in [0, 1]:
    G(z) with inference-mode BN, denormalized (generator_output.py)."""

    @torch.no_grad()
    def sample(state: SNDCGANState, z: torch.Tensor) -> torch.Tensor:
        partition(state.gen, None)  # whole images on this process alone
        imgs = state.gen(z, train=False)
        return ((imgs + 1.0) / 2.0).permute(0, 2, 3, 1)

    return sample


def make_epoch_runner(cfg: SNDCGANTrainConfig, group=None):
    """`run_epoch(state, images_u8, perm) -> (state, metrics)` over a
    device-resident uint8 dataset (N, H, W, C) and a (nb, B) device index
    table (with a group, this rank's columns of the global table); metrics
    come back stacked per batch, still on the device."""
    step_fn = make_train_step(cfg, group)

    def run_epoch(state: SNDCGANState, images_u8: torch.Tensor, perm: torch.Tensor):
        per_step = []
        for b in range(perm.shape[0]):
            with trace.span(trace.STEP):
                state, m = step_fn(state, images_u8.index_select(0, perm[b]))
            per_step.append(m)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in METRIC_KEYS}

    return run_epoch
