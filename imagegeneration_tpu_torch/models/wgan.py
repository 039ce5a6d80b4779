"""WGAN generator and critic.

The counterpart of imagegeneration_tpu/models/wgan.py, with the same
architecture, parameter names and config fields (reference:
wasserstein_gan/WGAN.py:53-134):

- Critic: 7 TF-SAME convs with bias and Keras RandomNormal(0.02) kernels
  (64@3x3s1, 128@4x4s2, 128@3x3s1, 256@4x4s2, 256@3x3s1, 512@4x4s2,
  512@3x3s1; fixed widths whatever base_width is), each followed by
  BatchNorm and LeakyReLU (0.2 for the first five, 0.1 for the last two),
  then an NHWC-order flatten and a Dense(1) head (glorot, with bias). The
  scores are float32, with no sigmoid.
- Generator: z -> Dense(base*H/8*W/8, no bias, glorot) -> LeakyReLU(0.2) ->
  reshape in NHWC order to (H/8, W/8, base) -> 3 x [ConvT 4x4 s2 SAME no
  bias, N(0, 0.02) -> BN -> LeakyReLU(0.2)] -> a plain Conv 3x3 s1 SAME no
  bias, N(0, 0.02) (not a ConvT, unlike SNDCGAN) -> tanh, float32.

The ±0.01 weight clip of the reference's kernel constraint is applied by
the train step after each critic apply (`clip_critic_kernels_`); the gan
update trains the critic's BatchNorm scale and bias only
(`critic_bn_params`).

Image tensors are NCHW logical and channels_last in memory, so the NHWC
reshape and flatten are views. float64 is accepted as a compute dtype for
the parity tests against the JAX package's float64 step.

Under a spatial partition (`nn.layers.partition` with a core.mesh.DataGroup
of spatial > 1) every image map is the rank's block of rows: the
generator's Dense stem computes the whole H/8 map and keeps the rank's
rows, the convs exchange halos, the critic's BatchNorms sum their
statistics over the world, and the head sums its partial products over
the spatial peers. `min_sharded_height` is the guard's input, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from imagegeneration_tpu_torch.core.mesh import spatial_row_range
from imagegeneration_tpu_torch.nn.layers import BatchNorm, Conv, ConvTranspose, Dense

CLIP_VALUE = 0.01  # wasserstein_gan/WGAN.py:57


@dataclasses.dataclass(frozen=True)
class WGANConfig:
    image_size: tuple[int, int, int] = (144, 256, 3)  # wasserstein_gan/Trainer.py:12
    z_size: int = 128  # WGAN.py:173
    base_width: int = 512
    dtype: torch.dtype = torch.float32

    def __post_init__(self) -> None:
        if self.dtype not in (torch.float32, torch.bfloat16, torch.float64):
            raise ValueError(f"dtype must be float32, bfloat16 or float64, got {self.dtype}")


# (filters, kernel, stride, leaky alpha) of the critic trunk (WGAN.py:60-93).
CRITIC_TRUNK = (
    (64, (3, 3), (1, 1), 0.2),
    (128, (4, 4), (2, 2), 0.2),
    (128, (3, 3), (1, 1), 0.2),
    (256, (4, 4), (2, 2), 0.2),
    (256, (3, 3), (1, 1), 0.2),
    (512, (4, 4), (2, 2), 0.1),
    (512, (3, 3), (1, 1), 0.1),
)


def min_sharded_height(cfg: WGANConfig) -> int:
    """Smallest spatially partitioned feature height: the critic's three
    4x4 s2 convs (and the generator's H/8 stem map) bottom out at H/8.
    Input to core/mesh.check_spatial_partition."""
    return cfg.image_size[0] // 8


class Critic(nn.Module):
    """Wasserstein critic: images (B, C, H, W) -> scores (B, 1) float32."""

    def __init__(self, cfg: WGANConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        h, w, c = cfg.image_size
        feats = c
        for i, (out, k, s, _) in enumerate(CRITIC_TRUNK):
            self.add_module(f"conv{i}", Conv(
                feats, out, k, s, "SAME", dtype=cfg.dtype, generator=generator,
                kernel_init="normal_002"))
            self.add_module(f"conv{i}_bn", BatchNorm(out, dtype=cfg.dtype))
            feats = out
            h, w = -(-h // s[0]), -(-w // s[1])
        self.head = Dense(feats * h * w, 1, dtype=cfg.dtype, generator=generator,
                          sharded_input=True)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        """train=True: batch statistics, and the BN running statistics are
        updated in place; False: the running statistics."""
        x = x.to(self.cfg.dtype)
        for i, (_, _, _, alpha) in enumerate(CRITIC_TRUNK):
            x = getattr(self, f"conv{i}")(x)
            x = F.leaky_relu(getattr(self, f"conv{i}_bn")(x, not train), alpha)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.head(x).float()


class Generator(nn.Module):
    """WGAN generator: z (B, z_size) -> images (B, C, H, W) in [-1, 1],
    float32, channels_last."""

    def __init__(self, cfg: WGANConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        h, w, c = cfg.image_size
        base, dt = cfg.base_width, cfg.dtype
        self.hw8 = (h // 8, w // 8)
        self.stem = Dense(cfg.z_size, base * self.hw8[0] * self.hw8[1], use_bias=False,
                          dtype=dt, generator=generator)
        feats = base
        for i, out in enumerate((base // 2, base // 4, base // 8)):
            self.add_module(f"up{i}", ConvTranspose(
                feats, out, (4, 4), (2, 2), use_bias=False, dtype=dt,
                generator=generator, kernel_init="normal_002"))
            self.add_module(f"up{i}_bn", BatchNorm(out, dtype=dt))
            feats = out
        self.to_rgb = Conv(feats, c, (3, 3), (1, 1), "SAME", use_bias=False, dtype=dt,
                           generator=generator, kernel_init="normal_002")
        self.group = None  # a spatial partition: images are the rank's rows

    def forward(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = F.leaky_relu(self.stem(z), 0.2)
        x = x.view(x.shape[0], *self.hw8, -1).permute(0, 3, 1, 2)
        lo, hi = spatial_row_range(self.group, self.hw8[0])
        x = x[:, :, lo:hi]
        for i in range(3):
            up, bn = getattr(self, f"up{i}"), getattr(self, f"up{i}_bn")
            x = F.leaky_relu(bn(up(x), not train), 0.2)
        return torch.tanh(self.to_rgb(x).float())


def make_models(
    cfg: WGANConfig, generators: tuple[torch.Generator | None, torch.Generator | None]
    = (None, None),
) -> tuple[Generator, Critic]:
    return Generator(cfg, generators[0]), Critic(cfg, generators[1])


def critic_kernels(critic: Critic) -> list[torch.Tensor]:
    """The 7 conv weights, the only critic parameters the Keras kernel
    constraint clips (WGAN.py:60-93): not their biases, not BN, not the
    head."""
    return [getattr(critic, f"conv{i}").weight for i in range(len(CRITIC_TRUNK))]


@torch.no_grad()
def clip_critic_kernels_(critic: Critic, clip: float = CLIP_VALUE) -> None:
    """Clip the conv weights to [-clip, clip] in place (min(max(w, -clip),
    clip), as jnp.clip)."""
    kernels = critic_kernels(critic)
    clip = float(torch.tensor(clip, dtype=torch.float32))  # float32's 0.01, also for float64 leaves
    torch._foreach_clamp_min_(kernels, -clip)
    torch._foreach_clamp_max_(kernels, clip)


def critic_bn_params(critic: Critic) -> list[torch.Tensor]:
    """BatchNorm scale and bias of every critic block: the only critic
    parameters the gan update trains (WGAN.py:140-142)."""
    out = []
    for i in range(len(CRITIC_TRUNK)):
        bn = getattr(critic, f"conv{i}_bn")
        out += [bn.scale, bn.bias]
    return out
