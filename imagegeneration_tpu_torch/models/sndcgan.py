"""SNDCGAN generator and discriminator.

The counterpart of imagegeneration_tpu/models/sndcgan.py, with the same
architecture, parameter shapes and config fields:

- Generator: z -> Dense(base*H/8*W/8, no bias) -> BN -> ReLU -> reshape in
  NHWC order to (H/8, W/8, base) -> 3 x [ConvT 4x4 s2 SAME no bias -> BN ->
  ReLU] -> Conv 3x3 s1 SAME no bias (the JAX package lowers this stride-1
  ConvTranspose to a plain conv) -> tanh.
- Discriminator: 7 SAME convs (64@3x3s1, 128@4x4s2, 128@3x3s1, 256@4x4s2,
  256@3x3s1, 512@4x4s2, 512@3x3s1; fixed widths whatever base_width is),
  each followed by fused LeakyReLU(0.1) + hash dropout, then an NHWC-order
  flatten and a Dense(1) head; spectral norm on every conv and the head when
  `spectral_norm=True`. `features=True` returns the 8x8 average-pooled
  trunk (the FID extractor).

Image tensors are NCHW logical and channels_last in memory, so the NHWC
reshape and flatten are views, and the dropout kernel's mask index (the
NHWC linear index of the JAX package) is the memory offset. A data-parallel
rank passes `rows=(first row, global batch)`, so that every site's mask is
the global batch's at the rank's rows. float64 is accepted as a compute
dtype for the CPU parity tests against the JAX package's float64 step (the
kernels take float32 and bfloat16 only).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from imagegeneration_tpu_torch.core.mesh import spatial_row_range
from imagegeneration_tpu_torch.nn.layers import (
    BatchNorm,
    Conv,
    ConvTranspose,
    Dense,
)
from imagegeneration_tpu_torch.nn.spectral_norm import (
    SpectralNormConv,
    SpectralNormDense,
)
from imagegeneration_tpu_torch.ops.dropout import (
    NEGATIVE_SLOPE,
    dropout_cut,
    leaky_relu_dropout,
)

@dataclasses.dataclass(frozen=True)
class SNDCGANConfig:
    """Static model config (reference defaults: sndcgan/Trainer.py)."""

    image_size: tuple[int, int, int] = (144, 256, 3)  # (H, W, C)
    z_size: int = 128
    dropout_rate: float = 0.5
    base_width: int = 512
    spectral_norm: bool = False
    quirk_eval_bn: bool = False  # reference's inference-mode generator BN
    dtype: torch.dtype = torch.float32

    def __post_init__(self) -> None:
        dropout_cut(self.dropout_rate)  # validates the rate
        if self.dtype not in (torch.float32, torch.bfloat16, torch.float64):
            raise ValueError(f"dtype must be float32, bfloat16 or float64, got {self.dtype}")


class Generator(nn.Module):
    """DCGAN generator: z (B, z_size) -> images (B, C, H, W) in [-1, 1],
    float32, channels_last."""

    def __init__(self, cfg: SNDCGANConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        h, w, c = cfg.image_size
        base, dt = cfg.base_width, cfg.dtype
        self.hw8 = (h // 8, w // 8)
        stem = base * self.hw8[0] * self.hw8[1]
        self.stem = Dense(cfg.z_size, stem, use_bias=False, dtype=dt,
                          generator=generator)
        self.stem_bn = BatchNorm(stem, dtype=dt)
        feats = base
        for i, out in enumerate((base // 2, base // 4, base // 8)):
            self.add_module(f"up{i}", ConvTranspose(
                feats, out, (4, 4), (2, 2), use_bias=False, dtype=dt,
                generator=generator))
            self.add_module(f"up{i}_bn", BatchNorm(out, dtype=dt))
            feats = out
        self.to_rgb = Conv(feats, c, (3, 3), (1, 1), "SAME", use_bias=False,
                           dtype=dt, generator=generator)
        self.group = None  # a spatial partition: images are the rank's rows

    def forward(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        bn_inference = (not train) or self.cfg.quirk_eval_bn
        x = self.stem_bn(self.stem(z), bn_inference, 0.0)  # BN, then ReLU
        x = x.view(x.shape[0], *self.hw8, -1).permute(0, 3, 1, 2)
        lo, hi = spatial_row_range(self.group, self.hw8[0])
        x = x[:, :, lo:hi]
        for i in range(3):
            up = getattr(self, f"up{i}")
            bn = getattr(self, f"up{i}_bn")
            x = bn(up(x), bn_inference, 0.0)
        return torch.tanh(self.to_rgb(x).float())


# (filters, kernel, stride) of the 7-conv trunk (sndcgan/SNDCGAN.py:73-120).
DISC_TRUNK = (
    (64, (3, 3), (1, 1)),
    (128, (4, 4), (2, 2)),
    (128, (3, 3), (1, 1)),
    (256, (4, 4), (2, 2)),
    (256, (3, 3), (1, 1)),
    (512, (4, 4), (2, 2)),
    (512, (3, 3), (1, 1)),
)
N_DROPOUT_SITES = len(DISC_TRUNK)


def min_sharded_height(cfg: SNDCGANConfig) -> int:
    """Smallest spatially partitioned feature height: the discriminator's
    three 4x4 s2 convs (and the generator's H/8 stem map) bottom out at H/8.
    Input to core/mesh.check_spatial_partition."""
    return cfg.image_size[0] // 8


def trunk_hw(image_hw: tuple[int, int]) -> tuple[int, int]:
    """Spatial size of the trunk output for an (H, W) input."""
    h, w = image_hw
    for _, _, (sh, sw) in DISC_TRUNK:
        h, w = -(-h // sh), -(-w // sw)
    return h, w


class Discriminator(nn.Module):
    """Conv critic: images (B, C, H, W) -> logits (B, 1) float32."""

    def __init__(self, cfg: SNDCGANConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        h, w, c = cfg.image_size
        conv = SpectralNormConv if cfg.spectral_norm else Conv
        feats = c
        for i, (out, k, s) in enumerate(DISC_TRUNK):
            self.add_module(f"conv{i}", conv(
                feats, out, k, s, "SAME", dtype=cfg.dtype, generator=generator))
            feats = out
        th, tw = trunk_hw((h, w))
        head = SpectralNormDense if cfg.spectral_norm else Dense
        self.head = head(feats * th * tw, 1, dtype=cfg.dtype, generator=generator,
                         sharded_input=True)
        self.group = None  # a spatial partition: images are the rank's rows

    def forward(
        self,
        x: torch.Tensor,
        kw: torch.Tensor | None = None,
        update_sn: bool = False,
        features: bool = False,
        rows: tuple[int, int] | None = None,
    ) -> torch.Tensor:
        """kw: (7, 2) dropout key words, one row per conv; None runs the
        trunk without dropout (inference). update_sn writes the spectral
        norm estimates `u`. rows: (first row, global batch) of this shard
        of a data-parallel batch; None for a whole batch. Under a spatial
        partition x is the rank's block of image rows."""
        sn = self.cfg.spectral_norm
        g = self.group
        sharded = g is not None and g.sharded
        x = x.to(self.cfg.dtype)
        for i in range(N_DROPOUT_SITES):
            conv = getattr(self, f"conv{i}")
            x = conv(x, update_sn) if sn else conv(x)
            x = x.contiguous(memory_format=torch.channels_last)
            if kw is None:
                x = F.leaky_relu(x, NEGATIVE_SLOPE)
            else:
                h = x.shape[2]
                hblock = (g.s * h, g.spatial * h) if sharded else None
                x = leaky_relu_dropout(x, kw[i], self.cfg.dropout_rate, rows, hblock)

        if features:
            if min(x.shape[2], x.shape[3]) < 8:
                raise ValueError(
                    f"FID feature extractor needs a trunk >= 8x8 after the "
                    f"three stride-2 convs (got {x.shape[2]}x{x.shape[3]}); "
                    f"use images >= 64px per side (reference: 144x256)."
                )
            x = F.avg_pool2d(x, 8, 8).contiguous(memory_format=torch.channels_last)
            return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()

        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        logits = self.head(x, update_sn) if sn else self.head(x)
        return logits.float()
