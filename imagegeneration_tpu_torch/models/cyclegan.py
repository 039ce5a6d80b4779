"""CycleGAN resnet generator and PatchGAN discriminator.

The counterpart of imagegeneration_tpu/models/cyclegan.py, with the same
architecture, parameter names and config fields (reference:
cyclegan/CycleGAN.py:60-183):

- Generator: conv 7x7 s1 SAME (base) + IN + ReLU -> 2 x [ReflectionPad(1)
  + conv 3x3 s2 VALID + IN + ReLU] (base*2, base*4) -> n_res_blocks x
  ResBlock(base*4), with the post-add norm -> 2 x [ConvT 3x3 s2 SAME + IN +
  ReLU] (base*2, base) -> conv 7x7 s1 SAME (3) + IN + tanh. The norm before
  the tanh is the reference's; the output is float32.
- Discriminator (PatchGAN): 4 x [conv 4x4 s2 VALID (64, 128, 256, 512) (+ IN
  for all but the first) + LeakyReLU(0.2)] -> conv 4x4 s1 VALID (1). At
  128x128 the output is (B, 1, 3, 3) patch logits, float32. Inputs too small
  for the VALID stack raise ValueError, as in the JAX package.

Every per-channel InstanceNorm runs through the InstanceNorm kernel on a
card (the JAX config's `in_backend` has no counterpart: there is one
route). `quirk_axis1=True` selects the reference's bug-compatible axis=1
norm, in plain torch.

Image tensors are NCHW logical and channels_last in memory. float64 is
accepted as a compute dtype for the CPU parity tests against the JAX
package's float64 step (the kernels take float32 and bfloat16 only).

Under a spatial partition (nn/layers.partition with a core.mesh.DataGroup
of spatial factor S > 1; the JAX step's P('data', 'spatial') batch) the
generator runs on this rank's block of rows: its 7x7 SAME convs take halos
of 3 rows, its down convs a reflect halo of 1 (and then tile as VALID
convs: the shard's rows keep the stride's phase under the guard), its 18
res-block convs halos of 1, its ConvTransposes their input halos, and its
24 norms the whole maps' statistics (the split kernels). The PatchGAN's
VALID maps shrink by 3 rows per conv and do not tile over shards, so it
runs whole on every spatial peer (`runs_whole`), as the JAX package's
partitioner re-replicates them: it gathers its input's rows from the
peers; its parameter gradients are then the same on every peer, and the
step counts them once (train/cyclegan_step.py).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from imagegeneration_tpu_torch.nn.layers import (
    Conv,
    ConvTranspose,
    InstanceNorm,
    ResBlock,
    reflection_pad_2d,
)
from imagegeneration_tpu_torch.parallel.halo import gather_rows


@dataclasses.dataclass(frozen=True)
class CycleGANConfig:
    image_size: tuple[int, int, int] = (128, 128, 3)  # cyclegan/Trainer.py:5
    base_width: int = 64
    n_res_blocks: int = 9  # CycleGAN.py:168-176
    quirk_axis1: bool = False
    dtype: torch.dtype = torch.float32

    def __post_init__(self) -> None:
        if self.dtype not in (torch.float32, torch.bfloat16, torch.float64):
            raise ValueError(f"dtype must be float32, bfloat16 or float64, got {self.dtype}")


class Generator(nn.Module):
    """Resnet generator: (B, 3, H, W) in [-1, 1] -> (B, 3, H, W) in [-1, 1],
    float32, channels_last."""

    def __init__(self, cfg: CycleGANConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        h, _, c = cfg.image_size
        base, dt, q = cfg.base_width, cfg.dtype, cfg.quirk_axis1

        def norm(features: int, height: int) -> InstanceNorm:
            return InstanceNorm(features, q, height, dtype=dt, generator=generator)

        self.stem_conv = Conv(c, base, (7, 7), dtype=dt, generator=generator)
        self.stem_in = norm(base, h)
        feats = base
        for i, out in enumerate((base * 2, base * 4)):
            h = -(-h // 2)  # reflect-pad 1, 3x3 s2 VALID
            self.add_module(f"down{i}", Conv(feats, out, (3, 3), (2, 2), "VALID",
                                             dtype=dt, generator=generator, halo_fed=True))
            self.add_module(f"down{i}_in", norm(out, h))
            feats = out
        for i in range(cfg.n_res_blocks):
            self.add_module(f"res{i}", ResBlock(feats, q, h, dtype=dt, generator=generator))
        for i, out in enumerate((base * 2, base)):
            h *= 2
            self.add_module(f"up{i}", ConvTranspose(feats, out, (3, 3), (2, 2),
                                                    dtype=dt, generator=generator))
            self.add_module(f"up{i}_in", norm(out, h))
            feats = out
        self.to_rgb = Conv(feats, 3, (7, 7), dtype=dt, generator=generator)
        self.to_rgb_in = norm(3, h)
        self.group = None  # a spatial partition: images are the rank's rows

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.cfg.dtype)
        x = torch.relu(self.stem_in(self.stem_conv(x)))
        for i in range(2):
            x = self.get_submodule(f"down{i}")(reflection_pad_2d(x, (1, 1), self.group))
            x = torch.relu(self.get_submodule(f"down{i}_in")(x))
        for i in range(self.cfg.n_res_blocks):
            x = self.get_submodule(f"res{i}")(x)
        for i in range(2):
            x = self.get_submodule(f"up{i}")(x)
            x = torch.relu(self.get_submodule(f"up{i}_in")(x))
        x = self.to_rgb_in(self.to_rgb(x))
        return torch.tanh(x.float())


# (filters, use_norm) of the PatchGAN trunk (CycleGAN.py:112-122).
DISC_TRUNK = ((64, False), (128, True), (256, True), (512, True))


def _check_patch_input(h: int, w: int, before: int | None) -> None:
    """The JAX package's size guards: `before` is the index of the trunk
    conv about to run, None for the head."""
    if min(h, w) >= 4:
        return
    if before is None:
        raise ValueError(
            f"PatchGAN trunk output {h}x{w} smaller than the 4x4 head; input "
            f"resolution too small (needs >= 94px).")
    raise ValueError(
        f"PatchGAN input too small: spatial dims shrank to {h}x{w} before "
        f"conv{before}; the VALID 4x4 stack needs >= 94px input (reference "
        f"uses 128).")


class Discriminator(nn.Module):
    """PatchGAN: (B, 3, H, W) -> (B, 1, h, w) patch logits, float32. Under a
    spatial partition the input is the rank's rows, gathered to the whole
    map first; the layers run without a group (`runs_whole`)."""

    runs_whole = True

    def __init__(self, cfg: CycleGANConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        h, w, c = cfg.image_size
        feats = c
        for i, (out, use_norm) in enumerate(DISC_TRUNK):
            _check_patch_input(h, w, i)
            h, w = (h - 4) // 2 + 1, (w - 4) // 2 + 1
            self.add_module(f"conv{i}", Conv(feats, out, (4, 4), (2, 2), "VALID",
                                             dtype=cfg.dtype, generator=generator))
            if use_norm:
                self.add_module(f"conv{i}_in", InstanceNorm(
                    out, cfg.quirk_axis1, h, dtype=cfg.dtype, generator=generator))
            feats = out
        _check_patch_input(h, w, None)
        self.head = Conv(feats, 1, (4, 4), (1, 1), "VALID", dtype=cfg.dtype,
                         generator=generator)
        self.group = None  # a spatial partition: the input is the rank's rows

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is not None and self.group.sharded:
            x = gather_rows(x, self.group)
        x = x.to(self.cfg.dtype)
        for i, (_, use_norm) in enumerate(DISC_TRUNK):
            _check_patch_input(x.shape[2], x.shape[3], i)
            x = self.get_submodule(f"conv{i}")(x)
            if use_norm:
                x = self.get_submodule(f"conv{i}_in")(x)
            x = F.leaky_relu(x, 0.2)
        _check_patch_input(x.shape[2], x.shape[3], None)
        return self.head(x).float()


def make_models(
    cfg: CycleGANConfig, generators: list[torch.Generator | None] | None = None
) -> tuple[Generator, Generator, Discriminator, Discriminator]:
    """(generator_g, generator_f, discriminator_x, discriminator_y): two
    independent generator/discriminator pairs (CycleGAN.py:235-239), each
    drawn from its own torch.Generator when given."""
    gens = generators or [None] * 4
    return (Generator(cfg, gens[0]), Generator(cfg, gens[1]),
            Discriminator(cfg, gens[2]), Discriminator(cfg, gens[3]))


def min_sharded_height(cfg: CycleGANConfig) -> int:
    """Smallest spatially partitioned feature height: the generator's H/4
    maps after its two stride-2 down convs, where the res blocks run (the
    PatchGAN runs whole). Input to core/mesh.check_spatial_partition, as
    the JAX package's CycleGAN engine passes it."""
    return cfg.image_size[0] // 4
