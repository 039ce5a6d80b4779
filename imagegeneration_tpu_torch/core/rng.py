"""PRNG contract of the port: named streams from one workload seed.

The counterpart of imagegeneration_tpu/core/rng.py. The JAX package draws
every random number from threefry keys folded by stream name and step; this
port does not reproduce threefry (PyTorch has no threefry, and the two
frameworks' generators give different numbers for the same seed). Its
contract is the same in kind: for a fixed seed, every (stream, step) draw
is bitwise stable within the port, on every run.

Streams (the names of the JAX package):
  params   model initialization (CPU torch.Generator, so the initial
           weights do not depend on the device)
  z        latent draws (a torch.Generator on the training device; its
           state is checkpointed)
  dropout  discriminator dropout key words, derived ON THE DEVICE from the
           step counter by a counter hash: (seed, step, site) -> (k0, k1)
  data     dataset shuffles (numpy Generator per epoch)
  preview  fixed preview latents
  eval     evaluation draws

Parity tests against the JAX package do not rely on any of these: they
make inputs with numpy and pass `z` and the dropout key words explicitly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Reference seeds, kept as the framework defaults (core/rng.py of the JAX
# package: tf seed 62, dataset seed 123).
DEFAULT_MODEL_SEED = 62
DEFAULT_DATA_SEED = 123

_STREAMS = ("params", "z", "dropout", "data", "preview", "eval")
_U32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


# ------------------------------------------------- uint32 hash in int64 ops
def mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for uint32 values held in int64. The constant is
    split into 16-bit halves so that no intermediate overflows int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _U32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 32-bit finalizer on uint32 values held in int64 (the
    hash of imagegeneration_tpu/ops/bitdropout.py `_fmix32`)."""
    h = h ^ (h >> 16)
    h = mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul_u32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _fmix32_int(h: int) -> int:
    h &= _U32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _U32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _U32
    return h ^ (h >> 16)


@dataclasses.dataclass(frozen=True)
class KeyChain:
    """Named, per-step PRNG streams derived from one workload seed."""

    seed: int = DEFAULT_MODEL_SEED

    def _stream_word(self, name: str) -> int:
        if name not in _STREAMS:
            raise ValueError(f"unknown stream {name!r}; known: {_STREAMS}")
        s = _fmix32_int(self.seed ^ _fmix32_int(self.seed >> 32))
        return _fmix32_int(s ^ ((_STREAMS.index(name) + 1) * _GOLDEN))

    def stream_seed(self, name: str, step: int = 0) -> int:
        """A 63-bit seed for (stream, step)."""
        w = self._stream_word(name)
        hi = _fmix32_int(w ^ _fmix32_int(step))
        lo = _fmix32_int(hi ^ _GOLDEN ^ (step >> 32))
        return ((hi << 32) | lo) & ((1 << 63) - 1)

    def generator(
        self, name: str, device: torch.device | str = "cpu", step: int = 0
    ) -> torch.Generator:
        gen = torch.Generator(device=device)
        gen.manual_seed(self.stream_seed(name, step))
        return gen

    def numpy_rng(self, name: str = "data", epoch: int = 0) -> np.random.Generator:
        """Host-side generator for dataset shuffling (stable across runs)."""
        return np.random.default_rng(
            [self.seed & _U32, self.seed >> 32, _STREAMS.index(name), epoch]
        )

    def dropout_kw(self, step: torch.Tensor, n_sites: int) -> torch.Tensor:
        """(n_sites, 2) int64 table of uint32 key words for one step.

        Computed on `step`'s device from the device step counter, with no
        host sync: word j of site s is fmix32(h ^ (2s + j + 1) * golden)
        where h = fmix32(seed-word ^ fmix32(step))."""
        base = self._stream_word("dropout")
        h = fmix32(fmix32(step.to(torch.int64) & _U32) ^ base)
        j = torch.arange(1, 2 * n_sites + 1, device=step.device, dtype=torch.int64)
        return fmix32(h ^ mul_u32(j, _GOLDEN)).view(n_sites, 2)


def uniform_z(
    gen: torch.Generator, batch: int, z_size: int, device: torch.device | str
) -> torch.Tensor:
    """SNDCGAN latent: U[-1, 1) (sndcgan/SNDCGAN.py:283), float32."""
    u = torch.rand((batch, z_size), generator=gen, device=device)
    return -1.0 + 2.0 * u


def normal_z(
    gen: torch.Generator, batch: int, z_size: int, device: torch.device | str
) -> torch.Tensor:
    """WGAN latent: standard normal (wasserstein_gan/WGAN.py:212-217), float32."""
    return torch.randn((batch, z_size), generator=gen, device=device)
