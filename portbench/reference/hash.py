"""The dropout mask of the configurations that use one, frozen here.

The program under test keys its discriminator dropout by a counter hash
(the MurmurHash3 32-bit finalizer), one pair of key words per site and
step, derived from the training seed and the step number. The reference
needs the same masks to follow the same trajectory, so this file holds its
own copy of that arithmetic; it is part of the yardstick and changes only
with the benchmark:

    word(name)  = f(s ^ (index(name) + 1) * G),  s = f(seed ^ f(seed >> 32))
    h           = f(f(step) ^ word("dropout"))
    kw[site, j] = f(h ^ (2 * site + j + 1) * G)            (j = 0, 1)
    keep(i)     = ((f(i ^ k0) + k1) & 0xFF) >= round(rate * 256)

f is fmix32, G the golden-ratio word 0x9E3779B9, all arithmetic modulo
2**32, and i the element's linear index in NHWC order. A kept element is
scaled by 256 / (256 - cut).
"""

from __future__ import annotations

import torch

U32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
STREAMS = ("params", "z", "dropout", "data", "preview", "eval")


def fmix32_int(h: int) -> int:
    h &= U32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & U32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & U32
    return h ^ (h >> 16)


def _mul(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 on uint32 values held in int64, with c split in
    16-bit halves so that no product leaves int64."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & U32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def stream_word(seed: int, name: str) -> int:
    s = fmix32_int(seed ^ fmix32_int(seed >> 32))
    return fmix32_int(s ^ ((STREAMS.index(name) + 1) * GOLDEN))


def dropout_kw(seed: int, step: int, n_sites: int) -> list[tuple[int, int]]:
    """The (k0, k1) key words of each site at `step`, as Python ints."""
    h = fmix32_int(fmix32_int(step) ^ stream_word(seed, "dropout"))
    words = [fmix32_int(h ^ ((j * GOLDEN) & U32)) for j in range(1, 2 * n_sites + 1)]
    return [(words[2 * s], words[2 * s + 1]) for s in range(n_sites)]


def keep_mask(shape_nchw: tuple[int, ...], kw: tuple[int, int], cut: int,
              device) -> torch.Tensor:
    """Bool keep mask of an NCHW tensor, keyed by each element's NHWC index."""
    b, c, h, w = shape_nchw
    i = torch.arange(b * h * w * c, device=device, dtype=torch.int64)
    hashed = (fmix32(i ^ kw[0]) + kw[1]) & U32
    return ((hashed & 0xFF) >= cut).view(b, h, w, c).permute(0, 3, 1, 2)


def dropout_cut(rate: float) -> int:
    return round(rate * 256.0)
