"""Layers with the numerics of the Keras/flax layers of the JAX package.

Counterparts of imagegeneration_tpu/nn/layers.py (`Dense`, `Conv`,
`ConvTranspose`, `BatchNorm`). Stock PyTorch differs from Keras in ways
that change numbers, so each default is pinned here:

- kernel init is Keras `glorot_uniform`, bias zeros;
- SAME padding is TF's: total = max((ceil(n/s)-1)*s + k - n, 0), with the
  odd pixel on the bottom/right. For an even kernel at an odd extent that is
  asymmetric, which `Conv2d(padding=...)` cannot express, so it goes through
  an explicit `F.pad`;
- a SAME transposed conv has out = in * stride, with the padding rule of
  lax.conv_transpose (flax, `transpose_kernel=False`);
- BatchNorm is Keras's: momentum 0.99, epsilon 1e-3, statistics in float32,
  and the running variance is updated with the BIASED batch variance (flax),
  where `nn.BatchNorm2d` would use the unbiased one.

Parameters are float32; `dtype` is the compute dtype (bfloat16 on the main
path). Image tensors are NCHW logical and channels_last in memory, so that
their memory order is the JAX package's NHWC.

Not ported: the phase/hybrid/packed/swapdw ConvTranspose lowerings of the
JAX package, which work around TPU XLA; cuDNN lowers the transposed conv.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def glorot_uniform_(
    t: torch.Tensor, fan_in: int, fan_out: int, generator: torch.Generator | None
) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-limit, limit, generator=generator)


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TF-SAME (low, high) padding of one spatial dim."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d_same(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
    stride: tuple[int, int], padding: str,
) -> torch.Tensor:
    """conv2d with TF-SAME or VALID padding (w is OIHW)."""
    if padding == "VALID":
        return F.conv2d(x, w, b, stride)
    if padding != "SAME":
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    (hl, hh) = same_pads(x.shape[2], w.shape[2], stride[0])
    (wl, wh) = same_pads(x.shape[3], w.shape[3], stride[1])
    if hl == hh and wl == wh:
        return F.conv2d(x, w, b, stride, padding=(hl, wl))
    return F.conv2d(F.pad(x, (wl, wh, hl, hh)), w, b, stride)


def conv_transpose_same_pads(k: int, s: int) -> tuple[int, int]:
    """(low, high) padding lax.conv_transpose uses for SAME: pad_len =
    k + s - 2, low = k - 1 if s > k - 1 else ceil(pad_len / 2)."""
    pad_len = k + s - 2
    low = k - 1 if s > k - 1 else -(-pad_len // 2)
    return low, pad_len - low


class Dense(nn.Module):
    """y = x @ W^T + b; weight (out, in)."""

    def __init__(
        self, in_features: int, features: int, use_bias: bool = True,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        glorot_uniform_(self.weight, in_features, features, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv(nn.Module):
    """2D conv, TF-SAME/VALID padding; weight (out, in, kh, kw)."""

    def __init__(
        self, in_features: int, features: int, kernel_size: tuple[int, int],
        strides: tuple[int, int] = (1, 1), padding: str = "SAME",
        use_bias: bool = True, dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        kh, kw = kernel_size
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, kh, kw))
        glorot_uniform_(self.weight, kh * kw * in_features, kh * kw * features,
                        generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return conv2d_same(x.to(dt), self.weight.to(dt), b, self.strides,
                           self.padding)


class ConvTranspose(nn.Module):
    """2D transposed conv with SAME padding (out = in * stride).

    weight is (in, out, kh, kw) in PyTorch's conv_transpose layout: the
    spatially flipped, in/out-swapped flax kernel (bridge.py converts)."""

    def __init__(
        self, in_features: int, features: int, kernel_size: tuple[int, int],
        strides: tuple[int, int] = (1, 1), use_bias: bool = True,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        kh, kw = kernel_size
        pads = [conv_transpose_same_pads(k, s) for k, s in zip(kernel_size, strides)]
        if any(hi < lo for lo, hi in pads):
            raise ValueError(
                f"SAME ConvTranspose with kernel {kernel_size} at stride "
                f"{strides} needs a crop, which is not supported"
            )
        # lax pads the dilated input by (lo, hi); conv_transpose2d's
        # `padding` trims k-1-p from each side, `output_padding` adds the
        # extra high-side row/column.
        self.tpad = tuple(k - 1 - lo for k, (lo, _) in zip(kernel_size, pads))
        self.out_pad = tuple(hi - lo for lo, hi in pads)
        self.strides = tuple(strides)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_features, features, kh, kw))
        glorot_uniform_(self.weight, kh * kw * in_features, kh * kw * features,
                        generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(
            x.to(dt), self.weight.to(dt), b, self.strides, self.tpad, self.out_pad
        )


class BatchNorm(nn.Module):
    """Keras BatchNorm (momentum 0.99, eps 1e-3) over every axis but 1.

    Parameters `scale`, `bias`; running statistics `mean`, `var` (buffers).
    Statistics are float32: mean = E[x], var = max(E[x^2] - E[x]^2, 0)
    (flax's fast variance); the running variance takes this biased var."""

    def __init__(
        self, features: int, momentum: float = 0.99, epsilon: float = 1e-3,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, use_running_average: bool) -> torch.Tensor:
        xf = x.float()
        shape = [1, -1] + [1] * (x.dim() - 2)
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            dims = [d for d in range(x.dim()) if d != 1]
            mean = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype or torch.promote_types(x.dtype, torch.float32))
