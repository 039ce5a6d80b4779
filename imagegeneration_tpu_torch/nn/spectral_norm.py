"""Spectral normalization with one power-iteration step per forward.

The counterpart of imagegeneration_tpu/nn/spectral_norm.py (Miyato et al.
2018). The kernel is viewed as a matrix with `out` columns, `u` (out,) is
the persistent singular-vector estimate, and each forward does

    v = normalize(W u);  new_u = normalize(W^T v);  sigma = v . (W new_u)

in float32 whatever the compute dtype, then uses W / sigma. sigma and new_u
are constants for autodiff (stop-gradient in the JAX package), which is why
`torch.nn.utils.spectral_norm`, which backpropagates through sigma, is not
used. `u` is written only when the caller passes `update_sn=True`; sigma
comes from the power step either way.

W here is the PyTorch weight flattened to (out, rest) in OIHW order (for
the channels_last conv weight, `flatten` copies), the JAX package's
(kh*kw*in, out) matrix transposed with its rows permuted. sigma and new_u
do not depend on the order of those rows.

Under a (data, spatial) mesh the weights are replicated, so the power step
is the same on every rank; the layers take the spatial partition of their
plain counterparts (nn/layers.py: halo exchanges in the conv, a partial
product summed over the spatial peers in a `sharded_input` Dense).
"""

from __future__ import annotations

import torch
from torch import nn

from imagegeneration_tpu_torch.nn.layers import conv2d_same, conv_weight, dense, glorot_uniform_

_EPS = 1e-12


def l2_normalize(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(torch.sum(v * v) + _EPS)


@torch.no_grad()
def power_iteration(
    w_rows: torch.Tensor, u: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One step on W = w_rows^T (w_rows: (out, M) float32). Returns
    (sigma, new_u)."""
    v = l2_normalize(u @ w_rows)  # W u, (M,)
    new_u = l2_normalize(w_rows @ v)  # W^T v, (out,)
    sigma = v @ (new_u @ w_rows)  # v . (W new_u)
    return sigma, new_u


class _SpectralNorm(nn.Module):
    weight: nn.Parameter

    def _init_u(self, features: int, generator: torch.Generator | None) -> None:
        self.register_buffer(
            "u", l2_normalize(torch.randn(features, generator=generator))
        )

    def normalized_weight(self, update_sn: bool) -> torch.Tensor:
        w32 = self.weight.float()
        sigma, new_u = power_iteration(w32.detach().flatten(1), self.u.float())
        if update_sn:
            with torch.no_grad():
                self.u.copy_(new_u)
        return w32 / torch.clamp(sigma, min=_EPS)


class SpectralNormConv(_SpectralNorm):
    """2D conv with a spectrally normalized kernel, TF-SAME padding."""

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
        self.weight = conv_weight((features, in_features, kh, kw), generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self._init_u(features, generator)
        self.group = None

    def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
        dt = self.dtype
        w = self.normalized_weight(update_sn).to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        return conv2d_same(x.to(dt), w, b, self.strides, self.padding, self.group)


class SpectralNormDense(_SpectralNorm):
    """Dense layer with a spectrally normalized kernel (the D head)."""

    def __init__(
        self, in_features: int, features: int, use_bias: bool = True,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None, sharded_input: bool = False,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        glorot_uniform_(self.weight, in_features, features, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self._init_u(features, generator)
        self.sharded_input = sharded_input
        self.group = None

    def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
        dt = self.dtype
        w = self.normalized_weight(update_sn).to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        return dense(x.to(dt), w, b, self.group if self.sharded_input else None)
