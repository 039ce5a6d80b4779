"""Instance normalization (+ optional ReLU) with a single-kernel backward.

Replaces the TPU kernel pair of imagegeneration_tpu/ops/pallas/instance_norm.py
(`_in_fwd_kernel`, `_in_bwd_kernel` behind `instance_norm`). Statistics are
per (sample, channel) over (H, W), in float32 for float32 and bfloat16
inputs:

    forward:  mean, var = E[x], E[(x - mean)^2];  rstd = rsqrt(var + eps)
              y = (x - mean) * rstd * gamma + beta   (+ ReLU)
    backward: xhat rebuilt from the saved (mean, rstd); the ReLU mask from
              xhat * gamma + beta > 0; with g = dy * gamma:
              dbeta = sum dy, dgamma = sum dy * xhat,
              dx = rstd * (g - mean(g) - xhat * mean(g * xhat))

The forward output `y` is not saved for the backward, as in the JAX rule
(`_fwd_rule`): the saved tensors are x, gamma, beta, mean and rstd.

Tensors are NCHW logical and channels_last in memory (the JAX package's
NHWC order), which is the order the kernels walk; `instance_norm` brings
its input, and the backward its incoming gradient, to channels_last (a
no-op when the layout already matches: the math does not depend on it).

On the H100 both passes are bound by device-memory bandwidth (forward: read
x, write y; backward: read x and dy, write dx). The kernels
(`csrc/instance_norm.cu`) run one CTA per (sample, 32-channel block); the
per-sample dgamma/dbeta partials they emit are summed over the batch here by
one `torch.sum`, as the JAX package sums them in XLA.

A CPU tensor takes the plain versions below, which mirror `_in_fwd_xla` and
`_in_bwd_xla` expression by expression; a CUDA tensor launches the kernels
or raises. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from imagegeneration_tpu_torch.ops import native

LAUNCHES = {"instance_norm_fwd": 0, "instance_norm_bwd": 0}

_SPATIAL = (2, 3)


def _per_channel(t: torch.Tensor) -> torch.Tensor:
    """(B, C) or (C,) statistics/parameters broadcast over (B, C, H, W)."""
    return t[..., None, None]


# ------------------------------------------------------------ plain version
def in_fwd_plain(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float, relu: bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, rstd): y in x's dtype, mean and rstd (B, C) in float32."""
    ct = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(ct)
    mean = x32.mean(_SPATIAL)
    centered = x32 - _per_channel(mean)
    var = (centered * centered).mean(_SPATIAL)  # jnp.var: two-pass
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - _per_channel(mean)) * _per_channel(rstd)
    y = xhat * _per_channel(gamma.to(ct)) + _per_channel(beta.to(ct))
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype), mean, rstd


def in_bwd_plain(
    x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    mean: torch.Tensor, rstd: torch.Tensor, relu: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dgamma, dbeta): dx in x's dtype (the cast of the JAX `_in_bwd`),
    dgamma and dbeta (C,) in float32."""
    ct = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(ct)
    dy = dy.to(ct)
    xhat = (x32 - _per_channel(mean)) * _per_channel(rstd)
    if relu:
        pre = xhat * _per_channel(gamma.to(ct)) + _per_channel(beta.to(ct))
        dy = dy * (pre > 0)
    dbeta = dy.sum((0, 2, 3))
    dgamma = (dy * xhat).sum((0, 2, 3))
    g = dy * _per_channel(gamma.to(torch.float32))
    mean_g = g.mean(_SPATIAL, keepdim=True)
    mean_gx = (g * xhat).mean(_SPATIAL, keepdim=True)
    dx = _per_channel(rstd) * (g - mean_g - xhat * mean_gx)
    return dx.to(x.dtype), dgamma, dbeta


# ------------------------------------------------------------------- kernel
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_SIZES = [ctypes.c_int] * 3  # B, H*W, C


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, its entry points typed once per process."""
    lib = native.load("instance_norm")
    for suffix in _DTYPES.values():
        fwd = getattr(lib, f"in_fwd_{suffix}")
        fwd.restype = ctypes.c_int
        fwd.argtypes = [ctypes.c_void_p] * 6 + _SIZES + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        bwd = getattr(lib, f"in_bwd_{suffix}")
        bwd.restype = ctypes.c_int
        bwd.argtypes = [ctypes.c_void_p] * 9 + _SIZES + [ctypes.c_int, ctypes.c_void_p]
    return lib


def _check_activation(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"instance_norm kernel: {name} must be a CUDA tensor, got {t.device}")
    if t.dim() != 4 or not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(
            f"instance_norm kernel: {name} must be a 4-D channels_last-contiguous "
            f"tensor; got shape {tuple(t.shape)} strides {t.stride()}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"instance_norm kernel takes float32 or bfloat16, got {t.dtype}")
    if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"instance_norm kernel: {name} must match x in shape, dtype, device")
    if t.numel() >= 2**31:
        raise ValueError("instance_norm kernel: the int sizes cover < 2**31 elements")


def _check_vector(name: str, t: torch.Tensor, x: torch.Tensor, shape: tuple) -> None:
    if (t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous()
            or tuple(t.shape) != shape):
        raise ValueError(
            f"instance_norm kernel: {name} must be a contiguous float32 {shape} tensor "
            f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def in_fwd_kernel(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float, relu: bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_activation("x", x, x)
    b, c, h, w = x.shape
    _check_vector("gamma", gamma, x, (c,))
    _check_vector("beta", beta, x, (c,))
    lib = _lib()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    rc = getattr(lib, f"in_fwd_{_DTYPES[x.dtype]}")(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), b, h * w, c, eps, int(relu),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    native.check(lib, "in_error_string", rc, "instance_norm forward")
    LAUNCHES["instance_norm_fwd"] += 1
    return y, mean, rstd


def in_bwd_kernel(
    x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    mean: torch.Tensor, rstd: torch.Tensor, relu: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_activation("x", x, x)
    _check_activation("dy", dy, x)
    b, c, h, w = x.shape
    _check_vector("gamma", gamma, x, (c,))
    _check_vector("beta", beta, x, (c,))
    _check_vector("mean", mean, x, (b, c))
    _check_vector("rstd", rstd, x, (b, c))
    lib = _lib()
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dgamma_part = torch.empty((b, c), dtype=torch.float32, device=x.device)
    dbeta_part = torch.empty_like(dgamma_part)
    rc = getattr(lib, f"in_bwd_{_DTYPES[x.dtype]}")(
        x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), dgamma_part.data_ptr(),
        dbeta_part.data_ptr(), b, h * w, c, int(relu),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    native.check(lib, "in_error_string", rc, "instance_norm backward")
    LAUNCHES["instance_norm_bwd"] += 1
    return dx, dgamma_part.sum(0), dbeta_part.sum(0)


# ------------------------------------------------------------------ wrapper
def in_fwd(x, gamma, beta, eps: float, relu: bool):
    """Forward: the plain version for a CPU tensor, else the kernel."""
    if x.device.type == "cpu":
        return in_fwd_plain(x, gamma, beta, eps, relu)
    return in_fwd_kernel(x, gamma, beta, eps, relu)


def in_bwd(x, dy, gamma, beta, mean, rstd, relu: bool):
    """Backward: the plain version for a CPU tensor, else the kernel."""
    if x.device.type == "cpu":
        return in_bwd_plain(x, dy, gamma, beta, mean, rstd, relu)
    return in_bwd_kernel(x, dy, gamma, beta, mean, rstd, relu)


class _InstanceNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, relu):
        y, mean, rstd = in_fwd(x, gamma, beta, eps, relu)
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        dy = dy.contiguous(memory_format=torch.channels_last)
        dx, dgamma, dbeta = in_bwd(x, dy, gamma, beta, mean, rstd, ctx.relu)
        return dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), None, None


def instance_norm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    eps: float = 1e-3, relu: bool = False,
) -> torch.Tensor:
    """Per-(sample, channel) instance norm over (H, W) with affine (+ReLU).

    x: (B, C, H, W), float32 or bfloat16 (any layout; computed in
    channels_last). gamma, beta: (C,) float32. Returns y in x's dtype,
    channels_last."""
    x = x.contiguous(memory_format=torch.channels_last)
    return _InstanceNorm.apply(x, gamma, beta, eps, relu)
