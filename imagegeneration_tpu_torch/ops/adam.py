"""Keras-form Adam apply, one kernel launch per float32 leaf, in place.

Replaces the TPU kernel of imagegeneration_tpu/ops/pallas/adam.py
(`_kernel` behind `fused_adam_leaf`):

    m' = b1*m + (1-b1)*g
    v' = b2*v + (1-b2)*g*g
    p' = p + (-alpha*m') / (sqrt(v') + eps),   alpha = lr*sqrt(1-b2^t)/(1-b1^t)

eps sits outside the sqrt and the bias correction rides in alpha, as in
tf.keras (imagegeneration_tpu/train/common.py). alpha is computed in float32
on the device from the device step counter and read by the kernel from
device memory, so an apply never syncs the host.

On the H100 the apply is bound by device-memory bandwidth: 28 bytes per
element (read p, g, m, v; write p, m, v). The kernel (`csrc/adam.cu`) makes
that one pass and updates p, m and v in place, so the optimizer holds one
copy of its state. Unlike the TPU kernel, every leaf takes it: the TPU's
lane rule (>= 1M elements, size % 1024) does not apply on the GPU.

The kernel rounds every operation explicitly (no FMA contraction), so it
evaluates the same float32 expressions as `adam_leaf_plain`, which a CPU
tensor takes. A CUDA tensor launches the kernel or raises. `LAUNCHES`
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from imagegeneration_tpu_torch.ops import native

KERAS_EPS = 1e-7

LAUNCHES = {"adam": 0}


def adam_alpha(count: torch.Tensor, lr: float, b1: float, b2: float) -> torch.Tensor:
    """lr * sqrt(1 - b2^t) / (1 - b1^t) as a float32 (1,) tensor on count's
    device (t = count, already incremented)."""
    t = count.to(torch.float32).reshape(1)
    return lr * torch.sqrt(1.0 - torch.pow(b2, t)) / (1.0 - torch.pow(b1, t))


def adam_leaf_plain(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
    alpha: torch.Tensor, b1: float, b2: float, eps: float = KERAS_EPS,
) -> None:
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * (g * g)
    # float32 sqrt correctly rounded, as __fsqrt_rn and XLA give it: the
    # vectorized CPU torch.sqrt can be off by an ulp; a float64 sqrt
    # rounded to float32 never is.
    sqrt_v = torch.sqrt(v_new.double()).float()
    p_new = p + (-alpha * m_new) / (sqrt_v + eps)
    m.copy_(m_new)
    v.copy_(v_new)
    p.copy_(p_new)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, its entry point typed once per process."""
    lib = native.load("adam")
    lib.adam_f32.restype = ctypes.c_int
    lib.adam_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [
        ctypes.c_float] * 5 + [ctypes.c_void_p]
    return lib


def adam_leaf_kernel(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
    alpha: torch.Tensor, b1: float, b2: float, eps: float = KERAS_EPS,
) -> None:
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v), ("alpha", alpha)):
        if t.device != p.device or t.device.type != "cuda":
            raise ValueError(f"adam kernel: {name} must be on the CUDA device of p")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"adam kernel: {name} must be contiguous float32")
        if name != "alpha" and t.shape != p.shape:
            raise ValueError(f"adam kernel: {name} shape {tuple(t.shape)} != {tuple(p.shape)}")
    if alpha.numel() != 1:
        raise ValueError("adam kernel: alpha must hold one element")
    lib = _lib()
    rc = lib.adam_f32(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), alpha.data_ptr(),
        p.numel(), b1, b2, 1.0 - b1, 1.0 - b2, eps,
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    native.check(lib, "adam_error_string", rc, "adam apply")
    LAUNCHES["adam"] += 1


@torch.no_grad()
def adam_apply(
    params: Sequence[torch.Tensor],
    grads: Sequence[torch.Tensor],
    m: Sequence[torch.Tensor],
    v: Sequence[torch.Tensor],
    count: torch.Tensor,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
) -> None:
    """One Keras-form Adam step over lists of float32 leaves, in place.

    `count` (0-d integer tensor on the leaves' device) is incremented first,
    as optax's safe_increment does, and alpha is derived from it."""
    if not (len(params) == len(grads) == len(m) == len(v)):
        raise ValueError("params, grads, m and v must have equal length")
    count.add_(1)
    alpha = adam_alpha(count, lr, b1, b2)
    for p, g, mi, vi in zip(params, grads, m, v):
        # cuDNN hands back a conv weight's gradient in channels_last when
        # the activations are; the kernel walks p, g, m, v in one memory
        # order, so g is brought to p's (contiguous) layout.
        g = g.contiguous()
        if p.device.type == "cpu":
            adam_leaf_plain(p, g, mi, vi, alpha, b1, b2)
        else:
            adam_leaf_kernel(p, g, mi, vi, alpha, b1, b2)
