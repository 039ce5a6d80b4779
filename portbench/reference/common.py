"""Plain PyTorch pieces shared by the reference training steps.

Everything here is float32 arithmetic in stock PyTorch operations, written
from the published definitions: TF-style SAME padding, the transposed conv
of `lax.conv_transpose` (flax), Keras BatchNorm in training mode (epsilon
1e-3), tfa InstanceNormalization (epsilon 1e-3), spectral normalization
with one power-iteration step (Miyato et al. 2018, Algorithm 1), the GAN
losses and tf.keras's Adam (epsilon 1e-7 outside the square root, the bias
correction folded into the step size).

`Precision` is how the same reference also serves as the control of the
comparison: "f32" is the reference; "fp8" stores the operands and outputs
of every product and every activation the bfloat16 program holds in
bfloat16, and their gradients, in float8 e4m3 with one scale per tensor
(the precision below bfloat16); "tf32" lets cuDNN and cuBLAS run float32
products in TF32 (the precision below float32 with TF32 off).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8 e4m3fn
PRECISIONS = ("f32", "fp8", "tf32")


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale for the tensor (its largest
    magnitude at the format's largest finite value)."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _RoundFp8(torch.autograd.Function):
    """float8 storage of a tensor and of its gradient."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


class Precision:
    def __init__(self, name: str = "f32") -> None:
        if name not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {name!r}")
        self.name = name

    def round(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor as the precision stores it, forward and backward: where
        a bfloat16 program holds a bfloat16 activation or gradient, the
        "fp8" control holds a float8 one."""
        return _RoundFp8.apply(t) if self.name == "fp8" else t

    @contextlib.contextmanager
    def numerics(self):
        """TF32 on for "tf32", off otherwise, restored on exit."""
        saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        on = self.name == "tf32"
        torch.backends.cudnn.allow_tf32 = on
        torch.backends.cuda.matmul.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TF SAME padding of one dimension: the odd pixel goes low-side last."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x, w, b, stride: int, padding: str, prec: Precision):
    """2-D correlation of NCHW x with OIHW w, SAME (TF) or VALID."""
    if padding == "SAME":
        hl, hh = same_pads(x.shape[2], w.shape[2], stride)
        wl, wh = same_pads(x.shape[3], w.shape[3], stride)
        x = F.pad(x, (wl, wh, hl, hh))
    return F.conv2d(prec.round(x), prec.round(w), b, stride)


def conv_transpose_same(x, w, b, stride: int, prec: Precision):
    """lax.conv_transpose with SAME padding (flax ConvTranspose, no kernel
    transpose), w as (in, out, kh, kw): the stride-dilated input padded by
    (lo, hi), lo = k - 1 if s > k - 1 else ceil((k + s - 2) / 2), correlated
    with the kernel; out = in * stride. conv_transpose2d gives the fully
    padded result ((k - 1, k - 1)), which is cut to the rows and columns
    from k - 1 - lo on."""
    k = w.shape[2]
    lo = k - 1 if stride > k - 1 else math.ceil((k + stride - 2) / 2)
    full = F.conv_transpose2d(prec.round(x), prec.round(w), b, stride)
    start = k - 1 - lo
    h, wd = x.shape[2] * stride, x.shape[3] * stride
    return full[:, :, start:start + h, start:start + wd]


def reflect_pad(x, pad: int):
    """REFLECT padding of H and W by `pad`: the rows and columns next to
    each edge, mirrored about it (the edge itself not repeated). Written as
    slices, whose backward adds in a fixed order, where F.pad's reflect
    mode accumulates its backward with atomics on a CUDA card."""
    for dim in (2, 3):
        n = x.shape[dim]
        x = torch.cat([x.narrow(dim, 1, pad).flip(dim), x,
                       x.narrow(dim, n - 1 - pad, pad).flip(dim)], dim)
    return x


def linear(x, w, b, prec: Precision):
    return F.linear(prec.round(x), prec.round(w), b)


def batch_norm_train(x, scale, bias, eps: float = 1e-3):
    """Keras BatchNorm in training mode: statistics over every axis but 1,
    the biased variance."""
    dims = [d for d in range(x.dim()) if d != 1]
    var, mean = torch.var_mean(x, dim=dims, unbiased=False, keepdim=True)
    shape = [1, -1] + [1] * (x.dim() - 2)
    return (x - mean) * torch.rsqrt(var + eps) * scale.view(shape) + bias.view(shape)


def instance_norm(x, scale, bias, eps: float = 1e-3):
    """tfa InstanceNormalization over (H, W) of each sample and channel."""
    var, mean = torch.var_mean(x, dim=(2, 3), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)


def l2_normalize(v):
    return v / torch.sqrt(torch.sum(v * v) + 1e-12)


def spectral_normalize(w, u):
    """(w / sigma, u'): one power-iteration step on W, w viewed as (out,
    rest); sigma and u' are constants to autodiff."""
    with torch.no_grad():
        mat = w.detach().reshape(w.shape[0], -1)
        v = l2_normalize(mat.t() @ u)
        wv = mat @ v
        new_u = l2_normalize(wv)
        sigma = new_u @ wv
    return w / sigma, new_u


def hinge_d_real(logits):
    return torch.mean(torch.relu(1.0 - logits))


def hinge_d_fake(logits):
    return torch.mean(torch.relu(1.0 + logits))


def hinge_g(logits):
    return -torch.mean(logits)


def bce_logits(logits, label: float):
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, label))


def l1(a, b):
    return torch.mean(torch.abs(a - b))


def to_unit(u8):
    """uint8 NHWC images to float32 NCHW in [-1, 1]."""
    return (u8.float() / 127.5 - 1.0).permute(0, 3, 1, 2)


class Adam:
    """tf.keras Adam over a dict of float32 leaves, updated in place:
    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2;
    p -= lr sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps)."""

    def __init__(self, params: dict, lr: float, b1: float, b2: float = 0.999,
                 eps: float = 1e-7) -> None:
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def apply(self, params: dict, grads: dict) -> None:
        self.t += 1
        alpha = self.lr * math.sqrt(1.0 - self.b2 ** self.t) / (1.0 - self.b1 ** self.t)
        for k, g in grads.items():
            m, v = self.m[k], self.v[k]
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            params[k].sub_(alpha * m / (torch.sqrt(v) + self.eps))


def grads_of(loss, params: dict, names, retain: bool = False) -> dict:
    names = list(names)
    gs = torch.autograd.grad(loss, [params[k] for k in names], retain_graph=retain)
    return dict(zip(names, gs))
