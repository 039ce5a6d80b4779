"""Layers with the numerics of the Keras/flax layers of the JAX package.

Counterparts of imagegeneration_tpu/nn/layers.py (`Dense`, `Conv`,
`ConvTranspose`, `BatchNorm`, `reflection_pad_2d`, `InstanceNorm`,
`ResBlock`). Stock PyTorch differs from Keras in ways that change numbers,
so each default is pinned here:

- kernel init is Keras `glorot_uniform`, bias zeros; a conv or transposed
  conv can take Keras `RandomNormal(stddev=0.02)` instead (WGAN);
- SAME padding is TF's: total = max((ceil(n/s)-1)*s + k - n, 0), with the
  odd pixel on the bottom/right. For an even kernel at an odd extent that is
  asymmetric, which `Conv2d(padding=...)` cannot express, so it goes through
  an explicit `F.pad`;
- a SAME transposed conv has out = in * stride, with the padding rule of
  lax.conv_transpose (flax, `transpose_kernel=False`). Where that rule pads
  the low side more than the high side (3x3 at stride 2: (2, 1)), the conv
  is computed with (2, 2) and the extra high-side row and column cropped;
- BatchNorm is Keras's: momentum 0.99, epsilon 1e-3, statistics in at
  least float32 (flax: the input's dtype promoted with float32), and the
  running variance is updated with the BIASED batch variance (flax),
  where `nn.BatchNorm2d` would use the unbiased one;
- InstanceNorm is tfa's (epsilon 1e-3, Keras `random_uniform` U(-0.05,
  0.05) scale and offset); its corrected per-channel form runs through the
  InstanceNorm kernel (ops/instance_norm.py).

Parameters are float32; `dtype` is the compute dtype (bfloat16 on the main
path). Image tensors are NCHW logical and channels_last in memory, so that
their memory order is the JAX package's NHWC; 4-D conv weights are
channels_last too (`conv_weight`).

Under a (data, spatial) mesh (`partition` sets a core.mesh.DataGroup on
every layer of a model) an image tensor is this rank's block of rows of
the whole map (parallel/dp.py):

- a SAME conv takes the global SAME pads, split at the shard's edges: the
  top `lo` and bottom `hi` rows of same_pads(H, k, s) come from the spatial
  neighbours (parallel/halo.py), zeros at the global edges; a stride keeps
  its phase because every shard's height is a multiple of it (the guard,
  core/mesh.check_spatial_partition, keeps >= 2 rows at the deepest map);
- a transposed conv exchanges the input rows its outputs read across the
  edge (`conv_transpose_halo`), runs on the padded block and keeps the
  rows of its own output block;
- BatchNorm over an image map sums its statistics over the world (N, H
  and W are all split); over a (B, features) input, which spatial peers
  hold whole, over the data group only;
- a Dense layer built with `sharded_input=True` (a head over the NHWC
  flatten of an H-partitioned map) multiplies this rank's block of the
  input features by its block of the weight's columns and sums the
  partial products over the spatial peers (`dp.spatial_sum`), with the
  bias added once, on spatial rank 0;
- InstanceNorm takes the whole map's statistics through the split kernels
  (ops/instance_norm.py: partial sums, one all_gather, apply; backward
  likewise around one all_reduce); its `quirk_axis1` form normalizes each
  row alone, so it needs no collective and takes the rank's rows of its
  per-row parameters;
- a reflect pad (`reflection_pad_2d` with a group) takes its inner edge
  rows from the neighbours (`reflect_halo`) and reflects only at the
  global top and bottom; a VALID conv built with `halo_fed=True` then
  tiles the padded block; every other VALID conv refuses a partition;
- a module with `runs_whole = True` (the PatchGAN) gathers its input's
  rows itself and runs whole on every spatial peer: `partition` leaves
  its layers without a group.

Not ported: the phase/hybrid/packed/swapdw ConvTranspose lowerings of the
JAX package, which work around TPU XLA; cuDNN lowers the transposed conv
(the swapdw lowering's forward is lax.conv_transpose, which this matches).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from imagegeneration_tpu_torch.core.mesh import spatial_row_range
from imagegeneration_tpu_torch.ops.batch_norm import batch_norm
from imagegeneration_tpu_torch.ops.instance_norm import instance_norm
from imagegeneration_tpu_torch.parallel import dp
from imagegeneration_tpu_torch.parallel.halo import halo


def glorot_uniform_(
    t: torch.Tensor, fan_in: int, fan_out: int, generator: torch.Generator | None
) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-limit, limit, generator=generator)


KERNEL_INITS = ("glorot_uniform", "normal_002", "lecun_normal")
# flax's lecun_normal: a normal truncated to +-2 std, scaled so that its
# std is sqrt(1 / fan_in) (the std of N(0, 1) truncated to +-2).
_TRUNCATED_STD = 0.87962566103423978


def conv_weight(
    shape: tuple[int, int, int, int], generator: torch.Generator | None,
    kernel_init: str = "glorot_uniform",
) -> nn.Parameter:
    """A conv (out, in, kh, kw) or ConvTranspose (in, out, kh, kw) weight,
    channels_last: glorot-uniform (its limit depends on fan_in + fan_out
    only), N(0, 0.02) for `kernel_init="normal_002"` (Keras
    RandomNormal(stddev=0.02)), or flax's lecun_normal (a conv's fan_in,
    kh * kw * in) for `"lecun_normal"`.

    The values are drawn in the contiguous order (the same weights for a
    seed as a contiguous tensor) and then laid out channels_last, the
    memory order of the activations: cuDNN takes the weight as it is and
    returns its gradient in the same layout, which the Adam kernel walks
    with the moments (ops/adam.py)."""
    a, b, kh, kw = shape
    if kernel_init == "glorot_uniform":
        w = glorot_uniform_(torch.empty(shape), kh * kw * b, kh * kw * a, generator)
    elif kernel_init == "normal_002":
        w = torch.empty(shape).normal_(0.0, 0.02, generator=generator)
    elif kernel_init == "lecun_normal":
        std = math.sqrt(1.0 / (kh * kw * b)) / _TRUNCATED_STD
        w = torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2.0 * std, 2.0 * std,
                                        generator=generator)
    else:
        raise ValueError(f"kernel_init must be one of {KERNEL_INITS}, got {kernel_init!r}")
    return nn.Parameter(w.contiguous(memory_format=torch.channels_last))


def keras_random_uniform_(
    t: torch.Tensor, generator: torch.Generator | None
) -> torch.Tensor:
    """Keras "random_uniform" initializer: U(-0.05, 0.05)."""
    with torch.no_grad():
        return t.uniform_(-0.05, 0.05, generator=generator)


def reflect_halo(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """This rank's (B, C, h, W) block of an H-partitioned map with `n` rows
    above and below as a REFLECT pad of the whole map has them: the
    neighbours' rows at inner edges (`halo`), the block's own rows n ... 1
    above the global top and h-2 ... h-1-n below the global bottom."""
    y = halo(x, n, n, group)
    top, bottom = group.s == 0, group.s == group.spatial - 1
    if not (top or bottom):
        return y
    h = x.shape[2]
    if n >= h:
        raise ValueError(f"a reflect pad of {n} rows needs more than {n} rows per shard")
    parts = [x[:, :, 1:n + 1].flip(2) if top else y[:, :, :n], y[:, :, n:n + h],
             x[:, :, h - 1 - n:h - 1].flip(2) if bottom else y[:, :, n + h:]]
    return torch.cat(parts, 2)


def _reflect(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """REFLECT-pad one dim by `pad` on each side: the mirrored rows (the edge
    row left out) as flipped slices, cat around x. Its backward adds each
    mirrored row's gradient to its source in a fixed order, where
    F.pad(mode="reflect")'s backward accumulates with atomics on the card
    and is not bit-stable from run to run."""
    if pad == 0:
        return x
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 1, pad).flip(dim), x,
                      x.narrow(dim, n - 1 - pad, pad).flip(dim)], dim)


def reflection_pad_2d(x: torch.Tensor, padding: tuple[int, int] = (1, 1),
                      group=None) -> torch.Tensor:
    """REFLECT-pad H and W of a (B, C, H, W) tensor; `padding` is (w, h), as
    in the JAX package. With a spatially partitioned `group`, x is this
    rank's block of rows and H is padded as the whole map (`reflect_halo`).
    The result is channels_last, like every activation."""
    w_pad, h_pad = padding
    if _spatial(group):
        x, h_pad = reflect_halo(x, h_pad, group), 0
    y = _reflect(_reflect(x, h_pad, 2), w_pad, 3)
    return y.contiguous(memory_format=torch.channels_last)


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TF-SAME (low, high) padding of one spatial dim."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _spatial(group) -> bool:
    return group is not None and group.sharded


def conv2d_same(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
    stride: tuple[int, int], padding: str, group=None,
) -> torch.Tensor:
    """conv2d with TF-SAME or VALID padding (w is OIHW). With a spatially
    partitioned `group`, x is this rank's block of rows and the H pads are
    the whole map's, filled from the neighbours."""
    if padding == "VALID":
        if _spatial(group):
            raise NotImplementedError("a VALID conv over an H-partitioned map is not ported")
        return F.conv2d(x, w, b, stride)
    if padding != "SAME":
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    (wl, wh) = same_pads(x.shape[3], w.shape[3], stride[1])
    if _spatial(group):
        h = x.shape[2]
        if h % stride[0]:
            raise ValueError(f"a shard of {h} rows breaks the stride-{stride[0]} phase")
        (hl, hh) = same_pads(h * group.spatial, w.shape[2], stride[0])
        x = halo(x, hl, hh, group)
        hl = hh = 0
    else:
        (hl, hh) = same_pads(x.shape[2], w.shape[2], stride[0])
    if hl == hh and wl == wh:
        return F.conv2d(x, w, b, stride, padding=(hl, wl))
    return F.conv2d(F.pad(x, (wl, wh, hl, hh)), w, b, stride)


def conv_transpose_same_pads(k: int, s: int) -> tuple[int, int]:
    """(low, high) padding lax.conv_transpose uses for SAME: pad_len =
    k + s - 2, low = k - 1 if s > k - 1 else ceil(pad_len / 2)."""
    pad_len = k + s - 2
    low = k - 1 if s > k - 1 else -(-pad_len // 2)
    return low, pad_len - low


def conv_transpose_halo(k: int, s: int) -> tuple[int, int]:
    """Input rows above and below a block that the block's SAME transposed
    conv outputs read: output row o reads the dilated input rows o - low
    ... o - low + k - 1, of which the multiples of s are input rows."""
    low, _ = conv_transpose_same_pads(k, s)
    return low // s, max(0, (k - 2 - low) // s + 1)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, group=None) -> torch.Tensor:
    """x @ w^T + b. With a spatially partitioned `group`, x is this rank's
    block of the input features (the NHWC flatten of its rows of a map):
    its block of w's columns, the partial products summed over the spatial
    peers, the bias added on spatial rank 0 only. The partial products and
    their sum are kept in at least float32 and rounded to x's dtype once,
    as the whole product accumulates in float32 and rounds once."""
    if not _spatial(group):
        return F.linear(x, w, b)
    n = x.shape[1]
    if n * group.spatial != w.shape[1]:
        raise ValueError(f"{n} input features x {group.spatial} shards != {w.shape[1]}")
    ct = torch.promote_types(x.dtype, torch.float32)
    if b is not None:  # times 0 elsewhere: every rank has a (zero) bias gradient to reduce
        b = b.to(ct) * float(group.s == 0)
    part = F.linear(x.to(ct), w[:, group.s * n:(group.s + 1) * n].to(ct), b)
    return dp.spatial_sum(part, group).to(x.dtype)


class Dense(nn.Module):
    """y = x @ W^T + b; weight (out, in). `sharded_input=True`: under a
    spatial partition, x is this rank's block of the features (`dense`)."""

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
        self.sharded_input = sharded_input
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return dense(x.to(dt), self.weight.to(dt), b,
                     self.group if self.sharded_input else None)


class Conv(nn.Module):
    """2D conv, TF-SAME/VALID padding; weight (out, in, kh, kw).

    `halo_fed=True` (a VALID conv only): under a spatial partition its
    input is the rank's block already padded with kh - 1 halo rows
    (`reflection_pad_2d` with a group), so the VALID conv tiles it: the
    block's own rows must keep the stride's phase."""

    def __init__(
        self, in_features: int, features: int, kernel_size: tuple[int, int],
        strides: tuple[int, int] = (1, 1), padding: str = "SAME",
        use_bias: bool = True, dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None, kernel_init: str = "glorot_uniform",
        halo_fed: bool = False,
    ) -> None:
        super().__init__()
        kh, kw = kernel_size
        if halo_fed and padding != "VALID":
            raise ValueError("halo_fed=True is for a VALID conv")
        self.strides = tuple(strides)
        self.padding = padding
        self.halo_fed = halo_fed
        self.dtype = dtype
        self.weight = conv_weight((features, in_features, kh, kw), generator, kernel_init)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        group = self.group
        if self.halo_fed and _spatial(group):
            own = x.shape[2] - (self.weight.shape[2] - 1)
            if own % self.strides[0]:
                raise ValueError(f"a shard of {own} rows breaks the stride-{self.strides[0]} "
                                 "phase")
            group = None  # the padded block is this rank's whole input
        return conv2d_same(x.to(dt), self.weight.to(dt), b, self.strides,
                           self.padding, group)


class ConvTranspose(nn.Module):
    """2D transposed conv with SAME padding (out = in * stride).

    weight is (in, out, kh, kw) in PyTorch's conv_transpose layout: the
    spatially flipped, in/out-swapped flax kernel (bridge.py converts)."""

    def __init__(
        self, in_features: int, features: int, kernel_size: tuple[int, int],
        strides: tuple[int, int] = (1, 1), use_bias: bool = True,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None, kernel_init: str = "glorot_uniform",
    ) -> None:
        super().__init__()
        kh, kw = kernel_size
        pads = [conv_transpose_same_pads(k, s) for k, s in zip(kernel_size, strides)]
        # lax pads the dilated input by (lo, hi); conv_transpose2d's
        # `padding` trims k-1-p from each side, `output_padding` adds extra
        # high-side rows/columns. Where hi < lo, the conv runs with (lo, lo)
        # and the output (in * stride) is cropped on the high side.
        self.tpad = tuple(k - 1 - lo for k, (lo, _) in zip(kernel_size, pads))
        self.out_pad = tuple(max(hi - lo, 0) for lo, hi in pads)
        self.crop = any(hi < lo for lo, hi in pads)
        self.strides = tuple(strides)
        self.halo_rows = conv_transpose_halo(kh, strides[0])
        self.dtype = dtype
        self.weight = conv_weight((in_features, features, kh, kw), generator, kernel_init)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        h, s = x.shape[2], self.strides[0]
        if _spatial(self.group):
            x = halo(x, *self.halo_rows, self.group)
        y = F.conv_transpose2d(
            x.to(dt), self.weight.to(dt), b, self.strides, self.tpad, self.out_pad
        )
        if self.crop:
            y = y[:, :, : x.shape[2] * s, : x.shape[3] * self.strides[1]]
        if _spatial(self.group):  # this rank's block of output rows
            y = y[:, :, self.halo_rows[0] * s:(self.halo_rows[0] + h) * s]
        return y


class BatchNorm(nn.Module):
    """Keras BatchNorm (momentum 0.99, eps 1e-3) over every axis but 1.

    Parameters `scale`, `bias`; running statistics `mean`, `var` (float32
    buffers). Statistics are computed in the input's dtype promoted with
    float32, as flax computes them: mean = E[x], var = max(E[x^2] - E[x]^2,
    0) (flax's fast variance); the running variance takes this biased var.

    Under data parallelism (`group` set by `partition`) the train-mode
    statistics are those of the GLOBAL batch, as the JAX step computes them
    over a mesh: one differentiable all-reduce sums the per-channel [sum x,
    sum x^2] over the ranks, and N counts every rank's elements (the ranks'
    shards are equal): over the world for an image map (split on N, and on
    H over the spatial peers), over the data group for a (B, features)
    input, which spatial peers hold whole. Its backward sums the cotangents
    over the same ranks; each rank's loss is the mean over its own rows and
    the gradients are then averaged (parallel/dp.py), which gives the
    global-batch gradient.

    The activation that follows the norm in a model is part of the call
    (`slope`), so that on the card the norm and the activation are one
    pass each way (ops/batch_norm.py); there the per-channel sums are
    all-reduced between the kernels' two passes."""

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
        self.group = None  # a core.mesh.DataGroup: global batch statistics

    def forward(self, x: torch.Tensor, use_running_average: bool,
                slope: float | None = None) -> torch.Tensor:
        """The norm, then the activation that follows it in the model
        (`slope`: None, 0.0 for ReLU, else LeakyReLU's negative slope):
        through the BatchNorm kernels for a CUDA tensor, the plain version
        for a CPU one (ops/batch_norm.py)."""
        return batch_norm(x, self.scale, self.bias, self.mean, self.var, use_running_average,
                          self.momentum, self.epsilon, self.dtype, slope, self.group)


def partition(module: nn.Module, group) -> None:
    """Set `group` (a core.mesh.DataGroup; None: this process's whole batch
    and maps) on every layer of `module` that takes one: BatchNorms take
    global statistics, and under a spatial partition the convs exchange
    halos, the sharded-input Dense heads sum over the spatial peers, the
    InstanceNorms reduce over them and the models cut their maps to the
    rank's rows. Inside a module with `runs_whole = True`, which gathers
    its input's rows itself, the layers get None."""
    if hasattr(module, "group"):
        module.group = group
    inner = None if getattr(module, "runs_whole", False) else group
    for child in module.children():
        partition(child, inner)


class InstanceNorm(nn.Module):
    """tfa InstanceNormalization (its default epsilon, 1e-3) with scale and
    offset.

    Default: per-(sample, channel) statistics over (H, W), through the
    InstanceNorm kernel; parameters `scale`, `bias` of shape (C,).
    `quirk_axis1=True` reproduces the reference's `axis=1` on NHWC, which
    treats H as the channel axis: each H-slice is normalized over (W, C),
    with per-H parameters of shape (H, 1, 1) (the flax shape), in plain
    torch. That form needs the input height at construction.

    Under a spatial partition (`group`) the statistics are the whole map's
    (the split kernels); the quirk form takes the rank's rows of its per-H
    parameters."""

    def __init__(
        self, features: int, quirk_axis1: bool = False, height: int | None = None,
        dtype: torch.dtype | None = None, generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        if quirk_axis1 and height is None:
            raise ValueError("InstanceNorm(quirk_axis1=True) needs the input height")
        self.quirk_axis1 = quirk_axis1
        self.epsilon = 1e-3
        self.dtype = dtype
        shape = (height, 1, 1) if quirk_axis1 else (features,)
        self.scale = nn.Parameter(keras_random_uniform_(torch.empty(shape), generator))
        self.bias = nn.Parameter(keras_random_uniform_(torch.empty(shape), generator))
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = self.dtype or x.dtype
        if not self.quirk_axis1:
            return instance_norm(x, self.scale, self.bias, self.epsilon,
                                 group=self.group).to(out_dtype)
        ct = torch.promote_types(x.dtype, torch.float32)
        x32 = x.to(ct)
        dims = (1, 3)  # (C, W) of NCHW: the (W, C) of the JAX NHWC axes
        mean = x32.mean(dims, keepdim=True)
        var = torch.square(x32 - mean).mean(dims, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.epsilon)
        rows = slice(*spatial_row_range(self.group, self.scale.shape[0]))
        scale, bias = self.scale[rows].to(ct), self.bias[rows].to(ct)
        y = y * scale.view(1, 1, -1, 1) + bias.view(1, 1, -1, 1)
        return y.to(out_dtype)


class ResBlock(nn.Module):
    """CycleGAN residual block with the reference's op order:
    conv3x3 -> IN -> ReLU -> conv3x3 -> add(residual) -> ReLU -> IN
    (the post-add norm, and no norm on the second conv before the add)."""

    def __init__(
        self, features: int, quirk_axis1: bool = False, height: int | None = None,
        dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.conv1 = Conv(features, features, (3, 3), dtype=dtype, generator=generator)
        self.in1 = InstanceNorm(features, quirk_axis1, height, dtype=dtype,
                                generator=generator)
        self.conv2 = Conv(features, features, (3, 3), dtype=dtype, generator=generator)
        self.in2 = InstanceNorm(features, quirk_axis1, height, dtype=dtype,
                                generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fx = torch.relu(self.in1(self.conv1(x)))
        fx = self.conv2(fx)
        return self.in2(torch.relu(x + fx))
