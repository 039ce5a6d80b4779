"""BatchNorm and the activation that follows it, fused: one statistics pass
and one apply pass each way (`csrc/batch_norm.cu`).

Replaces no TPU kernel: the JAX package leaves flax's BatchNorm and the
ReLU / LeakyReLU after it to XLA, which fuses them. In eager PyTorch the
same arithmetic is ~30 float32 ops forward and ~40 backward a site (the
float32 upcast, the broadcast sub/mul/add, the cast back, the
activation), which moved ~200 bytes an element where the work needs 10
in bfloat16 (PERF.md §6).

The arithmetic is the layer's (nn/layers.BatchNorm): statistics over every
axis but 1 in float32 (the input's dtype promoted with float32), flax's
fast variance, the Keras running statistics with the BIASED variance:

    train:     mean = E[x], var = max(E[x^2] - E[x]^2, 0), from sum x and
               sum x^2 per channel (over the group's global batch)
               running <- momentum * running + (1 - momentum) * batch value
    inference: mean, var = the running statistics
    both:      rstd = rsqrt(var + eps), mul = rstd * scale
               t = round((x - mean) * mul + bias) to the compute dtype
               y = t, relu(t) (slope 0.0) or leaky_relu(t, slope)
    backward:  g = dy through the activation's mask (t > 0; below it 0, or
               dy * slope rounded to the compute dtype, as the plain
               activation's backward gives it); xhat = (x - mean) * rstd
               dbias = sum g, dscale = sum g * xhat (this rank's)
               train:     dx = mul * (g - sum g / N - xhat * sum g xhat / N)
               inference: dx = mul * g

A CPU tensor takes the plain version (`bn_plain`): the layer's arithmetic
expression for expression, through autograd, so that every parity test
against the JAX package sees the numbers it saw before the kernels. A
CUDA tensor launches the kernels or raises. `LAUNCHES` counts the
launches of each kernel.

The kernels see a (rows, C) row-major matrix: a (B, features) input as it
is (the SNDCGAN stem: 128 rows of 294,912 channels), a 4-D map in
channels_last memory as its N*H*W rows of C channels (C 64-256, up to
4.7M rows). `launch_plan` picks one grid for the four kernels from the
shape; they only check it.

Under a `group` (core.mesh.DataGroup: data parallelism, spatial
partitioning), the train-mode statistics are the global batch's, as the
plain version's: the per-channel [sum x, sum x^2] of the statistics pass
are summed over the ranks (`dp.all_reduce_sum`: the world for a map, the
data group for a (B, features) input, which spatial peers hold whole)
before the apply, N counts every rank's elements; the backward's [sum g,
sum g xhat] likewise before its apply. dscale and dbias stay this rank's
sums, which the step then averages with the other gradients.

Saved for the backward: x in the compute dtype and the per-channel float32
mean and rstd; not y, not a float32 copy of x. The train form's backward
is differentiable once. The inference form's is differentiable again (the
WGAN-GP penalty's second derivative through an inference-mode critic),
with the activation's mask m held constant, as autograd holds ReLU's:
dx = mul * m * dy is linear in dy and in scale, so its backward is the
same two kernels,

    d/d dy    = mul * m * ddx              (the apply back on ddx)
    d/d scale = rstd * sum m * dy * ddx    (the reduce's sum g of dy * ddx)

and nothing reaches x or bias. A penalty that reads dscale or dbias (no
caller's does), and a third derivative, raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from imagegeneration_tpu_torch.ops import native
from imagegeneration_tpu_torch.ops.native import H100_SXM_SMS, sm_count
from imagegeneration_tpu_torch.parallel import dp

LAUNCHES = {"batch_norm_fwd_stats": 0, "batch_norm_fwd_apply": 0,
            "batch_norm_bwd_reduce": 0, "batch_norm_bwd_apply": 0}


def _over(x: torch.Tensor) -> str:
    """The ranks a map's statistics span (N, H and W are split) or a
    (B, features) input's (spatial peers hold it whole)."""
    return "world" if x.dim() > 2 else "data"


# ------------------------------------------------------------ plain version
def moments_plain(xf: torch.Tensor, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(E[x], E[x^2]) per channel over this rank's batch, or over the
    group's global batch."""
    dims = [d for d in range(xf.dim()) if d != 1]
    if group is None:
        return xf.mean(dims), (xf * xf).mean(dims)
    over = _over(xf)
    sums = dp.all_reduce_sum(torch.stack([xf.sum(dims), (xf * xf).sum(dims)]), group, over)
    n = xf.numel() // xf.shape[1] * group.size_of(over)
    return sums[0] / n, sums[1] / n


def activation_plain(y: torch.Tensor, slope: float | None) -> torch.Tensor:
    """The activation after the norm: none, ReLU (slope 0.0) or LeakyReLU."""
    if slope is None:
        return y
    if slope == 0.0:
        return torch.relu(y)
    return F.leaky_relu(y, slope)


def bn_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
    running_var: torch.Tensor, use_running_average: bool, momentum: float, eps: float,
    dtype: torch.dtype | None, slope: float | None, group=None,
) -> torch.Tensor:
    """The layer's forward in torch ops (autograd gives the backward); the
    running statistics are updated in place in train mode."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct)
    shape = [1, -1] + [1] * (x.dim() - 2)
    if use_running_average:
        mean, var = running_mean, running_var
    else:
        mean, mean2 = moments_plain(xf, group)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean + (1.0 - momentum) * mean)
            running_var.copy_(momentum * running_var + (1.0 - momentum) * var)
    mul = torch.rsqrt(var + eps) * scale
    y = (xf - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    return activation_plain(y.to(dtype or ct), slope)


# -------------------------------------------------------------- launch plan
THREADS = 256  # a CTA's threads (kThreads in the source)
UNROLL = 8  # 16-byte loads a thread has in flight (kUnroll in the source)
MAX_BLOCK_BYTES = 256  # a CTA's row segment: up to two 128-byte lines of channels
THREAD_ROWS = 32  # rows a thread should walk before a block widens
CTAS_PER_SM = 2  # the grid's target: sms * CTAS_PER_SM CTAs
MAX_BLOCKS = 65535  # a grid's y extent
VECTOR_BYTES = 16
_ELEMENT_SIZE = {torch.float32: 4, torch.bfloat16: 2}


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the four kernels cover a (rows, C) matrix: a grid of (`chunks`,
    `blocks`) CTAs of THREADS threads. A CTA takes a block of `cb` = `lanes`
    x `vec` channels and a chunk of `chunk_rows` consecutive rows; its
    threads are `lanes` vector lanes (a thread moves `vec` channels per
    load: 16 bytes, or 1 channel on the scalar path) by `slots` = THREADS /
    `lanes` row slots, a thread taking rows slot, slot + slots, ... of the
    chunk, with UNROLL 16-byte loads in flight (that many rows of x in the
    statistics pass and the forward apply, half as many rows of x and of
    dy in the backward's passes). The statistics and reduce passes write
    one partial row per chunk, (chunks, 2, C) float32, and the last CTA of
    each channel block to take its ticket (`blocks` tickets) adds them in
    chunk order; with one chunk the CTA writes the sums itself."""

    rows: int
    c: int
    vec: int
    lanes: int
    slots: int
    cb: int
    blocks: int
    chunks: int
    chunk_rows: int

    @property
    def ctas(self) -> int:
        return self.chunks * self.blocks

    @property
    def tickets(self) -> int:
        """Ticket counters the statistics and reduce passes take: one per
        channel block, none with one chunk."""
        return self.blocks if self.chunks > 1 else 0

    @property
    def partial_floats(self) -> int:
        """float32 scratch of those passes: a [sum, sum] row per chunk."""
        return self.chunks * 2 * self.c if self.chunks > 1 else 0

    def args(self) -> list[int]:
        """The entry points' plan arguments: rows, C, vec, lanes, chunks,
        chunk rows."""
        return [self.rows, self.c, self.vec, self.lanes, self.chunks, self.chunk_rows]


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def launch_plan(rows: int, c: int, dtype: torch.dtype, *,
                sms: int = H100_SXM_SMS) -> LaunchPlan:
    """The launch of all four kernels over a (rows, C) matrix of `dtype`, on
    a card of `sms` SMs.

    - vec: 16 bytes of channels when C is a multiple of them (every site of
      the SNDCGAN and WGAN models), else 1.
    - lanes: the fewest vector lanes that cover C, up to two 128-byte
      lines of channels (128 bfloat16 or 64 float32 on the vector path, 32
      on the scalar one): a warp's loads then cover whole lines of whole
      rows, and a narrow map (C 64-256, millions of rows) has one or two
      channel blocks and its rows cut into chunks (on the H100, one line
      took 0.519 and 1.004 ms for the four kernels at the 256- and
      128-channel sites, two 0.486 and 0.921); then doubled while a thread
      would walk fewer than THREAD_ROWS rows and the block is narrower than
      C and THREADS lanes, so that a wide C of few rows (the stem's 294,912
      channels of 128 rows: 64 lanes, 4 row slots, 32 rows a thread) spends
      each thread's per-channel set-up on a longer row loop (on the H100,
      tools/bn_times.py --sweep: 0.334 ms for the stem's four kernels at 64
      lanes, 0.527 at 8).
    - chunks: as many as make the grid sms * CTAS_PER_SM CTAs, while each
      thread keeps at least UNROLL rows; chunk_rows a whole number of row
      slots; the chunks then cover the rows with none empty.

    Refused: an empty matrix, a dtype the kernels do not take, more than
    MAX_BLOCKS channel blocks."""
    if dtype not in _ELEMENT_SIZE:
        raise TypeError(f"the batch_norm kernels take float32 or bfloat16, got {dtype}")
    if rows < 1 or c < 1:
        raise ValueError(f"batch_norm kernels: an empty ({rows}, {c}) matrix")
    esize = _ELEMENT_SIZE[dtype]
    vec = VECTOR_BYTES // esize if c % (VECTOR_BYTES // esize) == 0 else 1
    width = c // vec
    lanes = min(_pow2_at_least(width),
                max(1, MAX_BLOCK_BYTES // (vec * esize)) if vec > 1 else 32)
    while lanes < min(_pow2_at_least(width), THREADS) and rows < THREADS // lanes * THREAD_ROWS:
        lanes *= 2
    slots = THREADS // lanes
    blocks = -(-width // lanes)
    if blocks > MAX_BLOCKS:
        raise ValueError(f"{blocks} channel blocks exceed a grid's {MAX_BLOCKS}")
    want = -(-sms * CTAS_PER_SM // blocks)
    chunks = max(1, min(want, rows // (slots * UNROLL)))
    chunk_rows = -(-rows // (slots * chunks)) * slots
    return LaunchPlan(rows=rows, c=c, vec=vec, lanes=lanes, slots=slots, cb=lanes * vec,
                      blocks=blocks, chunks=-(-rows // chunk_rows), chunk_rows=chunk_rows)


def matrix_shape(x: torch.Tensor) -> tuple[int, int]:
    """(rows, C) of a (B, features) input or of a channels_last 4-D map."""
    if x.dim() == 2:
        return x.shape[0], x.shape[1]
    if x.dim() == 4:
        b, c, h, w = x.shape
        return b * h * w, c
    raise ValueError(f"the batch_norm kernels take 2-D or 4-D inputs, got {x.dim()}-D")


def row_major(x: torch.Tensor) -> torch.Tensor:
    """x in the kernels' memory order: contiguous, channels_last for a map."""
    if x.dim() == 4:
        return x.contiguous(memory_format=torch.channels_last)
    return x.contiguous()


# ------------------------------------------------------------------- kernel
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_PLAN = [ctypes.c_int] * 6  # LaunchPlan.args


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, its entry points typed once per process."""
    lib = native.load("batch_norm")
    ptr, f32, i32 = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"bn_fwd_stats_{suffix}")
        fn.argtypes = [ptr] * 4 + _PLAN + [ptr]
        fn = getattr(lib, f"bn_fwd_apply_{suffix}")
        fn.argtypes = [ptr] * 9 + _PLAN + [f32, f32, f32, f32, i32, i32, f32, ptr]
        fn = getattr(lib, f"bn_bwd_reduce_{suffix}")
        fn.argtypes = [ptr] * 9 + _PLAN + [i32, f32, ptr]
        fn = getattr(lib, f"bn_bwd_apply_{suffix}")
        fn.argtypes = [ptr] * 8 + _PLAN + [f32, i32, i32, f32, ptr]
        for name in ("fwd_stats", "fwd_apply", "bwd_reduce", "bwd_apply"):
            getattr(lib, f"bn_{name}_{suffix}").restype = ctypes.c_int
    return lib


def _check_matrix(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"batch_norm kernel: {name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"batch_norm kernel takes float32 or bfloat16, got {t.dtype}")
    if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"batch_norm kernel: {name} must match x in shape, dtype, device")
    if t.dim() == 4 and not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"batch_norm kernel: {name} must be channels_last-contiguous")
    if t.dim() == 2 and not t.is_contiguous():
        raise ValueError(f"batch_norm kernel: {name} must be contiguous")
    if t.data_ptr() % VECTOR_BYTES:
        raise ValueError(f"batch_norm kernel: {name} must be 16-byte aligned")


def _check_vector(name: str, t: torch.Tensor, x: torch.Tensor, shape: tuple) -> None:
    if (t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous()
            or tuple(t.shape) != shape):
        raise ValueError(
            f"batch_norm kernel: {name} must be a contiguous float32 {shape} tensor "
            f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def plan_for(x: torch.Tensor) -> LaunchPlan:
    rows, c = matrix_shape(x)
    return launch_plan(rows, c, x.dtype, sms=sm_count(x.device.index or 0))


def _scratch(x: torch.Tensor, plan: LaunchPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """The partial rows and the tickets of a statistics or reduce pass."""
    stream = torch.cuda.current_stream(x.device)
    partials = torch.empty(plan.partial_floats, dtype=torch.float32, device=x.device)
    return partials, native.tickets(x.device, stream, plan.tickets)


def fwd_stats_kernel(x: torch.Tensor, plan: LaunchPlan | None = None) -> torch.Tensor:
    """(2, C) float32: per channel sum x and sum x^2 over the rows."""
    _check_matrix("x", x, x)
    plan = plan or plan_for(x)
    lib = _lib()
    sums = torch.empty((2, plan.c), dtype=torch.float32, device=x.device)
    partials, tickets = _scratch(x, plan)
    rc = getattr(lib, f"bn_fwd_stats_{_DTYPES[x.dtype]}")(
        x.data_ptr(), sums.data_ptr(), partials.data_ptr(), tickets.data_ptr(), *plan.args(),
        torch.cuda.current_stream(x.device).cuda_stream)
    native.check(lib, "bn_error_string", rc, "batch_norm statistics")
    LAUNCHES["batch_norm_fwd_stats"] += 1
    return sums


def fwd_apply_kernel(
    x: torch.Tensor, sums: torch.Tensor | None, n: int, scale: torch.Tensor,
    bias: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
    momentum: float, eps: float, slope: float | None, plan: LaunchPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, rstd): y in x's dtype and layout; mean and rstd (C,)
    float32. With `sums` ((2, C) over `n` rows) the batch statistics, the
    running ones updated in place; without, the running statistics."""
    _check_matrix("x", x, x)
    plan = plan or plan_for(x)
    c = plan.c
    for name, t in (("scale", scale), ("bias", bias), ("running mean", running_mean),
                    ("running var", running_var)):
        _check_vector(name, t, x, (c,))
    if sums is not None:
        _check_vector("sums", sums, x, (2, c))
    lib = _lib()
    y = torch.empty_like(x)
    mean = torch.empty(c, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    rc = getattr(lib, f"bn_fwd_apply_{_DTYPES[x.dtype]}")(
        x.data_ptr(), 0 if sums is None else sums.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), *plan.args(), float(n), eps, momentum,
        1.0 - momentum, int(sums is not None), int(slope is not None),
        0.0 if slope is None else slope, torch.cuda.current_stream(x.device).cuda_stream)
    native.check(lib, "bn_error_string", rc, "batch_norm apply")
    LAUNCHES["batch_norm_fwd_apply"] += 1
    return y, mean, rstd


def bwd_reduce_kernel(
    x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    mean: torch.Tensor, rstd: torch.Tensor, slope: float | None,
    plan: LaunchPlan | None = None,
) -> torch.Tensor:
    """(2, C) float32: per channel sum g and sum g * xhat (dbias, dscale)."""
    _check_matrix("x", x, x)
    _check_matrix("dy", dy, x)
    plan = plan or plan_for(x)
    for name, t in (("scale", scale), ("bias", bias), ("mean", mean), ("rstd", rstd)):
        _check_vector(name, t, x, (plan.c,))
    lib = _lib()
    sums = torch.empty((2, plan.c), dtype=torch.float32, device=x.device)
    partials, tickets = _scratch(x, plan)
    rc = getattr(lib, f"bn_bwd_reduce_{_DTYPES[x.dtype]}")(
        x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), sums.data_ptr(), partials.data_ptr(), tickets.data_ptr(),
        *plan.args(), int(slope is not None), 0.0 if slope is None else slope,
        torch.cuda.current_stream(x.device).cuda_stream)
    native.check(lib, "bn_error_string", rc, "batch_norm backward reduce")
    LAUNCHES["batch_norm_bwd_reduce"] += 1
    return sums


def bwd_apply_kernel(
    x: torch.Tensor, dy: torch.Tensor, sums: torch.Tensor | None, n: int,
    scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
    slope: float | None, plan: LaunchPlan | None = None,
) -> torch.Tensor:
    """dx in x's dtype and layout: with `sums` ((2, C) sum g and sum g *
    xhat over `n` rows) the train form, without them the inference form."""
    _check_matrix("x", x, x)
    _check_matrix("dy", dy, x)
    plan = plan or plan_for(x)
    for name, t in (("scale", scale), ("bias", bias), ("mean", mean), ("rstd", rstd)):
        _check_vector(name, t, x, (plan.c,))
    if sums is not None:
        _check_vector("sums", sums, x, (2, plan.c))
    lib = _lib()
    dx = torch.empty_like(x)
    rc = getattr(lib, f"bn_bwd_apply_{_DTYPES[x.dtype]}")(
        x.data_ptr(), dy.data_ptr(), 0 if sums is None else sums.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
        *plan.args(), float(n), int(sums is not None), int(slope is not None),
        0.0 if slope is None else slope, torch.cuda.current_stream(x.device).cuda_stream)
    native.check(lib, "bn_error_string", rc, "batch_norm backward apply")
    LAUNCHES["batch_norm_bwd_apply"] += 1
    return dx


# ------------------------------------------------------------------ wrapper
class _BatchNormAct(torch.autograd.Function):
    """The kernels' norm and activation (module note)."""

    @staticmethod
    def forward(ctx, x, scale, bias, running_mean, running_var, train, momentum, eps,
                slope, group):
        plan = plan_for(x)
        sums, n = None, plan.rows
        if train:
            sums = fwd_stats_kernel(x, plan)
            if group is not None:
                sums = dp.all_reduce_sum(sums, group, _over(x))
                n *= group.size_of(_over(x))
        y, mean, rstd = fwd_apply_kernel(x, sums, n, scale, bias, running_mean,
                                         running_var, momentum, eps, slope, plan)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.train, ctx.slope, ctx.group, ctx.n, ctx.plan = train, slope, group, n, plan
        ctx.set_materialize_grads(False)
        return y

    @staticmethod
    def backward(ctx, dy):
        if dy is None:  # no gradient reached y (a penalty's second pass, through the convs)
            return (None,) * 10
        x, scale, bias, mean, rstd = ctx.saved_tensors
        if not ctx.train:
            dx, dscale, dbias = _InferenceBackward.apply(x, dy, scale, bias, mean, rstd,
                                                         ctx.slope, ctx.plan)
            return dx, dscale, dbias, *[None] * 7
        if torch.is_grad_enabled():  # create_graph: a second derivative follows
            raise RuntimeError("the train-mode batch_norm kernels are differentiable once")
        dy = row_major(dy)
        sums = total = bwd_reduce_kernel(x, dy, scale, bias, mean, rstd, ctx.slope, ctx.plan)
        if ctx.group is not None:
            total = dp.all_reduce_sum(sums, ctx.group, _over(x))
        dx = bwd_apply_kernel(x, dy, total, ctx.n, scale, bias, mean, rstd, ctx.slope,
                              ctx.plan)
        return dx, sums[1], sums[0], *[None] * 7


class _InferenceBackward(torch.autograd.Function):
    """The inference form's backward, (dx, dscale, dbias) from (x, dy,
    scale), by the kernels; differentiable once more (module note)."""

    @staticmethod
    def forward(ctx, x, dy, scale, bias, mean, rstd, slope, plan):
        dy = row_major(dy)
        sums = bwd_reduce_kernel(x, dy, scale, bias, mean, rstd, slope, plan)
        dx = bwd_apply_kernel(x, dy, None, plan.rows, scale, bias, mean, rstd, slope, plan)
        ctx.save_for_backward(x, dy, scale, bias, mean, rstd)
        ctx.slope, ctx.plan = slope, plan
        ctx.set_materialize_grads(False)
        return dx, sums[1], sums[0]

    @staticmethod
    def backward(ctx, ddx, ddscale, ddbias):
        if torch.is_grad_enabled():
            raise RuntimeError("the inference-mode batch_norm kernels are differentiable twice")
        if ddscale is not None or ddbias is not None:
            raise RuntimeError("a second derivative through batch_norm's dscale or dbias "
                               "has no kernel")
        x, dy, scale, bias, mean, rstd = ctx.saved_tensors
        slope, plan = ctx.slope, ctx.plan
        need_dy, need_scale = ctx.needs_input_grad[1:3]
        d_dy = d_scale = None
        if ddx is not None:
            ddx = row_major(ddx)
            if need_dy:
                d_dy = bwd_apply_kernel(x, ddx, None, plan.rows, scale, bias, mean, rstd,
                                        slope, plan)
            if need_scale:
                d_scale = bwd_reduce_kernel(x, row_major(dy * ddx), scale, bias, mean, rstd,
                                            slope, plan)[0] * rstd
        return None, d_dy, d_scale, None, None, None, None, None


def batch_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
    running_var: torch.Tensor, use_running_average: bool, momentum: float, eps: float,
    dtype: torch.dtype | None = None, slope: float | None = None, group=None,
) -> torch.Tensor:
    """BatchNorm over every axis but 1, then the activation (`slope`: None,
    0.0 for ReLU, else LeakyReLU's negative slope), in `dtype` (default the
    statistics' dtype): the plain version for a CPU tensor, else the
    kernels, whose output dtype is x's."""
    if x.device.type == "cpu":
        return bn_plain(x, scale, bias, running_mean, running_var, use_running_average,
                        momentum, eps, dtype, slope, group)
    if (dtype or torch.promote_types(x.dtype, torch.float32)) != x.dtype:
        raise ValueError(f"batch_norm kernels: output dtype {dtype} differs from x's {x.dtype}")
    return _BatchNormAct.apply(row_major(x), scale, bias, running_mean, running_var,
                               not use_running_average, momentum, eps, slope, group)
