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
(`csrc/instance_norm.cu`) give each (sample, channel block) a cluster of
CTAs that split its H*W rows, hold their slice in shared memory where it
fits, and move 16 bytes per load where C allows; the backward also sums
dgamma and dbeta over the batch. `launch_plan` chooses the shape of a
launch; the kernels only check it.

A CPU tensor takes the plain versions below, which mirror `_in_fwd_xla` and
`_in_bwd_xla` expression by expression; a CUDA tensor launches the kernels
or raises. `LAUNCHES` counts kernel launches.

Under a spatial partition (`instance_norm(..., group=...)` with a
core.mesh.DataGroup whose spatial factor is > 1) x is this rank's block of
rows of each map, and a (sample, channel) plane is spread over the spatial
peers. The norm is then split around one collective in each direction
(`_SplitInstanceNorm`), with four kernels of the same source:

    forward:  in_fwd_partial: per (b, c) and each of k chunks of this
                shard's rows, the chunk's sum x and centred sum (x - m)^2
                about its own mean m -> (k, B, C, 2) float32 (k = 1 for the
                plain version; the kernel's plan picks k)
              all_gather over the spatial group -> (S, k, B, C, 2)
              in_fwd_apply: the S x k partials merged by Chan's formula into
                the whole plane's mean and var, as the two-pass jnp.var sees
                it; y on this shard's rows; the merged mean and rstd saved
                for the backward
    backward: in_bwd_partial: per (b, c), this shard's sum g and sum g*xhat
                (g = dy * gamma, dy masked by the ReLU) -> (B, C, 2); per c,
                this shard's dgamma and dbeta summed over its samples
              all_reduce of the (B, C, 2) sums over the spatial group
              in_bwd_apply: dx = rstd * (g - sum g / N - xhat * sum g*xhat / N),
                N = H * W of the whole map

The partial kernels read their input once, straight into registers, on
plain grids of row chunks (`fwd_partial_plan`, `bwd_partial_plan`): the
forward partial writes each chunk's (sum, M2) for the apply to merge; the
backward partial's last CTA of a channel block adds the chunks in the
single-pass backward's order, so one shard gives that kernel's bits. The
applies (`fwd_apply_plan`, `bwd_apply_plan`) issue the loads of their
rows before they merge the partials or load the statistics; the forward
takes as many rows a thread as leave MIN_CTAS CTAs, so that fewer CTAs
repeat the merge.

dgamma and dbeta need no spatial reduce: they are parameter gradients,
which the step sums over the world and divides by the data size
(parallel/dp.py). The partials stay float32 under bfloat16 (float64 in the
CPU parity tests). `SPLIT_LAUNCHES` counts the split kernels' launches;
`group.counts` counts the collectives ("norm_gather", "norm_all_reduce").
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from imagegeneration_tpu_torch.ops import native

LAUNCHES = {"instance_norm_fwd": 0, "instance_norm_bwd": 0}
SPLIT_LAUNCHES = {"instance_norm_fwd_partial": 0, "instance_norm_fwd_apply": 0,
                  "instance_norm_bwd_partial": 0, "instance_norm_bwd_apply": 0}

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


def _masked(x, dy, gamma, beta, mean, rstd, relu):
    """(xhat, dy masked by the ReLU) in promote_types(x.dtype, float32)."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xhat = (x.to(ct) - _per_channel(mean)) * _per_channel(rstd)
    dy = dy.to(ct)
    if relu:
        pre = xhat * _per_channel(gamma.to(ct)) + _per_channel(beta.to(ct))
        dy = dy * (pre > 0)
    return xhat, dy


def in_bwd_plain(
    x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    mean: torch.Tensor, rstd: torch.Tensor, relu: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dgamma, dbeta): dx in x's dtype (the cast of the JAX `_in_bwd`),
    dgamma and dbeta (C,) in float32."""
    xhat, dy = _masked(x, dy, gamma, beta, mean, rstd, relu)
    dbeta = dy.sum((0, 2, 3))
    dgamma = (dy * xhat).sum((0, 2, 3))
    g = dy * _per_channel(gamma.to(torch.float32))
    mean_g = g.mean(_SPATIAL, keepdim=True)
    mean_gx = (g * xhat).mean(_SPATIAL, keepdim=True)
    dx = _per_channel(rstd) * (g - mean_g - xhat * mean_gx)
    return dx.to(x.dtype), dgamma, dbeta


# ------------------------------------------------ plain version, split form
def chunk_counts(hw: int, splits: int) -> list[int]:
    """The rows of each chunk when a shard's `hw` rows are cut into at most
    `splits` chunks of ceil(hw / splits) rows, the last one what is left
    (no chunk is empty; k chunks cut this way come back as k chunks)."""
    rows = -(-hw // splits)
    return [min(rows, hw - j * rows) for j in range(-(-hw // rows))]


def in_fwd_partial_plain(x: torch.Tensor, splits: int = 1) -> torch.Tensor:
    """(splits, B, C, 2) in promote_types(x.dtype, float32): per chunk of
    the shard's h*W rows (chunk_counts) and (sample, channel), the chunk's
    sum of x and its sum of squares about the chunk's own mean."""
    ct = torch.promote_types(x.dtype, torch.float32)
    rows = x.to(ct).flatten(2).split(chunk_counts(x.shape[2] * x.shape[3], splits), -1)
    out = []
    for chunk in rows:
        s = chunk.sum(-1)
        centered = chunk - (s / chunk.shape[-1])[..., None]
        out.append(torch.stack([s, (centered * centered).sum(-1)], -1))
    return torch.stack(out)


def in_fwd_apply_plain(
    x: torch.Tensor, parts: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    eps: float, relu: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, rstd) of this shard from the (S, k, B, C, 2) partials of
    the k chunks of each of the S equal shards of each map (Chan's formula):
    mean = sum sums / N, var = (sum m2 + sum n_q (sums_q / n_q - mean)^2) /
    N, n_q the chunk's rows, N = S * h * W."""
    ct = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(ct)
    n = x.shape[2] * x.shape[3]
    total = n * parts.shape[0]
    counts = torch.tensor(chunk_counts(n, parts.shape[1]), dtype=parts.dtype,
                          device=parts.device)[:, None, None]
    sums, m2 = parts[..., 0], parts[..., 1]
    mean = sums.sum((0, 1)) / total
    delta = sums / counts - mean
    var = (m2.sum((0, 1)) + (counts * delta * delta).sum((0, 1))) / total
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - _per_channel(mean)) * _per_channel(rstd)
    y = xhat * _per_channel(gamma.to(ct)) + _per_channel(beta.to(ct))
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype), mean, rstd


def in_bwd_partial_plain(
    x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    mean: torch.Tensor, rstd: torch.Tensor, relu: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sums, dgamma, dbeta): sums (B, C, 2) = sum g and sum g * xhat over
    the shard's rows (g = dy * gamma); dgamma and dbeta (C,) over the
    shard's samples and rows."""
    xhat, dy = _masked(x, dy, gamma, beta, mean, rstd, relu)
    g = dy * _per_channel(gamma.to(torch.float32))  # the JAX `_in_bwd_xla`'s cast
    sums = torch.stack([g.sum(_SPATIAL), (g * xhat).sum(_SPATIAL)], -1)
    return sums, (dy * xhat).sum((0, 2, 3)), dy.sum((0, 2, 3))


def in_bwd_apply_plain(
    x: torch.Tensor, dy: torch.Tensor, sums: torch.Tensor, gamma: torch.Tensor,
    beta: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor, relu: bool, total: int,
) -> torch.Tensor:
    """dx of this shard in x's dtype, from `sums` (B, C, 2) over the whole
    map of `total` = H * W elements per plane."""
    xhat, dy = _masked(x, dy, gamma, beta, mean, rstd, relu)
    g = dy * _per_channel(gamma.to(torch.float32))
    mean_g, mean_gx = sums[..., 0] / total, sums[..., 1] / total
    dx = _per_channel(rstd) * (g - _per_channel(mean_g) - xhat * _per_channel(mean_gx))
    return dx.to(x.dtype)


# -------------------------------------------------------------- launch plan
MAX_CLUSTER = 16  # CTAs per cluster; above 8 the H100's non-portable size
CHANNEL_BLOCK = 32  # the widest channel block (kMaxChannelBlock in the source)
MIN_CTAS = 128  # the H100 has 132 SMs
MIN_ROWS = 32  # the plan splits H*W no finer
SMEM_TARGET = 64 << 10  # held slices per CTA, so that three fit an SM
SMEM_LIMIT = 232448 - 8192  # a CTA's 227 KB, less the kernels' static buffers
_ELEMENT_SIZE = {torch.float32: 4, torch.bfloat16: 2}


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one kernel launch covers a (B, C, H, W) tensor.

    A (sample, channel block) group of `channel_block` channels is one
    cluster of `cluster` CTAs, each taking `rows` consecutive rows of H*W;
    a thread moves `vec` consecutive channels per load (16 bytes; 1 on the
    scalar path). The CTA holds its slice of the first `held` inputs (x,
    then dy) in `smem_bytes` of dynamic shared memory; the later passes
    re-read the others (from L2).
    """

    vec: int
    channel_block: int
    blocks: int
    cluster: int
    rows: int
    held: int
    smem_bytes: int
    ctas: int

    def args(self) -> list[int]:
        """The plan's entry-point arguments: cb, vec, cluster, rows, smem
        (the source derives `held` from the shared-memory bytes)."""
        return [self.channel_block, self.vec, self.cluster, self.rows, self.smem_bytes]


def launch_plan(
    b: int, c: int, h: int, w: int, dtype: torch.dtype, tensors: int = 1, *,
    channel_block: int | None = None, cluster: int | None = None,
    held: int | None = None,
) -> LaunchPlan:
    """The launch plan of the forward (`tensors` = 1: x) or the backward (2:
    x and dy) at one shape.

    - vec: 16 bytes of channels when C is a multiple of them, else 1.
    - channel block: on the 16-byte path the widest power-of-two number of
      chunks (<= CHANNEL_BLOCK channels) that divides C, so blocks tile C
      and a warp holds whole row segments; else min(C, CHANNEL_BLOCK).
    - cluster: doubled from 1 until the launch has MIN_CTAS CTAs, while
      each CTA keeps at least MIN_ROWS rows, up to MAX_CLUSTER.
    - at the largest cluster, the 16-byte path's block is halved (to no
      fewer than 16 channels, twice the CTAs) once, if that makes every
      input's slice fit SMEM_TARGET;
    - held: as many inputs' slices as fit SMEM_TARGET.

    The keyword arguments override the choice (the tuning tool's sweep).
    """
    esize = _ELEMENT_SIZE[dtype]
    hw = h * w
    vec = 16 // esize if c % (16 // esize) == 0 else 1
    auto_block = channel_block is None
    if auto_block:
        if vec == 1:
            channel_block = min(c, CHANNEL_BLOCK)
        else:
            lanes = CHANNEL_BLOCK // vec
            while (c // vec) % lanes:
                lanes //= 2
            channel_block = lanes * vec

    blocks = -(-c // channel_block)
    k = cluster
    if k is None:
        k = 1
        while k < MAX_CLUSTER and b * blocks * k < MIN_CTAS and hw >= 2 * k * MIN_ROWS:
            k *= 2
    rows = -(-hw // k)
    if (auto_block and vec > 1 and k == MAX_CLUSTER and channel_block > 16
            and SMEM_TARGET < tensors * rows * channel_block * esize <= 2 * SMEM_TARGET):
        channel_block //= 2
        blocks *= 2
    slice_bytes = rows * channel_block * esize
    if held is None:
        held = min(tensors, SMEM_TARGET // slice_bytes)
    held = min(held, tensors)
    return LaunchPlan(vec=vec, channel_block=channel_block, blocks=blocks, cluster=k,
                      rows=rows, held=held, smem_bytes=held * slice_bytes,
                      ctas=b * blocks * k)


HOLD = 16  # rows a thread of the forward partial holds (kHold in the source)
FWD_APPLY_DEEP = 16  # rows of x a forward-apply thread has in flight (kFwdApplyDeep)
SHALLOW = 4  # the applies' batch where a thread has at most that many rows (kShallow)
MERGE_PARTS = 8  # chunk partials a forward-apply thread holds in registers (kMergeParts)


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """How a split pass covers a (B, C, h, W) shard: a plain grid of
    (`chunks`, `blocks`, B) CTAs, each taking `rows` consecutive rows of
    h*W and `channel_block` channels, `vec` per load (the channel block
    and vec of `launch_plan`)."""

    vec: int
    channel_block: int
    blocks: int
    chunks: int
    rows: int
    ctas: int

    def args(self) -> list[int]:
        """The entry-point arguments: cb, vec, chunks, rows."""
        return [self.channel_block, self.vec, self.chunks, self.rows]


def _grid(base: LaunchPlan, b: int, hw: int, rows: int) -> GridPlan:
    chunks = -(-hw // rows)
    return GridPlan(vec=base.vec, channel_block=base.channel_block, blocks=base.blocks,
                    chunks=chunks, rows=rows, ctas=chunks * base.blocks * b)


def _apply_plan(b: int, c: int, h: int, w: int, dtype: torch.dtype, deep: int,
                depth: int | None) -> GridPlan:
    base = launch_plan(b, c, h, w, dtype, 1, cluster=1)
    slots, hw = 256 // (base.channel_block // base.vec), h * w
    if depth is None:
        depth = deep
        while (depth > 1 and b * base.blocks * -(-hw // (slots * depth)) < MIN_CTAS
               and -(-hw // (slots * depth)) < -(-hw // slots)):
            depth = min(depth // 2, SHALLOW)
    return _grid(base, b, hw, slots * depth)


def fwd_apply_plan(b: int, c: int, h: int, w: int, dtype: torch.dtype,
                   depth: int | None = None) -> GridPlan:
    """The forward apply's chunks: `depth` rows a thread (a CTA of 256
    threads takes 256 / (cb / vec) row slots times that): FWD_APPLY_DEEP,
    the deep kernel's batch, where the launch then has MIN_CTAS CTAs (as
    few CTAs as fill the card, each merging the partials once for the most
    rows); else SHALLOW, the shallow kernel's batch, halved (in powers of
    two) until the launch has MIN_CTAS CTAs, while a smaller depth could
    still cut the shard into more chunks. `depth` overrides the choice
    (the timing tool's sweep)."""
    return _apply_plan(b, c, h, w, dtype, FWD_APPLY_DEEP, depth)


def bwd_apply_plan(b: int, c: int, h: int, w: int, dtype: torch.dtype,
                   depth: int | None = None) -> GridPlan:
    """The backward apply's chunks: as fwd_apply_plan from SHALLOW rows a
    thread (x and dy both in flight): it has no merge to spread over fewer
    CTAs."""
    return _apply_plan(b, c, h, w, dtype, SHALLOW, depth)


def merge_threads(channel_block: int) -> int:
    """G, the forward apply's threads per channel in its merge of the
    partials: a power of two up to a warp, G * channel_block <= 256."""
    g = 32
    while g * channel_block > 256:
        g //= 2
    return g


def merge_rounds(channel_block: int, parts: int) -> int:
    """Rounds of MERGE_PARTS partials a thread of the forward apply reads
    to merge `parts` (S x k) chunks: 1 where they all fit its registers
    (Chan's two passes over them), more for the pairwise fallback; every
    partial is read once either way."""
    return -(-parts // (merge_threads(channel_block) * MERGE_PARTS))


def fwd_partial_plan(b: int, c: int, h: int, w: int, dtype: torch.dtype) -> GridPlan:
    """The forward partial's chunks: each thread holds at most HOLD rows in
    registers, so a chunk has at most 256 / (cb / vec) x HOLD rows; the
    chunks are halved (counted in powers of two) until the launch has
    MIN_CTAS CTAs, while every thread keeps a row."""
    base = launch_plan(b, c, h, w, dtype, 1, cluster=1)
    slots, hw = 256 // (base.channel_block // base.vec), h * w
    k = 1
    while -(-hw // k) > slots * HOLD:
        k *= 2
    while b * base.blocks * k < MIN_CTAS and -(-hw // (2 * k)) >= slots:
        k *= 2
    return _grid(base, b, hw, -(-hw // k))


def bwd_partial_plan(b: int, c: int, h: int, w: int, dtype: torch.dtype) -> GridPlan:
    """The backward partial's chunks: the single-pass backward's CTAs
    (launch_plan's channel block, cluster size and rows), each on its own,
    so that one shard sums in that kernel's order."""
    base = launch_plan(b, c, h, w, dtype, 2)
    return _grid(base, b, h * w, base.rows)


# ------------------------------------------------------------------- kernel
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_INTS = [ctypes.c_int] * 8  # B, H*W, C, then the plan (LaunchPlan.args)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, its entry points typed once per process."""
    lib = native.load("instance_norm")
    for suffix in _DTYPES.values():
        fwd = getattr(lib, f"in_fwd_{suffix}")
        fwd.restype = ctypes.c_int
        fwd.argtypes = [ctypes.c_void_p] * 6 + _INTS + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        bwd = getattr(lib, f"in_bwd_{suffix}")
        bwd.restype = ctypes.c_int
        bwd.argtypes = [ctypes.c_void_p] * 11 + _INTS + [ctypes.c_int, ctypes.c_void_p]
        fwd_partial = getattr(lib, f"in_fwd_partial_{suffix}")
        fwd_partial.restype = ctypes.c_int
        fwd_partial.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        bwd_partial = getattr(lib, f"in_bwd_partial_{suffix}")
        bwd_partial.restype = ctypes.c_int
        bwd_partial.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fwd_apply = getattr(lib, f"in_fwd_apply_{suffix}")
        fwd_apply.restype = ctypes.c_int
        fwd_apply.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        bwd_apply = getattr(lib, f"in_bwd_apply_{suffix}")
        bwd_apply.restype = ctypes.c_int
        bwd_apply.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.in_active_clusters.restype = ctypes.c_int
    lib.in_active_clusters.argtypes = [ctypes.c_int] * 9
    return lib


def active_clusters(plan: LaunchPlan, c: int, hw: int, dtype: torch.dtype,
                    backward: bool) -> int:
    """How many clusters of `plan` the card holds at once (CUDA's occupancy
    API); the plan's clusters beyond that wait for a second wave."""
    n = _lib().in_active_clusters(int(backward), int(dtype == torch.bfloat16), hw, c,
                                  *plan.args())
    if n < 0:
        native.check(_lib(), "in_error_string", -n, "instance_norm occupancy query")
    return n


_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: torch.cuda.Stream, n: int) -> torch.Tensor:
    """The backward kernels' per-channel-block ticket counters on `stream`.
    They start at 0 and every launch leaves them at 0 (atomicInc wraps at
    the number of CTAs that take a ticket: B, or chunks x B for the split
    partial), so one zeroed buffer per stream serves every call."""
    key = (device.index, stream.cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
    return t


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


def _check_aligned(plan: LaunchPlan | GridPlan, *ts: torch.Tensor) -> None:
    if plan.vec > 1 and any(t.data_ptr() % 16 for t in ts):
        raise ValueError("instance_norm kernel: the 16-byte path needs 16-byte aligned "
                         "tensors (a view at an odd storage offset is not)")


def _check_vector(name: str, t: torch.Tensor, x: torch.Tensor, shape: tuple) -> None:
    if (t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous()
            or tuple(t.shape) != shape):
        raise ValueError(
            f"instance_norm kernel: {name} must be a contiguous float32 {shape} tensor "
            f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def in_fwd_kernel(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float, relu: bool,
    plan: LaunchPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_activation("x", x, x)
    b, c, h, w = x.shape
    _check_vector("gamma", gamma, x, (c,))
    _check_vector("beta", beta, x, (c,))
    plan = plan or launch_plan(b, c, h, w, x.dtype, 1)
    _check_aligned(plan, x)
    lib = _lib()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    rc = getattr(lib, f"in_fwd_{_DTYPES[x.dtype]}")(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), b, h * w, c, *plan.args(), eps, int(relu),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    native.check(lib, "in_error_string", rc, "instance_norm forward")
    LAUNCHES["instance_norm_fwd"] += 1
    return y, mean, rstd


def in_bwd_kernel(
    x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    mean: torch.Tensor, rstd: torch.Tensor, relu: bool, plan: LaunchPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_activation("x", x, x)
    _check_activation("dy", dy, x)
    b, c, h, w = x.shape
    _check_vector("gamma", gamma, x, (c,))
    _check_vector("beta", beta, x, (c,))
    _check_vector("mean", mean, x, (b, c))
    _check_vector("rstd", rstd, x, (b, c))
    plan = plan or launch_plan(b, c, h, w, x.dtype, 2)
    _check_aligned(plan, x, dy)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    partials = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    tickets = _tickets(x.device, stream, plan.blocks)
    rc = getattr(lib, f"in_bwd_{_DTYPES[x.dtype]}")(
        x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), partials.data_ptr(), tickets.data_ptr(), b, h * w, c,
        *plan.args(), int(relu), stream.cuda_stream,
    )
    native.check(lib, "in_error_string", rc, "instance_norm backward")
    LAUNCHES["instance_norm_bwd"] += 1
    return dx, dgamma, dbeta


def in_fwd_partial_kernel(x: torch.Tensor, plan: GridPlan | None = None) -> torch.Tensor:
    """(k, B, C, 2): the plan's k chunks (in_fwd_partial_plain(x, k))."""
    _check_activation("x", x, x)
    b, c, h, w = x.shape
    plan = plan or fwd_partial_plan(b, c, h, w, x.dtype)
    _check_aligned(plan, x)
    lib = _lib()
    parts = torch.empty((plan.chunks, b, c, 2), dtype=torch.float32, device=x.device)
    rc = getattr(lib, f"in_fwd_partial_{_DTYPES[x.dtype]}")(
        x.data_ptr(), parts.data_ptr(), b, h * w, c, *plan.args(),
        torch.cuda.current_stream(x.device).cuda_stream)
    native.check(lib, "in_error_string", rc, "instance_norm partial forward")
    SPLIT_LAUNCHES["instance_norm_fwd_partial"] += 1
    return parts


def in_fwd_apply_kernel(
    x: torch.Tensor, parts: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    eps: float, relu: bool, plan: GridPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_activation("x", x, x)
    b, c, h, w = x.shape
    if parts.dim() != 5:
        raise ValueError(f"instance_norm apply: parts must be (S, k, B, C, 2), got "
                         f"{tuple(parts.shape)}")
    _check_vector("parts", parts, x, (*parts.shape[:2], b, c, 2))
    _check_vector("gamma", gamma, x, (c,))
    _check_vector("beta", beta, x, (c,))
    plan = plan or fwd_apply_plan(b, c, h, w, x.dtype)
    _check_aligned(plan, x)
    lib = _lib()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    rc = getattr(lib, f"in_fwd_apply_{_DTYPES[x.dtype]}")(
        x.data_ptr(), parts.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), b, h * w, c, *plan.args(), parts.shape[0],
        parts.shape[1], eps, int(relu), torch.cuda.current_stream(x.device).cuda_stream)
    native.check(lib, "in_error_string", rc, "instance_norm apply forward")
    SPLIT_LAUNCHES["instance_norm_fwd_apply"] += 1
    return y, mean, rstd


def in_bwd_partial_kernel(
    x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
    mean: torch.Tensor, rstd: torch.Tensor, relu: bool, plan: GridPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_activation("x", x, x)
    _check_activation("dy", dy, x)
    b, c, h, w = x.shape
    _check_vector("gamma", gamma, x, (c,))
    _check_vector("beta", beta, x, (c,))
    _check_vector("mean", mean, x, (b, c))
    _check_vector("rstd", rstd, x, (b, c))
    plan = plan or bwd_partial_plan(b, c, h, w, x.dtype)
    _check_aligned(plan, x, dy)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device)
    sums = torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    chunks = torch.empty((plan.chunks, b, c, 2), dtype=torch.float32, device=x.device)
    tickets = _tickets(x.device, stream, plan.blocks)
    rc = getattr(lib, f"in_bwd_partial_{_DTYPES[x.dtype]}")(
        x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), sums.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
        chunks.data_ptr(), tickets.data_ptr(), b, h * w, c, *plan.args(), int(relu),
        stream.cuda_stream)
    native.check(lib, "in_error_string", rc, "instance_norm partial backward")
    SPLIT_LAUNCHES["instance_norm_bwd_partial"] += 1
    return sums, dgamma, dbeta


def in_bwd_apply_kernel(
    x: torch.Tensor, dy: torch.Tensor, sums: torch.Tensor, gamma: torch.Tensor,
    beta: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor, relu: bool, total: int,
    plan: GridPlan | None = None,
) -> torch.Tensor:
    _check_activation("x", x, x)
    _check_activation("dy", dy, x)
    b, c, h, w = x.shape
    _check_vector("sums", sums, x, (b, c, 2))
    _check_vector("gamma", gamma, x, (c,))
    _check_vector("beta", beta, x, (c,))
    _check_vector("mean", mean, x, (b, c))
    _check_vector("rstd", rstd, x, (b, c))
    if total % (h * w) or total >= 2**24:
        raise ValueError(f"instance_norm apply: {total} elements per plane is not a whole "
                         f"number of {h * w}-element shards below 2**24")
    plan = plan or bwd_apply_plan(b, c, h, w, x.dtype)
    _check_aligned(plan, x, dy)
    lib = _lib()
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    rc = getattr(lib, f"in_bwd_apply_{_DTYPES[x.dtype]}")(
        x.data_ptr(), dy.data_ptr(), sums.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), b, h * w, c, *plan.args(),
        float(total), int(relu), torch.cuda.current_stream(x.device).cuda_stream)
    native.check(lib, "in_error_string", rc, "instance_norm apply backward")
    SPLIT_LAUNCHES["instance_norm_bwd_apply"] += 1
    return dx


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


def in_fwd_partial(x):
    """Split forward, partial pass: the plain version for a CPU tensor, else
    the kernel."""
    if x.device.type == "cpu":
        return in_fwd_partial_plain(x)
    return in_fwd_partial_kernel(x)


def in_fwd_apply(x, parts, gamma, beta, eps: float, relu: bool):
    """Split forward, apply pass: the plain version for a CPU tensor, else
    the kernel."""
    if x.device.type == "cpu":
        return in_fwd_apply_plain(x, parts, gamma, beta, eps, relu)
    return in_fwd_apply_kernel(x, parts, gamma, beta, eps, relu)


def in_bwd_partial(x, dy, gamma, beta, mean, rstd, relu: bool):
    """Split backward, partial pass: the plain version for a CPU tensor,
    else the kernel."""
    if x.device.type == "cpu":
        return in_bwd_partial_plain(x, dy, gamma, beta, mean, rstd, relu)
    return in_bwd_partial_kernel(x, dy, gamma, beta, mean, rstd, relu)


def in_bwd_apply(x, dy, sums, gamma, beta, mean, rstd, relu: bool, total: int):
    """Split backward, apply pass: the plain version for a CPU tensor, else
    the kernel."""
    if x.device.type == "cpu":
        return in_bwd_apply_plain(x, dy, sums, gamma, beta, mean, rstd, relu, total)
    return in_bwd_apply_kernel(x, dy, sums, gamma, beta, mean, rstd, relu, total)


def gather_partials(part: torch.Tensor, group) -> torch.Tensor:
    """The spatial peers' (k, B, C, 2) partials, (S, k, B, C, 2) in peer
    order: one all_gather_into_tensor over the spatial group."""
    out = part.new_empty((group.spatial * part.shape[0], *part.shape[1:]))
    dist.all_gather_into_tensor(out, part.contiguous(), group=group.pg_of("spatial"))
    group.counts["norm_gather"] += 1
    return out.view(group.spatial, *part.shape)


def sum_over_peers(sums: torch.Tensor, group) -> torch.Tensor:
    """The (B, C, 2) split sums summed over the spatial peers: one
    all_reduce over the spatial group (in place)."""
    dist.all_reduce(sums, group=group.pg_of("spatial"))
    group.counts["norm_all_reduce"] += 1
    return sums


class _SplitInstanceNorm(torch.autograd.Function):
    """The norm of an H-partitioned map (module docstring): partial ->
    all_gather -> apply, and backward partial -> all_reduce -> apply.
    Differentiable once: its backward is not differentiable again (the
    CycleGAN step has no gradient penalty)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, relu, group):
        parts = gather_partials(in_fwd_partial(x), group)
        y, mean, rstd = in_fwd_apply(x, parts, gamma, beta, eps, relu)
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        ctx.relu, ctx.group = relu, group
        ctx.total = parts.shape[0] * x.shape[2] * x.shape[3]
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        dy = dy.contiguous(memory_format=torch.channels_last)
        sums, dgamma, dbeta = in_bwd_partial(x, dy, gamma, beta, mean, rstd, ctx.relu)
        sums = sum_over_peers(sums, ctx.group)
        dx = in_bwd_apply(x, dy, sums, gamma, beta, mean, rstd, ctx.relu, ctx.total)
        return dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), None, None, None


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
    eps: float = 1e-3, relu: bool = False, group=None,
) -> torch.Tensor:
    """Per-(sample, channel) instance norm over (H, W) with affine (+ReLU).

    x: (B, C, H, W), float32 or bfloat16 (any layout; computed in
    channels_last). gamma, beta: (C,) float32. Returns y in x's dtype,
    channels_last. With a spatially partitioned `group`, x is this rank's
    block of rows of each map and the statistics are the whole map's (the
    split form)."""
    x = x.contiguous(memory_format=torch.channels_last)
    if group is not None and group.sharded:
        return _SplitInstanceNorm.apply(x, gamma, beta, eps, relu, group)
    return _InstanceNorm.apply(x, gamma, beta, eps, relu)
