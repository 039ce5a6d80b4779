"""Fused LeakyReLU(0.1) + counter-hash dropout, with a recomputed-mask VJP.

Replaces the TPU kernel pair of imagegeneration_tpu/ops/pallas/dropout.py
(`_kernel`, `_bwd_kernel` behind `leaky_relu_dropout`). The mask is the JAX
main path's (imagegeneration_tpu/ops/bitdropout.py, `_hash_mask` with
rounds=1), not the TPU hardware PRNG, so the port is held to the JAX
discriminator bit for bit given the same two key words:

    idx  = base + NHWC linear index (the memory offset of a channels_last
           tensor); base = 0 on one device
    h    = fmix32(idx ^ k0) + k1                       (uint32 arithmetic)
    keep = (h & 0xFF) >= cut,   cut = round(rate * 256)
    y    = keep ? leaky_relu(x, 0.1) * 256 / (256 - cut) : 0

This mask is a constant of the port: the JAX config's other mask choices
(`dropout_bits`, `dropout_hash`, `dropout_hash_rounds`) have no
counterpart, because its main path uses this one ("hash1": counter hash,
one fmix32 round) and nothing else is ported.

The backward regenerates the mask, so the only saved activation is `x`.

Under data parallelism a rank holds rows [r*b, (r+1)*b) of a global batch
of B; the JAX package keys the mask by the GLOBAL NHWC index of the
(B, H, W, C) array, so rank r passes `base = r*b*H*W*C` (`rows_base`) and
the global element count `total = B*H*W*C`, which must stay below 2**32
(the index is uint32). Under a spatial partition a rank holds only image
rows [h0, h0 + h) of H as well (`hblock=(h0, H)`): its rows are then not
one block of the global index, and local offset i = b*h*W*C + r*W*C +
rest maps to

    base + b*H*W*C + (h0 + r)*W*C + rest = base + h0*W*C + i + (i // (h*W*C)) * (H - h)*W*C

(`global_index`), in the kernel and in the plain version alike. The base
and the row block are launch arguments (host ints), so a launch still
never syncs the host.

On the H100 both passes are bound by device-memory bandwidth (forward reads
x and writes y; backward reads x and g and writes dx); the kernels
(`csrc/leaky_relu_dropout.cu`) keep the mask out of device memory and read
the key words from a device tensor, so a launch never syncs the host. Both
passes launch from one plan (`launch_plan`): 16-byte vectors, U of them in
flight a thread (of x, and of g in the backward), over a (row, offset) grid
of single-trip CTAs that needs no division on a shard; or the pass's scalar
kernel, for data that is not 16-byte aligned or rows that do not fall on
vector boundaries. The plan reads the card's SM count (`sm_count`).

`leaky_relu_dropout` is the wrapper. A CPU tensor takes the plain PyTorch
version below (the same function, emulating uint32 in int64 ops); a CUDA
tensor launches the kernel or raises. `LAUNCHES` counts kernel launches,
`FWD_PATHS` and `BWD_PATHS` each pass's by path.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from imagegeneration_tpu_torch.core.rng import fmix32
from imagegeneration_tpu_torch.ops import native

NEGATIVE_SLOPE = 0.1
_U32 = 0xFFFFFFFF

LAUNCHES = {"leaky_relu_dropout_fwd": 0, "leaky_relu_dropout_bwd": 0}
FWD_PATHS = {"vector": 0, "scalar": 0}
BWD_PATHS = {"vector": 0, "scalar": 0}


def dropout_cut(rate: float) -> int:
    """Byte threshold of the mask: rate quantized to 1/256 (bitdropout)."""
    cut = round(rate * 256.0)
    if not 0 <= cut < 256:
        raise ValueError(f"dropout rate must be in [0, 255.5/256), got {rate!r}")
    return cut


def keep_scale(cut: int) -> float:
    """Inverted-dropout scale for the exact quantized keep probability."""
    return 256.0 / (256 - cut)


# ------------------------------------------------------------ plain version
def global_index(numel: int, base: int = 0, rowmap: tuple[int, int, int, int] | None = None,
                 device=None) -> torch.Tensor:
    """The global element index of local offsets 0..numel-1 (int64): base +
    i, or for a row block `rowmap` = (h_local, h_global, h0, wc) of image
    rows [h0, h0 + h_local) of h_global, each wc = W*C elements,
    base + h0*wc + i + (i // (h_local*wc)) * (h_global - h_local)*wc."""
    i = torch.arange(numel, device=device, dtype=torch.int64)
    if rowmap is None:
        return base + i
    h_local, h_global, h0, wc = rowmap
    return base + h0 * wc + i + torch.div(i, h_local * wc, rounding_mode="floor") \
        * ((h_global - h_local) * wc)


def hash_keep_mask(kw: torch.Tensor, numel: int, cut: int, base: int = 0,
                   rowmap: tuple[int, int, int, int] | None = None) -> torch.Tensor:
    """Keep mask of local offsets 0..numel-1 at their global indices
    (`global_index`; default base..base+numel-1): bool, flat."""
    idx = global_index(numel, base, rowmap, kw.device) & _U32
    h = (fmix32(idx ^ kw[0]) + kw[1]) & _U32
    return (h & 0xFF) >= cut


def rows_base(x: torch.Tensor, first_row: int, h_global: int | None = None) -> int:
    """The element-index base of a shard of batch rows that starts at global
    row `first_row`: rows before it times the elements of one global row
    (x's own, or of `h_global` image rows of x's width and channels)."""
    _, c, h, w = x.shape
    return first_row * c * w * (h if h_global is None else h_global)


def row_map(x: torch.Tensor, hblock: tuple[int, int] | None) -> tuple[int, int, int, int] | None:
    """(h_local, h_global, h0, wc) of x holding image rows [h0, h0 + h) of
    h_global, for `hblock` = (h0, h_global); None for whole maps."""
    if hblock is None:
        return None
    h0, h_global = hblock
    _, c, h, w = x.shape
    if h0 < 0 or h0 + h > h_global:
        raise ValueError(f"image rows [{h0}, {h0 + h}) outside the {h_global} rows of the map")
    return h, h_global, h0, w * c


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    # float32 for float32 and bfloat16 (the kernel's math); float64 stays
    # float64, as the JAX float64 step computes it (CPU tests).
    return torch.promote_types(x.dtype, torch.float32)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def fwd_plain(x: torch.Tensor, kw: torch.Tensor, cut: int, base: int = 0,
              hblock: tuple[int, int] | None = None) -> torch.Tensor:
    xn = _nhwc(x).to(_compute_dtype(x))
    keep = hash_keep_mask(kw, x.numel(), cut, base, row_map(x, hblock)).view(xn.shape)
    leaky = torch.where(xn >= 0, xn, xn * NEGATIVE_SLOPE)
    y = torch.where(keep, leaky * keep_scale(cut), torch.zeros((), device=x.device))
    return _nchw(y.to(x.dtype))


def bwd_plain(
    x: torch.Tensor, g: torch.Tensor, kw: torch.Tensor, cut: int, base: int = 0,
    hblock: tuple[int, int] | None = None,
) -> torch.Tensor:
    xn = _nhwc(x).to(_compute_dtype(x))
    keep = hash_keep_mask(kw, x.numel(), cut, base, row_map(x, hblock)).view(xn.shape)
    gs = _nhwc(g).to(xn.dtype) * keep_scale(cut)
    d = torch.where(xn >= 0, gs, gs * NEGATIVE_SLOPE)
    dx = torch.where(keep, d, torch.zeros((), device=x.device))
    return _nchw(dx.to(x.dtype))


# -------------------------------------------------------------- launch plan
THREADS = 256  # a CTA's threads (kThreads in the source)
H100_SXM_SMS = 132  # the plan's SM count where no card is given (tools, tests)
CTAS_PER_SM = 4  # CTAs resident per SM: one wave is sms * CTAS_PER_SM
DEEP_WAVES = 16  # waves of single-trip CTAs at 4 vectors a thread that take 4
VECTOR_BYTES = 16
UNROLLS = (2, 4)  # vectors a thread loads before it hashes any
MAX_ROWS = 65535  # a grid's y extent
_ELEMENT_SIZE = {torch.float32: 4, torch.bfloat16: 2}


@functools.cache
def sm_count(index: int) -> int:
    """The SMs of CUDA device `index`, read once per device."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one launch of either pass covers a tensor of `rows` rows of `row_len`
    elements (one row for a contiguous tensor, one per batch row of a
    spatial shard), `ctas_x` CTAs of THREADS threads along each row.

    path "vector": each thread loads `unroll` vectors of `vec` elements (16
    bytes) before it hashes any; a one-row launch ends in a scalar tail of
    `tail` elements. path "scalar": one element a thread a trip (`vec` 1,
    `unroll` 1)."""

    path: str
    vec: int
    unroll: int
    rows: int
    row_len: int
    tail: int
    ctas_x: int

    @property
    def ctas(self) -> int:
        return self.ctas_x * self.rows

    def args(self) -> list[int]:
        """The plan's entry-point arguments: unroll (0 selects the scalar
        kernel), then the CTAs along a row."""
        return [self.unroll if self.path == "vector" else 0, self.ctas_x]


def launch_plan(numel: int, dtype: torch.dtype,
                rowmap: tuple[int, int, int, int] | None = None, aligned: bool = True,
                base: int = 0, *, sms: int = H100_SXM_SMS, unroll: int | None = None,
                ctas_x: int | None = None) -> LaunchPlan:
    """The launch of either pass over `numel` elements of `dtype` whose
    global indices start at `base` (with `rowmap` = (h_local, h_global, h0,
    wc), a shard of image rows; `row_map`), from data that is 16-byte
    aligned or not (`aligned`: the inputs' addresses, x and in the backward
    g; the output is allocated aligned), on a card of `sms` SMs.

    - path: "vector" when the data is aligned, there is at least one
      vector, the first global index is a multiple of the vector (so every
      vector's elements share fmix32's upper half), and on a shard each row
      and its global stride are whole vectors (W*C a multiple of 8 bf16 or
      4 float32, as at every site with C >= 64); else "scalar".
    - unroll: 4 when the launch at 4 vectors a thread still has
      DEEP_WAVES waves (sms * CTAS_PER_SM CTAs each) of CTAs, else 2, so
      that a smaller tensor spreads over more CTAs. The bits do not depend
      on it, nor on the SM count.
    - ctas_x: one CTA for each THREADS * unroll vectors (or THREADS
      elements) of a row, each making a single trip: on the H100 such
      grids ran 4-5% faster than one persistent wave walking the tensor
      (tools/dropout_times.py --sweep), level with a `copy_` of the bytes.

    `unroll` and `ctas_x` override the choice (the timing tool's sweep);
    with fewer CTAs than the single trips, each walks its row."""
    if dtype not in _ELEMENT_SIZE:
        raise TypeError(f"the kernels take float32 or bfloat16, got {dtype}")
    if not 0 <= numel < 2**32:
        raise ValueError(f"element count {numel} outside [0, 2**32)")
    if unroll is not None and unroll not in UNROLLS:
        raise ValueError(f"unroll must be one of {UNROLLS}, got {unroll}")
    if ctas_x is not None and ctas_x < 1:
        raise ValueError(f"ctas_x must be >= 1, got {ctas_x}")
    h, h_global, h0, wc = rowmap or (1, 1, 0, max(numel, 1))
    if h < 1 or wc < 1 or h0 < 0 or h0 + h > h_global or numel % (h * wc):
        raise ValueError(f"row block {rowmap} does not fit {numel} elements")
    if h == h_global:  # a whole map: one contiguous row
        rows, row_len, row_stride = 1, numel, numel
    else:
        rows, row_len, row_stride = numel // (h * wc), h * wc, h_global * wc
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} rows exceed a launch's {MAX_ROWS}")
    first = base + h0 * wc
    vec = VECTOR_BYTES // _ELEMENT_SIZE[dtype]
    vector = (aligned and numel >= vec and first % vec == 0
              and (rows == 1 or (row_len % vec == 0 and row_stride % vec == 0)))
    if vector:
        vectors = row_len // vec
        if unroll is None:
            deep = rows * -(-vectors // (THREADS * 4))
            unroll = 4 if deep >= DEEP_WAVES * sms * CTAS_PER_SM else 2
        items, tail = vectors, row_len - vectors * vec
    else:
        vec = unroll = 1
        items, tail = row_len, 0
    if ctas_x is None:
        ctas_x = max(1, -(-items // (THREADS * unroll)))
    return LaunchPlan(path="vector" if vector else "scalar", vec=vec, unroll=unroll,
                      rows=rows, row_len=row_len, tail=tail, ctas_x=ctas_x)


# ------------------------------------------------------------------- kernel
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# n, base, h_local, h_global, h0, wc, cut, scale, slope
_ARGS = [ctypes.c_int64] + [ctypes.c_uint32] * 6 + [ctypes.c_float, ctypes.c_float]


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, its entry points typed once per process."""
    lib = native.load("leaky_relu_dropout")
    for suffix in _DTYPES.values():
        # x (and g), the output and kw; _ARGS; the plan's unroll and CTAs
        # along a row; the stream
        for part, pointers in (("fwd", 3), ("bwd", 4)):
            fn = getattr(lib, f"lrd_{part}_{suffix}")
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * pointers + _ARGS
                           + [ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p])
    return lib


def index_extent(x: torch.Tensor, hblock: tuple[int, int] | None) -> int:
    """The global indices a shard spans from its base: its element count, or
    for a row block up to the end of its last image row."""
    rowmap = row_map(x, hblock)
    if rowmap is None:
        return x.numel()
    h, h_global, h0, wc = rowmap
    return (x.shape[0] - 1) * h_global * wc + (h0 + h) * wc


def check_index_range(numel: int, base: int, total: int | None) -> int:
    """The global element count (`total`, default base + numel), checked:
    the shard's span [base, base + numel) lies inside it, and it is below
    2**32, since the mask's index is uint32."""
    total = base + numel if total is None else total
    if base < 0 or base + numel > total:
        raise ValueError(f"shard [{base}, {base + numel}) outside the {total} elements")
    if total >= 2**32:
        raise ValueError(
            f"the uint32 element index covers < 2**32 elements of the global "
            f"batch, got {total}")
    return total


def _check_kernel_args(x: torch.Tensor, kw: torch.Tensor, base: int,
                       total: int | None, hblock: tuple[int, int] | None) -> tuple:
    """The kernel's (base, h_local, h_global, h0, wc), checked."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {x.device}")
    _check_channels_last(x)
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    check_index_range(index_extent(x, hblock), base, total)
    if (kw.device != x.device or kw.dtype != torch.int64
            or kw.shape != (2,) or not kw.is_contiguous()):
        raise ValueError(
            f"kw must be a contiguous int64 (2,) tensor on {x.device}, got "
            f"{kw.dtype} {tuple(kw.shape)} on {kw.device}"
        )
    _, c, h, w = x.shape
    return (base, *(row_map(x, hblock) or (h, h, 0, w * c)))


def plan_for(x: torch.Tensor, inputs: tuple[torch.Tensor, ...], base: int,
             hblock: tuple[int, int] | None, sms: int) -> LaunchPlan:
    """`launch_plan` for a pass over x that reads `inputs` (the forward x,
    the backward x and g) on a card of `sms` SMs."""
    aligned = all(t.data_ptr() % VECTOR_BYTES == 0 for t in inputs)
    return launch_plan(x.numel(), x.dtype, row_map(x, hblock), aligned, base, sms=sms)


def fwd_kernel(x: torch.Tensor, kw: torch.Tensor, cut: int, base: int = 0,
               total: int | None = None, hblock: tuple[int, int] | None = None,
               plan: LaunchPlan | None = None) -> torch.Tensor:
    """The forward kernel, launched from `plan` (default: `launch_plan` for
    x; another plan must be one x allows, or the entry point refuses it)."""
    index = _check_kernel_args(x, kw, base, total, hblock)
    lib = _lib()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if plan is None:
        plan = plan_for(x, (x,), base, hblock, sm_count(x.device.index))
    rc = getattr(lib, f"lrd_fwd_{_DTYPES[x.dtype]}")(
        x.data_ptr(), y.data_ptr(), kw.data_ptr(), x.numel(), *index, cut,
        keep_scale(cut), NEGATIVE_SLOPE, *plan.args(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    native.check(lib, "lrd_error_string", rc, "leaky_relu_dropout forward")
    LAUNCHES["leaky_relu_dropout_fwd"] += 1
    FWD_PATHS[plan.path] += 1
    return y


def bwd_kernel(
    x: torch.Tensor, g: torch.Tensor, kw: torch.Tensor, cut: int, base: int = 0,
    total: int | None = None, hblock: tuple[int, int] | None = None,
    plan: LaunchPlan | None = None,
) -> torch.Tensor:
    """The backward kernel, launched from `plan` (default: `launch_plan` for
    x and g; another plan must be one they allow, or the entry point
    refuses it)."""
    index = _check_kernel_args(x, kw, base, total, hblock)
    if g.dtype != x.dtype or g.shape != x.shape or g.device != x.device:
        raise ValueError("gradient must match x in dtype, shape and device")
    _check_channels_last(g)
    lib = _lib()
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    if plan is None:
        plan = plan_for(x, (x, g), base, hblock, sm_count(x.device.index))
    rc = getattr(lib, f"lrd_bwd_{_DTYPES[x.dtype]}")(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), kw.data_ptr(), x.numel(),
        *index, cut, keep_scale(cut), NEGATIVE_SLOPE, *plan.args(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    native.check(lib, "lrd_error_string", rc, "leaky_relu_dropout backward")
    LAUNCHES["leaky_relu_dropout_bwd"] += 1
    BWD_PATHS[plan.path] += 1
    return dx


# ------------------------------------------------------------------ wrapper
def _check_channels_last(x: torch.Tensor) -> None:
    # The mask is indexed by memory offset; only a channels_last tensor has
    # its NHWC linear index there. Any other layout would silently draw a
    # different mask, so it is refused.
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(
            "leaky_relu_dropout needs a 4-D channels_last-contiguous tensor "
            f"(NCHW logical, NHWC memory); got shape {tuple(x.shape)} "
            f"strides {x.stride()}"
        )


def fwd(x: torch.Tensor, kw: torch.Tensor, cut: int, base: int = 0,
        total: int | None = None, hblock: tuple[int, int] | None = None) -> torch.Tensor:
    """Forward: the plain version for a CPU tensor, else the kernel."""
    if x.device.type == "cpu":
        check_index_range(index_extent(x, hblock), base, total)
        return fwd_plain(x, kw, cut, base, hblock)
    return fwd_kernel(x, kw, cut, base, total, hblock)


def bwd(x: torch.Tensor, g: torch.Tensor, kw: torch.Tensor, cut: int, base: int = 0,
        total: int | None = None, hblock: tuple[int, int] | None = None) -> torch.Tensor:
    """Backward: the plain version for a CPU tensor, else the kernel."""
    if x.device.type == "cpu":
        check_index_range(index_extent(x, hblock), base, total)
        return bwd_plain(x, g, kw, cut, base, hblock)
    return bwd_kernel(x, g, kw, cut, base, total, hblock)


class _LeakyReluDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kw, cut, base, total, hblock):
        ctx.save_for_backward(x, kw)
        ctx.cut, ctx.base, ctx.total, ctx.hblock = cut, base, total, hblock
        return fwd(x, kw, cut, base, total, hblock)

    @staticmethod
    def backward(ctx, g):
        x, kw = ctx.saved_tensors
        g = g.contiguous(memory_format=torch.channels_last)
        dx = bwd(x, g, kw, ctx.cut, ctx.base, ctx.total, ctx.hblock)
        return dx, None, None, None, None, None


def leaky_relu_dropout(
    x: torch.Tensor, kw: torch.Tensor, rate: float,
    rows: tuple[int, int] | None = None, hblock: tuple[int, int] | None = None,
) -> torch.Tensor:
    """dropout(leaky_relu(x, 0.1)) with the hash1 mask of key words `kw`.

    x: (B, C, H, W) channels_last, float32 or bfloat16 (float64 on the CPU).
    kw: (2,) int64 holding two uint32 words, on x's device. rows: (first
    row, global batch) when x holds rows [first, first + B) of a larger
    batch (a data-parallel rank); hblock: (h0, global height) when x holds
    image rows [h0, h0 + H) of a taller map (a spatial shard). The mask is
    then the whole array's, at x's global indices."""
    _check_channels_last(x)
    base, total = 0, None
    if rows is not None or hblock is not None:
        first, global_rows = rows or (0, x.shape[0])
        h_global = None if hblock is None else hblock[1]
        base = rows_base(x, first, h_global)
        total = rows_base(x, global_rows, h_global)
    return _LeakyReluDropout.apply(x, kw, dropout_cut(rate), base, total, hblock)
