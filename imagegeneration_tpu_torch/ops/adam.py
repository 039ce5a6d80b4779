"""Keras-form Adam apply over a list of float32 leaves: one kernel launch
per apply, in place; the moments m and v float32 or bfloat16.

Replaces the TPU kernel of imagegeneration_tpu/ops/pallas/adam.py
(`_kernel` behind `fused_adam_leaf`, one leaf per call):

    m' = b1*m + (1-b1)*g
    v' = b2*v + (1-b2)*g*g
    p' = p + (-alpha*m') / (sqrt(v') + eps),   alpha = lr*sqrt(1-b2^t)/(1-b1^t)

eps sits outside the sqrt and the bias correction rides in alpha, as in
tf.keras (imagegeneration_tpu/train/common.py). alpha is computed in float32
on the device from the device step counter and read by the kernel from
device memory, so an apply never syncs the host.

bfloat16 moments (`opt_moments="bf16"`, the JAX package's
`moment_dtype=jnp.bfloat16`, which its Pallas kernel never sees: it takes
the inline XLA formula, imagegeneration_tpu/train/common.py:125-138) are
read as float32, updated in float32, the parameter update taken from the
float32 values, and stored rounded to nearest even.

On the H100 the apply is bound by device-memory bandwidth: 28 bytes per
element (read p, g, m, v; write p, m, v), 20 with bfloat16 moments. The
kernel (`csrc/adam.cu`) makes that one pass over every leaf of the list in
one launch, with 16-byte loads over each leaf's aligned body (8-byte ones
for bfloat16 moments), and updates p, m and v in place, so the optimizer
holds one copy of its state:

- `launch_groups` is the launch plan, computed here and only checked by the
  kernel: each leaf's 4-element body (from its first element at which p
  and g are 16-byte aligned and m and v 4 elements' aligned: 16 bytes as
  float32, 8 as bfloat16; in whole quads; empty when the four disagree), its
  chunks of CHUNK elements counted from the body's start, and the groups
  of at most TABLE_LEAVES leaves, one launch each.
- `LeafTable` checks p, m and v once (device, dtype, shape, one dense
  layout) and keeps the kernel's parameter tables filled but for g's
  pointers; an apply checks each g and makes one ctypes call per group.
- `adam_apply` brings a g whose strides differ from p's to p's layout (one
  copy, counted in GRAD_COPIES; conv weights, their moments and the
  gradients cuDNN returns share channels_last, so the headline steps make
  none).

The kernel rounds every operation explicitly (no FMA contraction), so it
evaluates the same float32 expressions as `adam_leaf_plain`, which a CPU
tensor takes leaf by leaf. A CUDA tensor launches the kernel or raises.
`LAUNCHES` counts the float32-moment form's launches (`adam_multi_f32`),
`BF16_LAUNCHES` the bfloat16-moment form's (`adam_multi_bf16`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import torch

from imagegeneration_tpu_torch.ops import native

KERAS_EPS = 1e-7

LAUNCHES = {"adam": 0}
BF16_LAUNCHES = {"adam_bf16": 0}
GRAD_COPIES = {"adam": 0}
MOMENT_DTYPES = (torch.float32, torch.bfloat16)

CHUNK = 4096  # elements per chunk, counted from a leaf's body (a multiple of 4)
TABLE_LEAVES = 512  # leaves per launch (kMaxLeaves in csrc/adam.cu)
PARAM_LIMIT = 32764  # kernel-parameter bytes CUDA 12.1+ takes on sm_70+
_VEC = 4  # floats per 16-byte load


def adam_alpha(count: torch.Tensor, lr: float, b1: float, b2: float) -> torch.Tensor:
    """lr * sqrt(1 - b2^t) / (1 - b1^t) as a float32 (1,) tensor on count's
    device (t = count, already incremented)."""
    t = count.to(torch.float32).reshape(1)
    return lr * torch.sqrt(1.0 - torch.pow(b2, t)) / (1.0 - torch.pow(b1, t))


def adam_leaf_plain(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
    alpha: torch.Tensor, b1: float, b2: float, eps: float = KERAS_EPS,
) -> None:
    """One leaf in place. m and v may be bfloat16 (both): read as float32,
    updated and used in float32, stored rounded to nearest even."""
    m_new = b1 * m.float() + (1.0 - b1) * g
    v_new = b2 * v.float() + (1.0 - b2) * (g * g)
    # float32 sqrt correctly rounded, as __fsqrt_rn and XLA give it: the
    # vectorized CPU torch.sqrt can be off by an ulp; a float64 sqrt
    # rounded to float32 never is.
    sqrt_v = torch.sqrt(v_new.double()).float()
    p_new = p + (-alpha * m_new) / (sqrt_v + eps)
    m.copy_(m_new)
    v.copy_(v_new)
    p.copy_(p_new)


def adam_plain(
    params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
    m: Sequence[torch.Tensor], v: Sequence[torch.Tensor],
    alpha: torch.Tensor, b1: float, b2: float, eps: float = KERAS_EPS,
) -> None:
    """`adam_leaf_plain` on every leaf of the lists."""
    for p, g, mi, vi in zip(params, grads, m, v, strict=True):
        adam_leaf_plain(p, g, mi, vi, alpha, b1, b2, eps)


# -------------------------------------------------------------- launch plan
@dataclasses.dataclass(frozen=True)
class LeafSpan:
    """One leaf of a launch: n elements; [body_begin, body_end) moves in
    quads (empty: body_begin = body_end = 0); `chunks` chunks."""

    n: int
    body_begin: int
    body_end: int
    chunks: int


def leaf_span(n: int, addresses: Sequence[int], chunk: int = CHUNK,
              moment_bytes: int = 4) -> LeafSpan:
    """The span of a leaf of n elements whose p, g (float32), m and v
    (`moment_bytes` wide: 4 float32, 2 bfloat16) start at `addresses`. The
    body starts at the first element whose address is a multiple of four
    elements' bytes in all four tensors (16 for float32, 8 for bfloat16),
    so each must sit at the same element phase of that width, and holds
    whole quads; the chunks cover the elements from the body's start."""
    widths = (4, 4, moment_bytes, moment_bytes)
    rems = [a % (_VEC * w) for a, w in zip(addresses, widths)]
    phases = {r // w for r, w in zip(rems, widths)}
    aligned = len(phases) == 1 and all(r % w == 0 for r, w in zip(rems, widths))
    head = (_VEC - phases.pop()) % _VEC if aligned else 0
    if not aligned or n - head < _VEC:
        head, quads = 0, 0
    else:
        quads = (n - head) // _VEC
    return LeafSpan(n=n, body_begin=head, body_end=head + quads * _VEC,
                    chunks=max(1, -(-(n - head) // chunk)))


def chunk_bounds(span: LeafSpan, k: int, chunk: int = CHUNK) -> tuple[int, int, int, int]:
    """(start, vec_start, vec_stop, stop) of chunk k of a leaf, as the kernel
    computes them: [start, vec_start) and [vec_stop, stop) are scalar,
    [vec_start, vec_stop) whole quads of the body."""
    start = 0 if k == 0 else span.body_begin + k * chunk
    stop = span.n if k == span.chunks - 1 else span.body_begin + (k + 1) * chunk
    vec_start = max(start, span.body_begin)
    vec_stop = max(vec_start, min(stop, span.body_end))
    return start, vec_start, vec_stop, stop


@dataclasses.dataclass(frozen=True)
class Group:
    """The leaves of one launch: their positions in the list, their spans,
    and the prefix of their chunk counts (`first_chunk[-1]` chunks in all)."""

    leaves: tuple[int, ...]
    spans: tuple[LeafSpan, ...]
    first_chunk: tuple[int, ...]


def launch_groups(
    numels: Sequence[int], addresses: Sequence[Sequence[int]],
    table_leaves: int = TABLE_LEAVES, chunk: int = CHUNK, moment_bytes: int = 4,
) -> list[Group]:
    """The launches of one apply: the non-empty leaves in list order, in
    groups of at most `table_leaves`. `addresses[i]` are the data pointers
    of leaf i's p, g, m and v; m and v are `moment_bytes` wide. An empty
    list is no launch."""
    if chunk < _VEC or chunk % _VEC:
        raise ValueError(f"chunk must be a positive multiple of {_VEC}, got {chunk}")
    if not 1 <= table_leaves <= TABLE_LEAVES:
        raise ValueError(f"a table holds 1 to {TABLE_LEAVES} leaves, not {table_leaves}")
    spans = [(i, leaf_span(n, a, chunk, moment_bytes)) for i, (n, a) in
             enumerate(zip(numels, addresses, strict=True)) if n > 0]
    groups = []
    for at in range(0, len(spans), table_leaves):
        part = spans[at:at + table_leaves]
        prefix = [0]
        for _, s in part:
            prefix.append(prefix[-1] + s.chunks)
        if prefix[-1] >= 2**31:
            raise ValueError("a launch covers fewer than 2**31 chunks")
        groups.append(Group(leaves=tuple(i for i, _ in part),
                            spans=tuple(s for _, s in part), first_chunk=tuple(prefix)))
    return groups


# ------------------------------------------------------------------ kernel
_L = TABLE_LEAVES


class AdamTable(ctypes.Structure):
    """The kernel's parameters (`AdamTable` in csrc/adam.cu, field for field,
    padding explicit; `_lib` checks the offsets against the library's)."""

    _fields_ = [
        ("alpha", ctypes.c_void_p),
        ("b1", ctypes.c_float), ("b2", ctypes.c_float),
        ("one_minus_b1", ctypes.c_float), ("one_minus_b2", ctypes.c_float),
        ("eps", ctypes.c_float),
        ("leaves", ctypes.c_int32), ("chunk", ctypes.c_int32), ("pad0", ctypes.c_int32),
        ("p", ctypes.c_void_p * _L), ("g", ctypes.c_void_p * _L),
        ("m", ctypes.c_void_p * _L), ("v", ctypes.c_void_p * _L),
        ("n", ctypes.c_int64 * _L), ("body_end", ctypes.c_int64 * _L),
        ("body_begin", ctypes.c_int32 * _L), ("first_chunk", ctypes.c_int32 * (_L + 1)),
        ("pad1", ctypes.c_int32),
    ]


def table_layout() -> list[int]:
    """AdamTable's field offsets in declaration order, then its size."""
    return [getattr(AdamTable, name).offset for name, _ in AdamTable._fields_] + [
        ctypes.sizeof(AdamTable)]


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, its entry points typed and its table layout
    checked against ctypes' once per process."""
    lib = native.load("adam")
    for entry in (lib.adam_multi_f32, lib.adam_multi_bf16):
        entry.restype = ctypes.c_int
        entry.argtypes = [ctypes.POINTER(AdamTable), ctypes.c_void_p]
    lib.adam_grid_ctas.restype = ctypes.c_int
    lib.adam_grid_ctas.argtypes = [ctypes.c_int]
    lib.adam_table_layout.restype = ctypes.c_int
    lib.adam_table_layout.argtypes = [ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    want = table_layout()
    got = (ctypes.c_int64 * len(want))()
    count = lib.adam_table_layout(got, len(want))
    if count != len(want) or list(got) != want:
        raise RuntimeError(f"csrc/adam.cu's AdamTable layout {list(got)[:count]} differs "
                           f"from the ctypes mirror {want}")
    return lib


def grid_ctas(moments: torch.dtype = torch.float32) -> int:
    """CTAs of the persistent grid of the kernel's form for these moments
    on the current device."""
    n = _lib().adam_grid_ctas(int(moments == torch.bfloat16))
    if n < 0:
        native.check(_lib(), "adam_error_string", -n, "adam occupancy query")
    return n


def _same_layout(t: torch.Tensor, shape: torch.Size, stride: tuple[int, ...]) -> bool:
    """Whether t (of `shape`) has these strides on every dimension of size
    > 1: then it walks its elements in the same memory order."""
    return all(a == b for size, a, b in zip(shape, t.stride(), stride) if size > 1)


def _dense(t: torch.Tensor) -> bool:
    """Whether t's elements fill numel() consecutive floats (any order of
    dimensions): the kernel walks a leaf as one flat array."""
    expect = 1
    for stride, size in sorted((st, s) for s, st in zip(t.shape, t.stride()) if s > 1):
        if stride != expect:
            return False
        expect *= size
    return True


class LeafTable:
    """p, m and v of one optimizer state on the card, checked once (CUDA;
    p float32, m and v all float32 or all bfloat16; shapes; one dense layout
    shared by each leaf's three), and the kernel's parameter tables for them
    with every entry but g's pointer filled.

    p, m and v must keep their storage (the optimizer state copies into
    them in place); `adam_apply` checks p's pointers on every apply."""

    def __init__(self, params: Sequence[torch.Tensor], m: Sequence[torch.Tensor],
                 v: Sequence[torch.Tensor], chunk: int = CHUNK) -> None:
        if not params or not (len(params) == len(m) == len(v)):
            raise ValueError("params, m and v must be non-empty and of equal length")
        self.device = params[0].device
        self.moment_dtype = m[0].dtype
        if self.moment_dtype not in MOMENT_DTYPES:
            raise ValueError(f"adam kernel: moments must be float32 or bfloat16, got "
                             f"{self.moment_dtype}")
        for name, ts, dtype in (("p", params, torch.float32), ("m", m, self.moment_dtype),
                                ("v", v, self.moment_dtype)):
            for t, p in zip(ts, params):
                if t.device != self.device or t.device.type != "cuda":
                    raise ValueError(f"adam kernel: {name} must be on the CUDA device of p")
                if t.dtype != dtype:
                    raise ValueError(f"adam kernel: {name} must be {dtype}, got {t.dtype}")
                if t.shape != p.shape or not _same_layout(t, p.shape, p.stride()):
                    raise ValueError(
                        f"adam kernel: {name} shape {tuple(t.shape)} strides {t.stride()} "
                        f"!= p's {tuple(p.shape)} {p.stride()}")
                if not _dense(t):
                    raise ValueError(f"adam kernel: {name} strides {t.stride()} are not "
                                     "one dense block")
        self.params, self.m, self.v = list(params), m, v
        self.layouts = [(p.shape, p.stride()) for p in params]
        self.numels = [p.numel() for p in params]
        self.p_ptrs = [p.data_ptr() for p in params]
        self.m_ptrs = [t.data_ptr() for t in m]
        self.v_ptrs = [t.data_ptr() for t in v]
        self.chunk = chunk
        # Planned as if each g were aligned as its p: fresh gradients start
        # a PyTorch allocation, as fresh parameters do.
        self.launches = self.plan(self.p_ptrs)

    def plan(self, g_ptrs: Sequence[int]) -> list[tuple[Group, AdamTable]]:
        """The groups for these g pointers, each with its filled table."""
        groups = launch_groups(
            self.numels, list(zip(self.p_ptrs, g_ptrs, self.m_ptrs, self.v_ptrs)),
            chunk=self.chunk, moment_bytes=self.moment_dtype.itemsize)
        return [(group, fill_table(group, self.p_ptrs, self.m_ptrs, self.v_ptrs, self.chunk))
                for group in groups]


def fill_table(group: Group, p_ptrs: Sequence[int], m_ptrs: Sequence[int],
               v_ptrs: Sequence[int], chunk: int = CHUNK) -> AdamTable:
    """One launch's table: everything but g's pointers and the scalars."""
    t = AdamTable()
    t.leaves, t.chunk = len(group.leaves), chunk
    for j, (i, span) in enumerate(zip(group.leaves, group.spans)):
        t.p[j], t.m[j], t.v[j] = p_ptrs[i], m_ptrs[i], v_ptrs[i]
        t.n[j], t.body_begin[j], t.body_end[j] = span.n, span.body_begin, span.body_end
    t.first_chunk[:len(group.first_chunk)] = group.first_chunk
    return t


def adam_kernel(
    table: LeafTable, grads: Sequence[torch.Tensor], alpha: torch.Tensor,
    b1: float, b2: float, eps: float = KERAS_EPS,
) -> None:
    """One launch per group of `table`, of the kernel's form for its moments:
    g must match p in device, dtype, shape and memory order."""
    if len(grads) != len(table.numels):
        raise ValueError(f"adam kernel: {len(grads)} grads for {len(table.numels)} leaves")
    if alpha.device != table.device or alpha.dtype != torch.float32 or alpha.numel() != 1:
        raise ValueError("adam kernel: alpha must be one float32 on the leaves' device")
    g_ptrs = []
    device = table.device
    for g, (shape, stride) in zip(grads, table.layouts):
        if g.dtype is not torch.float32 or g.device != device or g.shape != shape:
            raise ValueError(
                f"adam kernel: g must be float32 {tuple(shape)} on {device}, got "
                f"{g.dtype} {tuple(g.shape)} on {g.device}")
        if g.stride() != stride and not _same_layout(g, shape, stride):
            raise ValueError(f"adam kernel: g strides {g.stride()} != p's {stride}")
        g_ptrs.append(g.data_ptr())
    launches = table.launches
    if any((a - b) % 16 for a, b in zip(g_ptrs, table.p_ptrs)):
        launches = table.plan(g_ptrs)  # a g aligned unlike its p: that leaf goes scalar
    if not launches:
        return
    lib = _lib()
    if table.moment_dtype == torch.bfloat16:
        entry, counts, key = lib.adam_multi_bf16, BF16_LAUNCHES, "adam_bf16"
    else:
        entry, counts, key = lib.adam_multi_f32, LAUNCHES, "adam"
    stream = torch.cuda.current_stream(table.device).cuda_stream
    for group, t in launches:
        t.g[:len(group.leaves)] = [g_ptrs[i] for i in group.leaves]
        t.alpha = alpha.data_ptr()
        t.b1, t.b2, t.one_minus_b1, t.one_minus_b2, t.eps = b1, b2, 1.0 - b1, 1.0 - b2, eps
        rc = entry(ctypes.byref(t), stream)
        native.check(lib, "adam_error_string", rc, "adam apply")
        counts[key] += 1


def _in_layout(g: torch.Tensor, shape: torch.Size, stride: tuple[int, ...]) -> torch.Tensor:
    """g itself, or, if its memory order differs from p's, one copy of it in
    p's layout (counted in GRAD_COPIES). A g the kernel refuses anyway
    (dtype, shape) is passed on for `adam_kernel` to raise."""
    if (g.stride() == stride or g.dtype is not torch.float32 or g.shape != shape
            or _same_layout(g, shape, stride)):
        return g
    GRAD_COPIES["adam"] += 1
    return torch.empty_strided(shape, stride, dtype=g.dtype, device=g.device).copy_(g)


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
    table: LeafTable | None = None,
) -> None:
    """One Keras-form Adam step over lists of float32 leaves (float32 or
    bfloat16 moments), in place.

    `count` (0-d integer tensor on the leaves' device) is incremented first,
    as optax's safe_increment does, and alpha is derived from it. On the
    card the leaves go through `table` (built for these params, m and v;
    a new one when None) in one launch per group."""
    if not (len(params) == len(grads) == len(m) == len(v)):
        raise ValueError("params, grads, m and v must have equal length")
    count.add_(1)
    alpha = adam_alpha(count, lr, b1, b2)
    if not params or params[0].device.type == "cpu":
        adam_plain(params, grads, m, v, alpha, b1, b2)
        return
    if table is None:
        table = LeafTable(params, m, v)
    elif table.m is not m or table.v is not v or [p.data_ptr() for p in params] != table.p_ptrs:
        raise ValueError("adam: the leaf table was built for other tensors")
    grads = [_in_layout(g, shape, stride) for g, (shape, stride) in zip(grads, table.layouts)]
    adam_kernel(table, grads, alpha, b1, b2)
