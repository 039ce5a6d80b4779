"""Halo exchanges between the spatial peers of an H-partitioned activation.

Under a (data, spatial) mesh (core/mesh.py) each rank holds rows [s*h,
(s+1)*h) of every image-height axis, h = H / spatial. A conv over the
whole map needs, at each shard's edges, the rows its neighbours hold: the
JAX package leaves that to XLA's partitioner, the port exchanges them by
hand.

`halo(x, lo, hi, group)` returns the rank's block with `lo` rows of its
upper neighbour (s - 1) above it and `hi` rows of its lower neighbour
(s + 1) below it; at the global top and bottom edges those rows are zeros,
the SAME padding of a conv over the whole map. Its backward is the
adjoint exchange: the cotangents of the halo rows go back to the
neighbours that own those rows, and each rank adds them onto its edge
rows. Each of the two is the other's backward, so the exchange is
differentiable again (WGAN-GP's double backward).

Both directions are one `all_gather_into_tensor` over the spatial group:
each rank contributes one slot (the edge rows its neighbours read, or the
halo cotangents it owes them) and reads its neighbours' slots. On the card
gloo runs all_gather on CUDA tensors (ranks sharing one card, through the
host) as it runs all_reduce and broadcast, while its send/recv fail there
("Bad address", PERF.md §6); NCCL runs all four on the card. So the same
code runs on both backends, and the exchange moves each slot once to every
spatial peer: with 2 spatial ranks, exactly a neighbour-to-neighbour
exchange.

Each exchange, either direction, counts one in `group.counts["halo"]`.

`gather_rows(x, group)` is the other movement of rows: the whole map from
every spatial peer's block, for a model that runs whole on each peer (the
CycleGAN PatchGAN, whose VALID maps do not tile). Its backward keeps the
rank's own rows of the whole map's cotangent and sums nothing: every peer
holds the same whole cotangent (the identity rule of dp.spatial_sum). It
counts one in `group.counts["row_gather"]`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from imagegeneration_tpu_torch.core.mesh import DataGroup


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _exchange(slots: list[tuple[torch.Tensor, int, int]], rows: int, like: torch.Tensor,
              group: DataGroup) -> torch.Tensor:
    """All-gather over the spatial group each rank's (B, rows, W, C) slot
    holding its `slots` (each a (B, n, W, C) tensor at row offset `at`;
    zeros elsewhere): a (spatial, B, rows, W, C) tensor, slot s rank s's."""
    b, _, w, c = like.shape
    mine = like.new_zeros((b, rows, w, c))
    for t, at, n in slots:
        mine[:, at:at + n] = t
    buf = like.new_empty((group.spatial * b, rows, w, c))  # the slots along dim 0
    dist.all_gather_into_tensor(buf, mine, group=group.pg_of("spatial"))
    group.counts["halo"] += 1
    return buf.view(group.spatial, b, rows, w, c)


def _halo_forward(x: torch.Tensor, lo: int, hi: int, group: DataGroup) -> torch.Tensor:
    """(B, C, h, W) -> (B, C, lo + h + hi, W), channels_last."""
    xn = _nhwc(x)
    b, h, w, c = xn.shape
    if lo > h or hi > h:
        raise ValueError(f"a halo of ({lo}, {hi}) rows needs >= as many rows per shard, got {h}")
    s, last = group.s, group.spatial - 1
    # slot: [my top `hi` rows (the upper neighbour's bottom halo) | my bottom `lo` rows]
    buf = _exchange([(xn[:, :hi], 0, hi), (xn[:, h - lo:], hi, lo)], lo + hi, xn, group)
    top = buf[s - 1, :, hi:] if s > 0 else xn.new_zeros((b, lo, w, c))
    bottom = buf[s + 1, :, :hi] if s < last else xn.new_zeros((b, hi, w, c))
    return torch.cat([top, xn, bottom], dim=1).contiguous().permute(0, 3, 1, 2)


def _halo_adjoint(g: torch.Tensor, lo: int, hi: int, group: DataGroup) -> torch.Tensor:
    """(B, C, lo + h + hi, W) -> (B, C, h, W): the own rows' cotangents plus
    the halo cotangents of the neighbours that read them."""
    gn = _nhwc(g)
    b, n, w, c = gn.shape
    h = n - lo - hi
    s, last = group.s, group.spatial - 1
    # slot: [my top halo's cotangent (for s - 1) | my bottom halo's (for s + 1)];
    # at the global edges the halo is padding and its cotangent is dropped.
    slots = []
    if s > 0:
        slots.append((gn[:, :lo], 0, lo))
    if s < last:
        slots.append((gn[:, lo + h:], lo, hi))
    buf = _exchange(slots, lo + hi, gn, group)
    dx = gn[:, lo:lo + h].clone()
    if s < last and lo:
        dx[:, h - lo:] += buf[s + 1, :, :lo]
    if s > 0 and hi:
        dx[:, :hi] += buf[s - 1, :, lo:]
    return dx.permute(0, 3, 1, 2)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi, group):
        ctx.lo, ctx.hi, ctx.group = lo, hi, group
        return _halo_forward(x, lo, hi, group)

    @staticmethod
    def backward(ctx, g):
        return _HaloAdjoint.apply(g, ctx.lo, ctx.hi, ctx.group), None, None, None


class _HaloAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, lo, hi, group):
        ctx.lo, ctx.hi, ctx.group = lo, hi, group
        return _halo_adjoint(g, lo, hi, group)

    @staticmethod
    def backward(ctx, gg):
        return _Halo.apply(gg, ctx.lo, ctx.hi, ctx.group), None, None, None


def halo(x: torch.Tensor, lo: int, hi: int, group: DataGroup) -> torch.Tensor:
    """This rank's (B, C, h, W) block of an H-partitioned map with `lo` rows
    of the upper neighbour above it and `hi` rows of the lower one below
    (zeros at the global edges): (B, C, lo + h + hi, W), channels_last.
    Differentiable, and so is its backward."""
    return _Halo.apply(x, lo, hi, group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        xn = _nhwc(x).contiguous()
        b, h, w, c = xn.shape
        buf = xn.new_empty((group.spatial * b, h, w, c))  # the blocks along dim 0
        dist.all_gather_into_tensor(buf, xn, group=group.pg_of("spatial"))
        group.counts["row_gather"] += 1
        whole = buf.view(group.spatial, b, h, w, c).transpose(0, 1)
        return whole.reshape(b, group.spatial * h, w, c).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        h = g.shape[2] // ctx.group.spatial
        return g[:, :, ctx.group.s * h:(ctx.group.s + 1) * h], None


def gather_rows(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """The whole (B, C, spatial * h, W) map, channels_last, from every
    spatial peer's (B, C, h, W) block, in row order. Backward: this rank's
    rows of the cotangent, which every peer holds whole."""
    return _GatherRows.apply(x, group)
