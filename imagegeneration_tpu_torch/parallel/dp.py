"""Data x spatial training by hand: one process per card, explicit collectives.

The counterpart of imagegeneration_tpu/parallel/dp.py. The JAX package
jits its steps over a (data, spatial) mesh with the state replicated, the
batch sharded on N over "data" and (optionally) on H over "spatial", and
XLA's partitioner inserts the collectives. The port runs one process per
card and writes them: `all_reduce` and `broadcast` here and
`all_gather_into_tensor` for the halo (parallel/halo.py), collectives that
gloo also runs on CUDA tensors (through the host; its send/recv fail
there), so that the same code runs over NCCL across cards, over gloo on
one card and over gloo on the CPU.

Semantics: those of the JAX package's TESTS, not of its docstring. A step
over a global batch of B on data x spatial ranks equals the one-device step
on that batch (tests/test_parallel.py, the float64 multi-step tests,
compare the final state leaf by leaf). So:

- every rank holds the same state (`replicate_state` broadcasts it from
  rank 0 and checks a digest of every byte);
- a rank's batch is its block d of B / data rows (core/mesh.
  process_row_range) and, under a spatial partition, its block s of H /
  spatial image rows (core/mesh.spatial_row_range); random draws (the
  latents, WGAN-GP's interpolation weights) are made for the global batch
  from a stream seeded alike on every rank, and each rank keeps its rows;
  the dropout mask is keyed by the global element index;
- convs exchange the rows their kernels read across a shard's edge with
  the spatial neighbours (parallel/halo.py);
- BatchNorm takes GLOBAL batch statistics (`all_reduce_sum`,
  differentiable; nn/layers.BatchNorm), where the JAX docstring says
  "non-sync": under jit over a global array flax's mean is over the global
  batch. Statistics of an H-partitioned map sum over the world; those of
  a map with no H axis (the generator's Dense stem, held whole by every
  spatial peer) over the data group only;
- a value whose terms are spread over the spatial peers and that every
  peer then holds whole (the head's logits from the peers' blocks of the
  flattened map; WGAN-GP's per-image squared gradient norm) is summed over
  the spatial group by `spatial_sum`, whose backward is the identity: each
  peer's term takes the whole value's cotangent once;
- each rank's loss is the mean over its own rows (spatial peers hold the
  same loss), and the gradients are SUMMED over the world and divided by
  the DATA size (`all_reduce_mean_`) before each optimizer apply. Each
  rank's gradient is the part of its data block's gradient that flows
  through its own shard, so the spatial peers' parts sum to the block's
  gradient and the data blocks average to the global one. The backward of
  a statistics' summing all-reduce is again a summing all-reduce; with
  local-mean losses it carries each statistic's cotangent summed over the
  data blocks, which the divisor then averages with the rest. A divisor of
  world, or a backward of `spatial_sum` that sums too, would put the
  gradients off by the spatial size (the trap tests/test_parallel.py
  records for GSPMD), which would not show in the losses or, through Adam's
  and RMSprop's scale invariance, much in the weights, only in the
  optimizer moments: the JAX package's own sum-for-mean class of fault
  (train/common.py:211-231), which the tests catch by comparing them;
- metrics come back stacked per step on the device and are averaged over
  the data group once per epoch (`reduce_metrics`): one all-reduce, at the
  epoch's one host sync.

`spawn_local` starts the ranks of one host with the spawn start method
(forking a process that has touched CUDA breaks it); tests, the trainer
CLIs, tools/dryrun_multichip and chip_smoke.py use it.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import queue
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from imagegeneration_tpu_torch.core import mesh as meshlib
from imagegeneration_tpu_torch.core.mesh import DataGroup

COLLECTIVE_TIMEOUT_S = 600


# ------------------------------------------------------------- collectives
class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of a group; its backward sums the cotangents over
    the same ranks (and is differentiable again, for the gradient
    penalty's double backward)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: DataGroup, over: str) -> torch.Tensor:
        ctx.group, ctx.over = group, over
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group.pg_of(over))
        group.counts["stat_all_reduce"] += 1
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _AllReduceSum.apply(g, ctx.group, ctx.over), None, None


def all_reduce_sum(x: torch.Tensor, group: DataGroup, over: str = "world") -> torch.Tensor:
    """Differentiable sum of `x` over the ranks of `over` ("world", "data"
    or "spatial"; BatchNorm's statistics)."""
    return _AllReduceSum.apply(x, group, over)


class _SpatialSum(torch.autograd.Function):
    """Sum over the spatial peers; backward: the identity."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: DataGroup) -> torch.Tensor:
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group.pg_of("spatial"))
        group.counts["spatial_sum"] += 1
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def spatial_sum(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """The sum over the spatial peers of their terms `x` of a value that
    every peer then holds whole; the backward hands each term the whole
    value's cotangent (the identity), so that summing the peers' gradients
    counts it once."""
    return _SpatialSum.apply(x, group)


def memory_order_flat(t: torch.Tensor) -> torch.Tensor | None:
    """A flat VIEW of `t` in its memory order (a channels_last tensor through
    permute(0, 2, 3, 1)), or None when `t` is not dense."""
    if t.is_contiguous():
        return t.view(-1)
    order = sorted(range(t.dim()), key=lambda d: -t.stride(d))
    p = t.permute(order)
    return p.view(-1) if p.is_contiguous() else None


def _bucket(tensors: Sequence[torch.Tensor], what: str) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Memory-order views of `tensors` and one flat copy of them all."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"{what}: one bucket needs one dtype, got {sorted(map(str, dtypes))}")
    flats = []
    for t in tensors:
        f = memory_order_flat(t)
        if f is None:
            raise ValueError(f"{what}: a tensor of strides {t.stride()} is not dense")
        flats.append(f)
    return flats, torch.cat(flats)


def _unbucket(flats: list[torch.Tensor], bucket: torch.Tensor) -> None:
    torch._foreach_copy_(flats, list(bucket.split([f.numel() for f in flats])))


@torch.no_grad()
def all_reduce_mean_(grads: Sequence[torch.Tensor | None], group: DataGroup) -> list:
    """Average gradients over the data blocks in place: ONE all-reduce over
    one flat bucket, summed over the world and divided by the data size
    (spatial peers hold parts of one block's gradient), built from and
    written back through memory-order views, so
    every gradient keeps its parameter's layout (the Adam kernel then
    copies none: adam.GRAD_COPIES). None entries (frozen leaves) stay None.
    A gradient that is not dense is first made contiguous. Returns the
    gradients."""
    out = [None if g is None else (g if memory_order_flat(g) is not None else g.contiguous())
           for g in grads]
    live = [g for g in out if g is not None]
    if not live:
        return out
    flats, bucket = _bucket(live, "gradients")
    dist.all_reduce(bucket, group=group.pg)
    group.counts["grad_all_reduce"] += 1
    bucket.div_(group.data)
    _unbucket(flats, bucket)
    return out


@torch.no_grad()
def reduce_metrics(metrics: dict[str, torch.Tensor], group: DataGroup | None) -> dict:
    """The data blocks' mean of each stacked per-step metric (spatial peers
    hold the same values): one all-reduce over the data group."""
    if group is None or not metrics:
        return metrics
    keys = list(metrics)
    dt = metrics[keys[0]].dtype
    for k in keys:
        dt = torch.promote_types(dt, metrics[k].dtype)
    stacked = torch.stack([metrics[k].to(dt) for k in keys])
    dist.all_reduce(stacked, group=group.pg_of("data"))
    group.counts["metric_all_reduce"] += 1
    stacked.div_(group.data)
    return dict(zip(keys, stacked.unbind(0)))


def all_ranks(flag: bool, group: DataGroup | None) -> bool:
    """True when `flag` holds on every rank: one all-reduce, read on the host."""
    if group is None:
        return flag
    t = torch.tensor([float(flag)], device=group.device)
    dist.all_reduce(t, group=group.pg)
    group.counts["barrier"] += 1
    return int(t.item()) == group.world


def barrier(group: DataGroup | None) -> None:
    """Wait for every rank: an all-reduce of one element, read on the host."""
    if group is None:
        return
    t = torch.ones(1, device=group.device)
    dist.all_reduce(t, group=group.pg)
    group.counts["barrier"] += 1
    if int(t.item()) != group.world:
        raise RuntimeError(f"barrier counted {int(t.item())} of {group.world} ranks")


# ------------------------------------------------------------ replication
def _leaves(tree: Any, path: str = "") -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def state_digest(state) -> str:
    """sha256 over every tensor (its bytes in memory order, dtype, shape)
    and number of `state.state_dict()`."""
    h = hashlib.sha256()
    for path, v in _leaves(state.state_dict()):
        h.update(path.encode())
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu()
            flat = memory_order_flat(t)
            flat = t.contiguous().view(-1) if flat is None else flat
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(flat.contiguous().view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()


@torch.no_grad()
def check_replicated(state, group: DataGroup | None) -> str | None:
    """Raise on every rank unless every rank's state digest is rank 0's;
    returns the digest (None without a group: nothing to check)."""
    if group is None:
        return None
    digest = state_digest(state)
    mine = torch.tensor(list(bytes.fromhex(digest)), dtype=torch.uint8, device=group.device)
    ref = mine.clone()
    dist.broadcast(ref, src=0, group=group.pg)
    group.counts["broadcast"] += 1
    differs = torch.tensor([float(not torch.equal(mine, ref))], device=group.device)
    dist.all_reduce(differs, group=group.pg)
    group.counts["barrier"] += 1
    if differs.item():
        raise RuntimeError(
            f"rank {group.rank}: the ranks' states differ ({int(differs.item())} of "
            f"{group.world} ranks off rank 0's digest; this rank {digest[:16]})")
    return digest


@torch.no_grad()
def replicate_state(state, group: DataGroup | None) -> str | None:
    """Broadcast every device tensor of `state` from rank 0 (one broadcast
    per dtype, over one bucket), then check that the ranks' states are
    bit-equal (host values, such as a generator's state or a counter, are
    seeded alike and only checked). Returns the digest (None without a
    group)."""
    if group is None:
        return None
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for _, v in _leaves(state.state_dict()):
        if isinstance(v, torch.Tensor) and v.device == group.device:
            by_dtype.setdefault(v.dtype, []).append(v)
    for dtype, tensors in by_dtype.items():
        flats, bucket = _bucket(tensors, f"state ({dtype})")
        dist.broadcast(bucket, src=0, group=group.pg)
        group.counts["broadcast"] += 1
        _unbucket(flats, bucket)
    return check_replicated(state, group)


# --------------------------------------------------------------- launcher
def local_devices(world: int, device_type: str) -> list[torch.device]:
    """One device per rank of one host: the CPU for every rank, or card r
    for rank r; refuses more ranks than visible cards."""
    if device_type == "cpu":
        return [torch.device("cpu")] * world
    if device_type != "cuda":
        raise ValueError(f"device type must be 'cuda' or 'cpu', got {device_type!r}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world > count:
        raise RuntimeError(
            f"{world} data-parallel ranks need {world} cards, {count} visible; "
            "the port neither shrinks the data axis nor falls back to the CPU")
    return [torch.device("cuda", r) for r in range(world)]


def _run_rank(rank: int, world: int, spatial: int, port: int, backend: str, device: str,
              num_threads: int | None, fn: Callable, args: tuple, results) -> None:
    dev = torch.device(device)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank),
                      LOCAL_RANK=str(dev.index if dev.type == "cuda" else rank))
    try:
        if num_threads:
            torch.set_num_threads(num_threads)
        if dev.type == "cuda":
            from imagegeneration_tpu_torch.core import platform

            dev = platform.require_cuda()
        timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
        store = dist.TCPStore("localhost", port, world, is_master=False, timeout=timeout)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=timeout)
        try:
            group = meshlib.make_mesh(
                meshlib.MeshConfig(data=world // spatial, spatial=spatial), dev)
            out = fn(group, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def spawn_local(fn: Callable, world: int, device_type: str = "cpu",
                backend: str | None = None, devices: Sequence[str] | None = None,
                args: tuple = (), num_threads: int | None = None,
                timeout: float | None = None, spatial: int = 1) -> list:
    """Run `fn(group, *args)` on `world` ranks of this host, one spawned
    process each, and return their results by rank. `fn` and its
    arguments and results must pickle (a module-level function). The ranks
    form a (world / spatial) x spatial mesh (core/mesh.make_mesh).

    devices: one device per rank (default `local_devices`); two ranks may
    share a card only over gloo, which is then named explicitly. backend:
    NCCL for CUDA, gloo for the CPU, unless named; it is never swapped. A
    rank that raises ends every rank, and its traceback is raised here; so
    does one that exits without a result. timeout: seconds to wait for every
    rank's result, then end them all; None (a training run) waits as long
    as the ranks live."""
    devs = [torch.device(d) for d in devices] if devices else local_devices(world, device_type)
    if len(devs) != world:
        raise ValueError(f"{len(devs)} devices for {world} ranks")
    if spatial < 1 or world % spatial:
        raise ValueError(f"{world} ranks do not split into spatial groups of {spatial}")
    backend = backend or meshlib.default_backend(devs[0].type)
    if backend == "nccl" and len(set(devs)) < world:
        raise ValueError("NCCL runs one rank per card; name backend='gloo' to share a card")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    # The ranks' rendezvous, served here until every rank has ended, on a
    # port the system picks as it binds (port 0): no group started at the
    # same moment (another test worker's) can be handed the same port
    # between its choice and its bind.
    store = dist.TCPStore("localhost", 0, world, is_master=True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    procs = [ctx.Process(target=_run_rank, daemon=True, args=(
        r, world, spatial, store.port, backend, str(devs[r]), num_threads, fn, args, results))
        for r in range(world)]
    for p in procs:
        p.start()
    got: dict[int, Any] = {}
    failure = None
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while len(got) < world and failure is None:
            wait = 5.0 if deadline is None else min(5.0, max(0.05, deadline - time.monotonic()))
            try:
                rank, ok, out = results.get(timeout=wait)
            except queue.Empty:
                gone = [r for r, p in enumerate(procs) if r not in got and not p.is_alive()]
                if gone:
                    failure = "ranks exited without a result: " + ", ".join(
                        f"rank {r} (exit code {procs[r].exitcode})" for r in gone)
                elif deadline is not None and time.monotonic() > deadline:
                    failure = f"no result from ranks {sorted(set(range(world)) - set(got))} " \
                              f"within {timeout} s"
                continue
            if ok:
                got[rank] = out
            else:
                failure = f"rank {rank} failed:\n{out}"
    finally:
        for p in procs:
            p.join(timeout=30 if failure is None else 1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if failure is not None:
        raise RuntimeError(failure)
    return [got[r] for r in range(world)]
