"""Process groups for data x spatial training: one process per card.

The counterpart of imagegeneration_tpu/core/mesh.py. The JAX package lays a
(data, spatial) `jax.sharding.Mesh` over the devices and lets the compiler
insert the collectives; the port runs one process per card (torchrun's
contract, or `parallel.dp.spawn_local` on one host) and writes its
collectives by hand (parallel/dp.py, parallel/halo.py). What carries over:

- `maybe_init_distributed()`: gated on the environment (MASTER_ADDR,
  MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), idempotent, a no-op in a
  single process;
- `MeshConfig(data, spatial)` and `make_mesh`, which returns a
  `DataGroup`: the world group, its data and spatial sub-groups, this
  rank, its mesh coordinates (d, s) and its device. The spatial axis is
  innermost, as the JAX mesh lays it: rank r = d * spatial + s;
- `process_row_range(group, global_batch)`: the rows of each global batch
  this rank owns (the contiguous block d, as the JAX mesh places row block
  d on mesh row d); B % data must be 0;
- `spatial_row_range(group, h)`: the image rows of an H-partitioned map
  this rank owns (the block s of H / spatial rows);
- `check_spatial_partition`: the JAX package's guard on the shards' rows,
  so that both packages accept the same requests;
- rank 0 owns every artifact (`DataGroup.is_main`).

Spatial partitioning is ported for all three families (SNDCGAN, WGAN,
CycleGAN), each held to the JAX guard of its `min_sharded_height`.

The backend is named, never guessed at run time: NCCL for CUDA tensors,
gloo for the CPU, unless the caller names one; a backend that fails to
initialize raises.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import torch
import torch.distributed as dist

from imagegeneration_tpu_torch.core import platform

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def default_backend(device_type: str) -> str:
    """NCCL for CUDA tensors, gloo for CPU tensors."""
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"device type must be 'cuda' or 'cpu', got {device_type!r}")


def launched_distributed() -> bool:
    """True when the environment describes a multi-process launch."""
    return "WORLD_SIZE" in os.environ


def maybe_init_distributed(device_type: str, backend: str | None = None) -> bool:
    """Initialize torch.distributed from torchrun's environment, when it is
    there. Returns whether this process is part of a process group.

    Idempotent: a second call finds the group and returns. A single process
    (no WORLD_SIZE) is a no-op. The backend is `backend`, else NCCL for
    CUDA and gloo for the CPU; one that fails to initialize raises."""
    if dist.is_initialized():
        return True
    if not launched_distributed():
        return False
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"distributed launch without {missing} in the environment")
    backend = backend or default_backend(device_type)
    if device_type == "cuda":
        platform.require_cuda()  # this rank's card, current before NCCL starts
    dist.init_process_group(
        backend, init_method="env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    return True


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1: every process of the group over `spatial`
    spatial: int = 1


GROUPS = ("world", "data", "spatial")


@dataclasses.dataclass
class DataGroup:
    """One rank of a (data, spatial) mesh: the world process group, this
    rank, the world size, the spatial factor, the rank's device, and the
    sub-groups of its data peers (the ranks of its s, one per batch block)
    and of its spatial peers (the ranks of its d, one per H block).
    `counts` counts the collectives this rank issued, by purpose (the smoke
    and the tests read it)."""

    pg: object
    rank: int
    world: int
    device: torch.device
    backend: str
    spatial: int = 1
    data_pg: object = None  # None: the world group (spatial 1)
    spatial_pg: object = None  # None: no spatial peers (spatial 1)
    counts: dict[str, int] = dataclasses.field(default_factory=lambda: {
        "grad_all_reduce": 0, "stat_all_reduce": 0, "metric_all_reduce": 0,
        "halo": 0, "spatial_sum": 0, "row_gather": 0, "norm_gather": 0,
        "norm_all_reduce": 0, "broadcast": 0, "barrier": 0})

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def data(self) -> int:
        """Ranks of the data axis: batch blocks."""
        return self.world // self.spatial

    @property
    def d(self) -> int:
        """This rank's batch block."""
        return self.rank // self.spatial

    @property
    def s(self) -> int:
        """This rank's H block."""
        return self.rank % self.spatial

    @property
    def sharded(self) -> bool:
        """True when activations are H-partitioned over spatial peers."""
        return self.spatial > 1

    def pg_of(self, over: str):
        """The process group of `over`: "world", "data" or "spatial"."""
        if over == "world" or (over == "data" and not self.sharded):
            return self.pg
        if over == "data":
            return self.data_pg
        if over == "spatial" and self.sharded:
            return self.spatial_pg
        raise ValueError(f"no {over!r} group in a mesh of {self.data} x {self.spatial}")

    def size_of(self, over: str) -> int:
        return {"world": self.world, "data": self.data, "spatial": self.spatial}[over]


def make_mesh(cfg: MeshConfig, device: torch.device) -> DataGroup:
    """The DataGroup of this process over the initialized default group,
    on `device` (this rank's card, or the CPU). With spatial > 1 every rank
    creates every data and spatial sub-group, in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(maybe_init_distributed or parallel.dp.spawn_local)")
    world = dist.get_world_size()
    spatial = max(1, cfg.spatial)
    data = cfg.data if cfg.data > 0 else world // spatial
    if data * spatial != world:
        raise ValueError(f"mesh {data} x {spatial} != {world} processes in the group")
    rank = dist.get_rank()
    data_pg = spatial_pg = None
    if spatial > 1:
        for s in range(spatial):
            pg = dist.new_group([d * spatial + s for d in range(data)])
            if rank % spatial == s:
                data_pg = pg
        for d in range(data):
            pg = dist.new_group([d * spatial + s for s in range(spatial)])
            if rank // spatial == d:
                spatial_pg = pg
    return DataGroup(pg=dist.group.WORLD, rank=rank, world=world,
                     device=torch.device(device), backend=dist.get_backend(),
                     spatial=spatial, data_pg=data_pg, spatial_pg=spatial_pg)


def process_row_range(group: DataGroup | None, global_batch_size: int) -> tuple[int, int]:
    """Rows [lo, hi) of each global batch that this rank owns: the block d
    of B / data rows (spatial peers own the same rows)."""
    if group is None:
        return 0, global_batch_size
    if global_batch_size % group.data:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by the data axis "
            f"({group.data} ranks)")
    per = global_batch_size // group.data
    return group.d * per, (group.d + 1) * per


def spatial_row_range(group: DataGroup | None, h: int) -> tuple[int, int]:
    """Rows [lo, hi) of an H-partitioned map of height `h` that this rank
    owns: the block s of h / spatial rows."""
    if group is None or not group.sharded:
        return 0, h
    if h % group.spatial:
        raise ValueError(f"height {h} not divisible by the spatial axis ({group.spatial})")
    per = h // group.spatial
    return group.s * per, (group.s + 1) * per


def check_spatial_partition(min_sharded_h: int, spatial: int, family: str,
                            image_h: int) -> None:
    """Refuse the spatial requests that the JAX package refuses
    (imagegeneration_tpu/core/mesh.check_spatial_partition): every shard of
    the family's smallest H-partitioned feature map (`min_sharded_h`,
    models.*.min_sharded_height) must keep >= 2 rows, evenly.

    The port's halo exchange is exact at any extent of at least the halo;
    the guard is kept so that both packages accept the same requests (the
    JAX package's partitioner computes wrong numbers below 2 rows per
    shard). IMAGEGEN_ALLOW_DEGENERATE_SPATIAL=1 downgrades the refusal to
    a warning, as there; the port's layers then still refuse what they
    cannot split, when they first meet it: image rows that do not divide
    by the spatial axis (spatial_row_range), a strided conv over a shard
    whose rows its stride does not divide (nn.layers.conv2d_same), a halo
    wider than the shard (parallel.halo)."""
    if spatial <= 1:
        return
    extent, rem = divmod(min_sharded_h, spatial)
    if extent >= 2 and rem == 0:
        return
    msg = (
        f"{family}: --mesh-spatial {spatial} at image height {image_h} leaves "
        f"{extent} row(s) (+{rem} remainder) per shard on the deepest sharded "
        f"feature map (H={min_sharded_h}); both packages refuse fewer than 2 even "
        "rows per shard (the JAX package's partitioner is measurably WRONG below 2 "
        "even rows per shard). Use a larger image, fewer spatial shards, or set "
        "IMAGEGEN_ALLOW_DEGENERATE_SPATIAL=1 to proceed anyway (the port's layers "
        "still refuse a shard they cannot split)."
    )
    if os.environ.get("IMAGEGEN_ALLOW_DEGENERATE_SPATIAL") == "1":
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return
    raise ValueError(msg)


def check_engine_spatial(group: DataGroup | None, spatial: bool | None, min_sharded_h: int,
                         family: str, image_h: int) -> None:
    """An engine's `spatial=` against its group, then the guard: None follows
    the group; True (the JAX engines' flag) needs a group; False refuses a
    group that partitions H."""
    factor = 1 if group is None else group.spatial
    if spatial and group is None:
        raise ValueError(f"{family}: spatial=True needs a mesh")
    if spatial is False and factor > 1:
        raise ValueError(f"{family}: spatial=False with a mesh of spatial factor {factor}")
    check_spatial_partition(min_sharded_h, factor, family, image_h)
