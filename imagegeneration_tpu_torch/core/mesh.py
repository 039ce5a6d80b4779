"""Process groups for data-parallel training: one process per card.

The counterpart of imagegeneration_tpu/core/mesh.py. The JAX package lays a
(data, spatial) `jax.sharding.Mesh` over the devices and lets the compiler
insert the collectives; the port runs one process per card (torchrun's
contract, or `parallel.dp.spawn_local` on one host) and writes its two
collectives by hand (parallel/dp.py). What carries over:

- `maybe_init_distributed()`: gated on the environment (MASTER_ADDR,
  MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), idempotent, a no-op in a
  single process;
- `MeshConfig(data, spatial=1)` and `make_mesh`, which returns a
  `DataGroup`: the process group, this rank, the world size and this
  rank's device;
- `process_row_range(group, global_batch)`: the rows of each global batch
  this rank owns (a contiguous block, as the JAX mesh places row block d on
  mesh row d); B % world must be 0;
- rank 0 owns every artifact (`DataGroup.is_main`).

Any spatial factor > 1 is refused (`refuse_spatial`): H-partitioning with
halo exchanges is not ported yet, and the JAX package's guard on the
shards' rows (`check_spatial_partition`) comes with it.

The backend is named, never guessed at run time: NCCL for CUDA tensors,
gloo for the CPU, unless the caller names one; a backend that fails to
initialize raises.
"""

from __future__ import annotations

import dataclasses
import os

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
    data: int = -1  # -1: every process of the group
    spatial: int = 1


@dataclasses.dataclass
class DataGroup:
    """One data-parallel rank: the process group, this rank, the world size
    and the rank's device. `counts` counts the collectives this rank issued,
    by purpose (the smoke and the tests read it)."""

    pg: object
    rank: int
    world: int
    device: torch.device
    backend: str
    counts: dict[str, int] = dataclasses.field(default_factory=lambda: {
        "grad_all_reduce": 0, "stat_all_reduce": 0, "metric_all_reduce": 0,
        "broadcast": 0, "barrier": 0})

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def refuse_spatial(spatial: int) -> None:
    if spatial > 1:
        raise NotImplementedError(
            f"--mesh-spatial {spatial}: spatial H-partitioning (halo "
            "exchanges between cards) is not ported to PyTorch yet; use the "
            "data axis only")


def make_mesh(cfg: MeshConfig, device: torch.device) -> DataGroup:
    """The DataGroup of this process over the initialized default group,
    on `device` (this rank's card, or the CPU)."""
    refuse_spatial(cfg.spatial)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(maybe_init_distributed or parallel.dp.spawn_local)")
    world = dist.get_world_size()
    if cfg.data not in (-1, world):
        raise ValueError(f"--mesh-data {cfg.data} != {world} processes in the group")
    return DataGroup(pg=dist.group.WORLD, rank=dist.get_rank(), world=world,
                     device=torch.device(device), backend=dist.get_backend())


def process_row_range(group: DataGroup | None, global_batch_size: int) -> tuple[int, int]:
    """Rows [lo, hi) of each global batch that this rank owns: the rank's
    contiguous block of B / world rows."""
    if group is None:
        return 0, global_batch_size
    if global_batch_size % group.world:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by the data axis "
            f"({group.world} ranks)")
    per = global_batch_size // group.world
    return group.rank * per, (group.rank + 1) * per
