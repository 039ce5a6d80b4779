"""The trainers' data-parallel flags and launch, shared by the three CLIs.

  --mesh-data N          data-parallel ranks, one per card (0: one process,
                         no group)
  --mesh-spatial K       spatial (image-H) partition factor; only 1: H
                         partitioning with halo exchanges is not ported yet
  --host-sharded-data    each rank decodes only its shard of the image files

Without a launcher's environment, `--mesh-data N` starts N local ranks
(parallel/dp.spawn_local, spawn start method), one per card, and refuses
when fewer than N cards are visible: it never shrinks N and never falls
back to the CPU. `--device cpu --mesh-data N` runs N gloo ranks on the CPU
(tests). Under torchrun (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT in the environment) this process is one rank: `--mesh-data`
must equal WORLD_SIZE, and the process takes the card of its LOCAL_RANK.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable

from imagegeneration_tpu_torch.core import mesh as meshlib


def add_mesh_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--mesh-data", type=int, default=0,
                        help="data-parallel ranks, one per card (0 = one process)")
    parser.add_argument("--mesh-spatial", type=int, default=1,
                        help="spatial (image-H) partition factor; only 1: spatial "
                        "partitioning is not ported yet")
    parser.add_argument("--host-sharded-data", action="store_true", default=False,
                        help="each data-parallel rank decodes only its shard of the "
                        "image files")


def _rank_main(group, train: Callable, args: argparse.Namespace) -> None:
    train(args, group)


def run(parser: argparse.ArgumentParser, args: argparse.Namespace,
        train: Callable[[argparse.Namespace, object], None]) -> None:
    """Run `train(args, group)` in this process (group None), as this rank
    of a torchrun launch, or on --mesh-data local ranks. `train` must be a
    module-level function (it is pickled for the spawned ranks)."""
    try:
        meshlib.refuse_spatial(args.mesh_spatial)
    except NotImplementedError as e:
        parser.error(str(e))
    if args.mesh_data < 0:
        parser.error("--mesh-data must be >= 0")
    if meshlib.launched_distributed():
        world = int(os.environ["WORLD_SIZE"])
        if args.mesh_data != world:
            parser.error(f"--mesh-data {args.mesh_data} must equal WORLD_SIZE {world} "
                         "under a distributed launch")
        import torch.distributed as dist

        from imagegeneration_tpu_torch.core.platform import resolve_device

        meshlib.maybe_init_distributed(args.device)
        try:
            group = meshlib.make_mesh(meshlib.MeshConfig(data=world),
                                      resolve_device(args.device))
            train(args, group)
        finally:
            dist.destroy_process_group()
        return
    if args.mesh_data == 0:
        if args.host_sharded_data:
            parser.error("--host-sharded-data needs --mesh-data >= 1")
        train(args, None)
        return
    from imagegeneration_tpu_torch.parallel import dp

    dp.spawn_local(_rank_main, args.mesh_data, args.device, args=(train, args))
