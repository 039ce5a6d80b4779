"""The trainers' data-parallel flags and launch, shared by the three CLIs.

  --mesh-data N          data-parallel ranks (0: one process, no group)
  --mesh-spatial K       spatial (image-H) partition factor: each data rank's
                         images are split into K blocks of rows, one rank
                         each, with halo exchanges (needs --mesh-data >= 1)
  --host-sharded-data    each data block decodes only its shard of the image
                         files

The ranks form an N x K mesh, spatial innermost (rank = d * K + s), one
process and one card each. Without a launcher's environment the trainer
starts N * K local ranks (parallel/dp.spawn_local, spawn start method) and
refuses when fewer cards are visible: it never shrinks the mesh and never
falls back to the CPU. `--device cpu` runs the ranks over gloo on the CPU
(tests). Under torchrun (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT in the environment) this process is one rank: N * K must equal
WORLD_SIZE, and the process takes the card of its LOCAL_RANK. A spatial
request is first held to the family's guard (core/mesh.
check_spatial_partition), so that the trainer refuses what the JAX
package's refuses.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable

from imagegeneration_tpu_torch.core import mesh as meshlib


def add_mesh_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--mesh-data", type=int, default=0,
                        help="data-parallel ranks (0 = one process)")
    parser.add_argument("--mesh-spatial", type=int, default=1,
                        help="spatial (image-H) partition factor: ranks per data rank, "
                        "one card each, each holding a block of image rows")
    parser.add_argument("--host-sharded-data", action="store_true", default=False,
                        help="each data block decodes only its shard of the image files")


def _rank_main(group, train: Callable, args: argparse.Namespace) -> None:
    train(args, group)


def run(parser: argparse.ArgumentParser, args: argparse.Namespace,
        train: Callable[[argparse.Namespace, object], None],
        spatial_check: Callable[[argparse.Namespace], None]) -> None:
    """Run `train(args, group)` in this process (group None), as this rank
    of a torchrun launch, or on --mesh-data x --mesh-spatial local ranks.
    `train` must be a module-level function (it is pickled for the spawned
    ranks). `spatial_check(args)` raises ValueError for a spatial request
    the family's guard refuses."""
    if args.mesh_data < 0 or args.mesh_spatial < 1:
        parser.error("--mesh-data must be >= 0 and --mesh-spatial >= 1")
    if args.mesh_spatial > 1:
        try:
            spatial_check(args)
        except ValueError as e:
            parser.error(str(e))
        if args.mesh_data == 0:
            parser.error("--mesh-spatial > 1 needs --mesh-data >= 1")
    world = args.mesh_data * args.mesh_spatial
    cfg = meshlib.MeshConfig(data=args.mesh_data, spatial=args.mesh_spatial)
    if meshlib.launched_distributed():
        launched = int(os.environ["WORLD_SIZE"])
        if world != launched:
            parser.error(f"--mesh-data {args.mesh_data} x --mesh-spatial {args.mesh_spatial} "
                         f"must equal WORLD_SIZE {launched} under a distributed launch")
        import torch.distributed as dist

        from imagegeneration_tpu_torch.core.platform import resolve_device

        meshlib.maybe_init_distributed(args.device)
        try:
            group = meshlib.make_mesh(cfg, resolve_device(args.device))
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

    dp.spawn_local(_rank_main, world, args.device, args=(train, args),
                   spatial=args.mesh_spatial)
