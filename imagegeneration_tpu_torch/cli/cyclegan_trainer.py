"""CycleGAN training CLI — signature-compatible with cyclegan/Trainer.py:7-27.

  python -m imagegeneration_tpu_torch.cli.cyclegan_trainer <bSize> <epochs>
      [-x DATA1] [-y DATA2] [-d DIR] [-c FREQ] [-ct] [--bf16]
      [--mesh-data N] [--mesh-spatial K] [--host-sharded-data]
      [--height H] [--width W] [--quirk-axis1] [--seed S] [--profile]
      [--device {cuda,cpu}]

The flags are those of imagegeneration_tpu.cli.cyclegan_trainer. Training
runs on one CUDA device, or with `--mesh-data N [--mesh-spatial K]` on N x K
ranks, one card each, over a global batch of bSize, each of the K spatial
ranks of a data block holding 1/K of the image rows (`--host-sharded-data`:
each data block decodes only its shard of each domain's files;
cli/launch.py). A spatial request is held to the JAX guard at the
generator's H/4 maps (2 even rows per shard at least).
`--device cpu` runs the same code on the CPU with the plain versions of the
kernels (tests, debugging; with `--mesh-data`, gloo ranks). As in the reference,
training resumes from the latest checkpoint in the output directory
whether or not `-ct` is given (the flag is parsed and has no effect).
`-c` paces the generator exports `gen_weights_{f,g}-<epoch>.msgpack`:
every epoch that is a multiple of it writes them. `--profile` writes a
torch.profiler trace of the run's second epoch to `<dir>/traces/` (one
file per rank).
"""

from __future__ import annotations

import argparse

import torch

from imagegeneration_tpu_torch.cli import launch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train CycleGAN to translate between image domains"
    )
    parser.add_argument("bSize", type=int, help="Batch Size to use")
    parser.add_argument("epochs", type=int, help="Number of epochs to train")
    parser.add_argument(
        "-x", "--data1", type=str, dest="dataset1", default="x_data",
        help="The directory where the images from domain one can be found.",
    )
    parser.add_argument(
        "-y", "--data2", type=str, dest="dataset2", default="y_data",
        help="The directory where the images from domain two can be found.",
    )
    parser.add_argument(
        "-d", "--directory", type=str, dest="path", default="training",
        help="The output directory where the checkpoints are saved.",
    )
    parser.add_argument(
        "-c", "--checkpoints", type=int, dest="chps", default=5,
        help="Take checkpoint every x epochs. Default = 5",
    )
    parser.add_argument(
        "-ct", "--continue", dest="continue_", action="store_true", default=False,
        help="Accepted for compatibility: training always resumes from the "
        "latest checkpoint, as in the reference",
    )
    parser.add_argument("--bf16", action="store_true", default=False)
    launch.add_mesh_args(parser)
    parser.add_argument("--height", type=int, default=128)
    parser.add_argument("--width", type=int, default=128)
    parser.add_argument("--quirk-axis1", action="store_true", default=False,
                        help="bug-compatible tfa InstanceNormalization(axis=1)")
    parser.add_argument("--seed", type=int, default=62)
    parser.add_argument("--profile", action="store_true", default=False,
                        help="write a torch.profiler trace of the second epoch "
                        "into <dir>/traces (one file per rank)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda (default; fails without a GPU) or cpu "
                        "(plain kernel versions, for tests and debugging)")
    return parser


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    launch.run(parser, args, _train, _spatial_check)


def _spatial_check(args: argparse.Namespace) -> None:
    from imagegeneration_tpu_torch.core.mesh import check_spatial_partition
    from imagegeneration_tpu_torch.models.cyclegan import CycleGANConfig, min_sharded_height

    cfg = CycleGANConfig(image_size=(args.height, args.width, 3))
    check_spatial_partition(min_sharded_height(cfg), args.mesh_spatial, "cyclegan", args.height)


def _train(args: argparse.Namespace, mesh) -> None:

    from imagegeneration_tpu_torch.core.platform import resolve_device
    from imagegeneration_tpu_torch.train.cyclegan_engine import CycleGANEngine

    engine = CycleGANEngine(
        args.dataset1,
        args.dataset2,
        args.path,
        args.bSize,
        (args.width, args.height),
        device=mesh.device if mesh else resolve_device(args.device),
        quirk_axis1=args.quirk_axis1,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        seed=args.seed,
        mesh=mesh,
        host_sharded_data=args.host_sharded_data,
        profile=args.profile,
    )
    engine.train(args.epochs, args.chps)


if __name__ == "__main__":
    main()
