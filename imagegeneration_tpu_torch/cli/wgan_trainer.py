"""WGAN training CLI — signature-compatible with wasserstein_gan/Trainer.py:34-51.

  python -m imagegeneration_tpu_torch.cli.wgan_trainer <bSize> <epochs>
      [-d DIR] [-c INTERVAL] [-ct] [-x DATA] [--n-critic N] [--gp LAMBDA]
      [--bf16] [--mesh-data N] [--mesh-spatial K] [--host-sharded-data]
      [--height H] [--width W] [--seed S] [--profile] [--device {cuda,cpu}]

The flags are those of imagegeneration_tpu.cli.wgan_trainer: the dataset
directory defaults to the reference's hardcoded "bilderNeuro", n_critic to
5, the image size to 144x256, and `--gp` > 0 replaces the weight clip by
the WGAN-GP penalty. Training runs on one CUDA device, or with
`--mesh-data N [--mesh-spatial K]` on N x K ranks, one card each, over a
global batch of bSize: N data-parallel blocks of rows, each split into K
blocks of image rows (`--host-sharded-data`: each data block decodes only
its shard of the files; cli/launch.py). `--device cpu` runs the same code on the CPU
(tests, debugging; with `--mesh-data`, gloo ranks). `-c` paces the msgpack
exports as in the reference: each epoch writes `model_%04d.msgpack` under
g_models/ and c_models/ and removes the previous epoch's unless that
epoch is a multiple of `-c`; the train state is checkpointed every epoch.
`--profile` writes a torch.profiler trace of the second epoch to
`<dir>/traces/` (one file per rank).
"""

from __future__ import annotations

import argparse

import torch

from imagegeneration_tpu_torch.cli import launch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train Wasserstein GAN to generate landscapes"
    )
    parser.add_argument("bSize", type=int, help="Batch Size to use")
    parser.add_argument("epochs", type=int, help="Number of epochs to train")
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
        help="Continue training (default: Start from the beginning)",
    )
    parser.add_argument(
        "-x", "--data", type=str, dest="data", default="bilderNeuro",
        help="Image directory (reference hardcodes 'bilderNeuro').",
    )
    parser.add_argument("--n-critic", type=int, default=5)
    parser.add_argument("--gp", type=float, dest="gp_lambda", default=0.0,
                        help="WGAN-GP gradient penalty weight (replaces weight "
                        "clipping when > 0; reference default 0 = clipping)")
    parser.add_argument("--bf16", action="store_true", default=False)
    launch.add_mesh_args(parser)
    parser.add_argument("--height", type=int, default=144)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--seed", type=int, default=62)
    parser.add_argument("--profile", action="store_true", default=False,
                        help="write a torch.profiler trace of the second epoch "
                        "into <dir>/traces (one file per rank)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda (default; fails without a GPU) or cpu "
                        "(for tests and debugging)")
    return parser


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    launch.run(parser, args, _train, _spatial_check)


def _spatial_check(args: argparse.Namespace) -> None:
    from imagegeneration_tpu_torch.core.mesh import check_spatial_partition
    from imagegeneration_tpu_torch.models.wgan import WGANConfig, min_sharded_height

    cfg = WGANConfig(image_size=(args.height, args.width, 3))
    check_spatial_partition(min_sharded_height(cfg), args.mesh_spatial, "wgan", args.height)


def _train(args: argparse.Namespace, mesh) -> None:

    from imagegeneration_tpu_torch.core.platform import resolve_device
    from imagegeneration_tpu_torch.train.wgan_engine import WGANEngine

    engine = WGANEngine(
        args.data,
        (args.height, args.width, 3),
        args.bSize,
        args.n_critic,
        path_like=args.path,
        load=args.continue_,
        save_interval=args.chps,
        device=mesh.device if mesh else resolve_device(args.device),
        gp_lambda=args.gp_lambda,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        seed=args.seed,
        mesh=mesh,
        host_sharded_data=args.host_sharded_data,
        profile=args.profile,
    )
    engine.train(args.epochs)


if __name__ == "__main__":
    main()
