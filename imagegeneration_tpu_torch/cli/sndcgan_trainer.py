"""SNDCGAN training CLI — signature-compatible with sndcgan/Trainer.py:10-37.

  python -m imagegeneration_tpu_torch.cli.sndcgan_trainer <bSize> <epochs>
      [-cf N] [-d DIR] [-x DATA] [-r RATE] [-ld LR] [-lg LR] [-lo NAME] [-ct]
      [--spectral-norm] [--loss {bce,hinge}] [--d-updates {1,2}] [--bf16]
      [--mesh-data N] [--mesh-spatial K] [--host-sharded-data]
      [--height H] [--width W] [--z Z] [--seed S] [--preview-every N]
      [--profile] [--device {cuda,cpu}]

The flags are those of imagegeneration_tpu.cli.sndcgan_trainer. Training
runs on one CUDA device, or with `--mesh-data N [--mesh-spatial K]` on N x K
ranks, one card each, over a global batch of bSize: N data-parallel blocks
of rows, each split into K blocks of image rows (cli/launch.py; the guard
refuses fewer than 2 rows per shard at H/8, as the JAX trainer does). `--device cpu`
runs the same code on the CPU with the plain versions of the kernels
(tests, debugging; with `--mesh-data`, gloo ranks). `-lo` names the
live-preview PDF (`<name>.pdf`, drawn every `--preview-every` epochs when
matplotlib is installed). `--profile` writes a torch.profiler trace of the
second epoch to `<dir>/traces/` (one file per rank). As in the reference,
`epochs + 1` epochs are trained.
"""

from __future__ import annotations

import argparse

import torch

from imagegeneration_tpu_torch.cli import launch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="GAN Trainer to generate landscape images."
    )
    parser.add_argument("bSize", type=int, help="Batch Size to use.")
    parser.add_argument("epochs", type=int, help="Number of epochs to train.")
    parser.add_argument(
        "-cf", "--checkpointFrequency", type=int, dest="ckptFreq", default=5,
        help="Take checkpoint every x epochs. Default = 5",
    )
    parser.add_argument(
        "-d", "--directory", type=str, dest="dirPath", default="training",
        help="The output directory where the checkpoints and others are saved. "
        "It will be created if it dosen't exist and overritten (!) if it does.",
    )
    parser.add_argument(
        "-x", "--data", type=str, dest="data", default="dataset",
        help="The directory containing subdirectories (labels) with images to "
        "use for training.",
    )
    parser.add_argument(
        "-r", "--dropout", type=float, dest="dropout", default=0.5,
        help="The dropout rate to use for the discriminator. Default = 0.5",
    )
    parser.add_argument(
        "-ld", "--learnRateDisc", type=float, dest="learnRateDisc",
        default=0.0002, help="The learning rate for the discriminator to use.",
    )
    parser.add_argument(
        "-lg", "--learnRateGen", type=float, dest="learnRateGen",
        default=0.0002, help="The learning rate for the generator to use.",
    )
    parser.add_argument(
        "-lo", "--liveOutput", type=str, dest="liveOutput", default="live",
        help="The live preview is written to <liveOutput>.pdf every epoch.",
    )
    parser.add_argument(
        "-ct", "--continue", dest="continue_", action="store_true",
        default=False, help="Continue training (default: Start from the beginning)",
    )
    parser.add_argument("--spectral-norm", action="store_true", default=False)
    parser.add_argument("--loss", choices=["bce", "hinge"], default="bce")
    parser.add_argument("--d-updates", type=int, choices=[1, 2], default=2,
                        help="D optimizer applies per batch: 2 = the "
                        "reference's double apply, 1 = one combined update")
    parser.add_argument("--bf16", action="store_true", default=False)
    launch.add_mesh_args(parser)
    parser.add_argument("--height", type=int, default=144)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--z", type=int, dest="z_size", default=128)
    parser.add_argument("--seed", type=int, default=62)
    parser.add_argument("--preview-every", type=int, default=1,
                        help="render the live preview every N epochs")
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
    from imagegeneration_tpu_torch.models.sndcgan import SNDCGANConfig, min_sharded_height

    cfg = SNDCGANConfig(image_size=(args.height, args.width, 3))
    check_spatial_partition(min_sharded_height(cfg), args.mesh_spatial, "sndcgan", args.height)


def _train(args: argparse.Namespace, mesh) -> None:
    from imagegeneration_tpu_torch.core.platform import resolve_device
    from imagegeneration_tpu_torch.train.sndcgan_engine import SNDCGANEngine

    engine = SNDCGANEngine(
        args.dirPath,
        args.data,
        args.bSize,
        args.dropout,
        args.learnRateDisc,
        args.learnRateGen,
        args.continue_,
        (args.height, args.width, 3),
        args.z_size,
        device=mesh.device if mesh else resolve_device(args.device),
        spectral_norm=args.spectral_norm,
        loss=args.loss,
        d_updates=args.d_updates,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        seed=args.seed,
        live_output=args.liveOutput,
        mesh=mesh,
        host_sharded_data=args.host_sharded_data,
        profile=args.profile,
        preview_frequency=args.preview_every,
    )
    # Reference quirk preserved: Trainer.py:37 trains epochs+1.
    engine.train(args.epochs + 1, args.ckptFreq)


if __name__ == "__main__":
    main()
