"""FID evaluation CLI — signature-compatible with sndcgan/generator_evaluation.py:248-265.

  python -m imagegeneration_tpu_torch.cli.generator_evaluation <discEpoch>
      [-b BSIZE] [-d DIR] [-o OUT] [-x DATA] [-st STEP] [-se START] [-ct]
      [--height H] [--width W] [--sqrtm {lowrank,newton_schulz,scipy}]
      [--spectral-norm] [--quirk-range-mismatch] [--device {cuda,cpu}]

The counterpart of imagegeneration_tpu.cli.generator_evaluation: pins <= 16
real batches of the image folder `-x` and their latents once (a resumable
pickle), computes the discriminator-feature FID of every chosen generator
export with the discriminator export of epoch <discEpoch>, keeps the
results in pickles and draws the boxplot and mean-line plot
(generator_evaluation.py:107-245; the plots need matplotlib, and without it
the CLI prints one line and draws none). Output goes to <output>/evaluation,
which is wiped unless `-ct` (:107-117).

It runs on one CUDA device; `--device cpu` runs it on the CPU.
`--inception` (InceptionV3 features) is refused: it is not ported yet.
"""

from __future__ import annotations

import argparse
import os
import shutil
from os import path

import torch


def evaluate_fid(
    dir_path: str,
    dataset,
    batch_size: int,
    output: str,
    step_size: int,
    start_epoch: int,
    disc_epoch: int,
    continue_: bool,
    image_size=(144, 256, 3),
    sqrtm_method: str = "lowrank",
    spectral_norm: bool = False,
    quirk_range_mismatch: bool = False,
    *,
    device: torch.device | None = None,
):
    """`dataset`: an image folder (read through ImageFolderDataset) or a
    dataset object with images/permutation/num_batches. Returns the
    per-epoch FID lists."""
    from imagegeneration_tpu_torch.core import preview as previewlib
    from imagegeneration_tpu_torch.core.data import ImageFolderDataset
    from imagegeneration_tpu_torch.evalx.fid import FIDEvaluator

    output = path.join(output, "evaluation")
    if not continue_ and os.path.exists(output):
        shutil.rmtree(output)
    os.makedirs(output, exist_ok=True)

    evaluator = FIDEvaluator(
        dir_path, output, image_size=image_size, sqrtm_method=sqrtm_method,
        spectral_norm=spectral_norm, quirk_range_mismatch=quirk_range_mismatch,
        device=device,
    )
    if continue_:
        dataset = None
    elif isinstance(dataset, (str, os.PathLike)):
        dataset = ImageFolderDataset(dataset, image_size[:2], labeled=True)
    results = evaluator.evaluate(
        dataset=dataset, batch_size=batch_size, step_size=step_size,
        start_epoch=start_epoch, disc_epoch=disc_epoch, continue_=continue_,
    )
    if previewlib.matplotlib_available("fids_boxplot.png and fids_line.png"):
        evaluator.plot(results)
    return results


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train GAN to generate landscapes")
    parser.add_argument(
        "discEpoch", type=int,
        help="Epoch of discriminator that should be used for FID calculation.")
    parser.add_argument(
        "-b", "--bSize", type=int, dest="bSize", default=32,
        help="Batch Size of images that are used to calculate the FID.")
    parser.add_argument("-d", "--directory", type=str, dest="dirPath", default="training")
    parser.add_argument("-o", "--output", type=str, dest="output", default="training")
    parser.add_argument("-x", "--data", type=str, dest="data", default="dataset")
    parser.add_argument("-st", "--stepSize", type=int, dest="stepSize", default=1,
                        help="Calculate FID for every xth checkpoint")
    parser.add_argument("-se", "--start", type=int, dest="start", default=1,
                        help="Start at this epoch")
    parser.add_argument("-ct", "--continue", dest="continue_", action="store_true",
                        default=False)
    parser.add_argument("--height", type=int, default=144)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--sqrtm", choices=["lowrank", "newton_schulz", "scipy"],
                        default="lowrank")
    parser.add_argument("--spectral-norm", action="store_true", default=False,
                        help="the evaluated run trained with --spectral-norm")
    parser.add_argument("--inception", action="store_true", default=False,
                        help="not supported: InceptionV3 features are not ported")
    parser.add_argument("--inception-weights", type=str, default=None,
                        help="not supported: InceptionV3 features are not ported")
    parser.add_argument(
        "--quirk-range-mismatch", action="store_true", default=False,
        help="bug-compat: feed fakes in [0,1] vs reals in [-1,1], exactly "
        "reproducing the reference's FID pipeline (generator_evaluation.py:163-176)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda (default; fails without a GPU) or cpu")
    return parser


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.inception or args.inception_weights:
        parser.error("--inception: InceptionV3 features are not ported to PyTorch "
                     "yet; the FID uses the trained discriminator's features")
    from imagegeneration_tpu_torch.core.platform import resolve_device

    evaluate_fid(
        args.dirPath, args.data, args.bSize, args.output, args.stepSize, args.start,
        args.discEpoch, args.continue_, (args.height, args.width, 3), args.sqrtm,
        args.spectral_norm, args.quirk_range_mismatch,
        device=resolve_device(args.device),
    )


if __name__ == "__main__":
    main()
