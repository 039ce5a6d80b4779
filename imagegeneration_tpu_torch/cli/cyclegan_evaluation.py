"""CycleGAN perception-distance CLI — signature-compatible with
cyclegan/generator_evaluation.py:143-154.

  python -m imagegeneration_tpu_torch.cli.cyclegan_evaluation <generators> <samples>
      [-s SAMPLESIZE] [-o OUTPUT] [--height H] [--width W]
      [--vgg-weights H5] [--quirk-axis1] [--device {cuda,cpu}]

The counterpart of imagegeneration_tpu.cli.cyclegan_evaluation (reference
main(), :123-140): one batch of min(SAMPLESIZE, folder size) images of the
folder <samples>, in the dataset's epoch-0 order; for every epoch-stamped
export `gen_weights_f-<e>.msgpack`, then `gen_weights_g-<e>.msgpack`, in
the one directory <generators> (the CycleGAN engine writes them to
models/generator_f and models/generator_g, so one call scores one
generator), the batch is translated and the VGG16-feature PD of each
input/output pair computed (evalx/pd.py); then the log-scale boxplot and
the median/mean line plot (:77-120), whose file names say "fids" while the
y-label says perception distance (both quirks kept). The plots need
matplotlib; without it the CLI prints one line and draws none.

The generator is built at the CycleGANConfig defaults (base 64, 9 res
blocks) at --height x --width. It runs on one CUDA device; `--device cpu`
runs it on the CPU. cuDNN is kept to deterministic algorithms, so that a
translated batch and its PDs do not change from one run to the next.
"""

from __future__ import annotations

import argparse
import os
import time
from os import path

import numpy as np
import torch

from imagegeneration_tpu_torch.core import preview as previewlib

PLOTS = "plot_boxplot_fids.pdf and plot_line_plot_fids.pdf"


def plot_pd(epochs, pds, output_dir: str) -> None:
    """The boxplot and the median/mean line plot (:77-120), log scale, in
    `output_dir` (made if missing)."""
    if not previewlib.matplotlib_available(PLOTS):
        return
    os.makedirs(output_dir, exist_ok=True)
    plt = previewlib.pyplot()
    order = np.argsort(epochs)
    epochs = [epochs[i] for i in order]
    pds = [pds[i] for i in order]

    plt.clf()
    _, ax = plt.subplots(nrows=1, ncols=1, figsize=(max(3 * len(epochs), 6), 12))
    ax.boxplot(pds, showmeans=True, meanline=True,
               tick_labels=[str(e) for e in epochs])
    ax.yaxis.grid(True)
    ax.set_yscale("log")
    ax.set_xlabel("Epoch", fontsize=14)
    ax.set_ylabel("Perception Distance", fontsize=14)
    plt.tight_layout()
    plt.savefig(path.join(output_dir, "plot_boxplot_fids.pdf"), dpi=300)
    plt.close()

    plt.clf()
    plt.plot(epochs, [float(np.median(p)) for p in pds], label="median")
    plt.plot(epochs, [float(np.mean(p)) for p in pds], label="mean")
    plt.xlabel("Epoch", fontsize=12)
    plt.ylabel("Perception Distance", fontsize=12)
    plt.legend()
    plt.yscale("log")
    plt.xticks(epochs)
    plt.tight_layout()
    plt.savefig(path.join(output_dir, "plot_line_plot_fids.pdf"), dpi=300)
    plt.close()


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main_eval(
    samples_path: str,
    generators_path: str,
    sample_size: int,
    output: str,
    generator_image_dim=(128, 128, 3),
    weights_path: str | None = None,
    quirk_axis1: bool = False,
    *,
    device: torch.device | None = None,
) -> tuple[list[int], list[list[float]], list[dict[str, float]]]:
    """(epochs, per-pair PDs of each epoch, host seconds of each epoch).

    An epoch's seconds are split into "load" (the export read, parsed and
    copied in), "features" (the translation and both VGG passes, ending in
    a device sync) and "math" (the per-pair MSE, its copy to the host and
    the mean).
    `device` None is the CUDA card (which must exist)."""
    from imagegeneration_tpu_torch import bridge
    from imagegeneration_tpu_torch.core import platform
    from imagegeneration_tpu_torch.core.checkpoint import find_epoch_files, load_params
    from imagegeneration_tpu_torch.core.data import ImageFolderDataset
    from imagegeneration_tpu_torch.evalx import pd as pdlib
    from imagegeneration_tpu_torch.models.cyclegan import CycleGANConfig, Generator

    device = platform.require_cuda() if device is None else torch.device(device)
    platform.configure_numerics()
    h, w, _ = generator_image_dim
    ds = ImageFolderDataset(samples_path, (h, w), labeled=False)
    batch_u8 = ds.images[ds.permutation(0)[:min(sample_size, len(ds))]]
    data = torch.from_numpy(batch_u8).to(device).float() / 127.5 - 1.0  # NHWC

    gen = Generator(CycleGANConfig(image_size=tuple(generator_image_dim),
                                   quirk_axis1=quirk_axis1), torch.Generator())
    gen = gen.to(device).eval()
    vgg = pdlib.load_vgg16_params(weights_path, device)

    found = find_epoch_files(generators_path, "gen_weights_f-{epoch}.msgpack")
    found += find_epoch_files(generators_path, "gen_weights_g-{epoch}.msgpack")
    if not found:
        raise FileNotFoundError(f"no generator weight exports in {generators_path}")

    epochs, pds, seconds = [], [], []
    with torch.no_grad():
        for epoch, file in found:
            t0 = time.perf_counter()
            bridge.load_flax_variables(gen, load_params(file))
            _wait(device)
            t_load = time.perf_counter()
            out = gen(data.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            feats_in, feats_out = pdlib.vgg_features(vgg, data), pdlib.vgg_features(vgg, out)
            _wait(device)
            t1 = time.perf_counter()
            per_pair = pdlib.pd_from_features(feats_in, feats_out).cpu().numpy()
            mean = float(np.mean(per_pair))
            seconds.append({"load": t_load - t0, "features": t1 - t_load,
                            "math": time.perf_counter() - t1})
            epochs.append(epoch)
            pds.append(list(map(float, per_pair)))
            print(f"epoch {epoch}: PD mean {mean:.6f}")
    plot_pd(epochs, pds, output)
    return epochs, pds, seconds


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluate CycleGAN")
    parser.add_argument(
        "generators", type=str, help="Path where the gen models lie"
    )
    parser.add_argument("samples", type=str, help="Path where the samples lie")
    parser.add_argument(
        "-s", "--sampleSize", type=int, dest="sampleSize", default=128,
        help="Sample Size of images that are used to calculate the PD.",
    )
    parser.add_argument(
        "-o", "--output", type=str, dest="output", default="training",
        help="The name of the image to (over-)write",
    )
    parser.add_argument("--height", type=int, default=128)
    parser.add_argument("--width", type=int, default=128)
    parser.add_argument("--vgg-weights", type=str, default=None,
                        help="Keras-format VGG16 .h5 (else fixed random init)")
    parser.add_argument("--quirk-axis1", action="store_true", default=False)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda (default; fails without a GPU) or cpu")
    return parser


def main(argv=None):
    """Run the CLI; returns main_eval's (epochs, PDs, seconds)."""
    args = build_parser().parse_args(argv)
    from imagegeneration_tpu_torch.core.platform import resolve_device

    return main_eval(
        args.samples,
        args.generators,
        args.sampleSize,
        args.output,
        (args.height, args.width, 3),
        args.vgg_weights,
        args.quirk_axis1,
        device=resolve_device(args.device),
    )


if __name__ == "__main__":
    main()
