"""Sample-grid previews: live PDFs, WGAN 10x10 grids, epoch grids, CycleGAN
translation sheets.

The counterpart of imagegeneration_tpu/core/preview.py, drawing the same
figures from numpy images (B, H, W, 3):

- `plot_image` keeps the reference's double denormalisation: samples
  already in [0, 1] get a second x / 2 + 0.5, so preview pixels land in
  [0.5, 1] (generator_output.py:31-34; it is the look of every reference
  artifact);
- `live_preview`: the SNDCGAN per-epoch 1xN PDF with its info line
  (sndcgan/SNDCGAN.py:228-238);
- `sample_grid`: the WGAN rows x cols JPG (wasserstein_gan/WGAN.py:236-249);
- `epoch_grid`: rows = epochs, columns = the batch (generator_output.py:
  37-48);
- `translation_sheet`: CycleGAN input/output pairs for both generators,
  images in [-1, 1] denormalised once (cyclegan/CycleGAN.py:274-313).

matplotlib is imported inside each function, with the Agg backend: the GPU
machine does not have it. Engines and CLIs ask `matplotlib_available` once
and skip their figures, with one printed line, where it is missing.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Sequence

import numpy as np


def matplotlib_available(skipped: str) -> bool:
    """True when matplotlib can be imported. Otherwise print one line that
    names the artifacts `skipped` and return False."""
    if importlib.util.find_spec("matplotlib") is not None:
        return True
    print(f"matplotlib is not installed: not writing {skipped}", flush=True)
    return False


def pyplot():
    """matplotlib.pyplot on the Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_image(ax, image: np.ndarray) -> None:
    """The reference plot_image, double denormalisation included."""
    ax.imshow(np.clip(image / 2.0 + 0.5, 0.0, 1.0))


def _hide_axes(ax) -> None:
    ax.get_xaxis().set_visible(False)
    ax.get_yaxis().set_visible(False)


def live_preview(samples: np.ndarray, info_text: str, out_file: str | Path) -> None:
    """1xN preview figure (sndcgan/SNDCGAN.py:228-238)."""
    plt = pyplot()
    n = samples.shape[0]
    figure = plt.figure(figsize=(20, 10))
    for j in range(n):
        ax = figure.add_subplot(1, n, j + 1)
        _hide_axes(ax)
        plot_image(ax, samples[j])
    figure.suptitle(info_text, size="xx-large")
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    figure.savefig(out_file)
    plt.close(figure)


def sample_grid(
    samples: np.ndarray, rows: int, cols: int, out_file: str | Path,
    figsize: tuple[int, int] = (26, 26),
) -> None:
    """rows x cols grid (wasserstein_gan/WGAN.py:236-249)."""
    plt = pyplot()
    figure = plt.figure(figsize=figsize)
    for i in range(rows * cols):
        ax = figure.add_subplot(rows, cols, i + 1)
        _hide_axes(ax)
        plot_image(ax, samples[i])
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    figure.savefig(out_file)
    plt.close(figure)


def epoch_grid(
    epoch_samples: Sequence[np.ndarray], epochs_used: Sequence[int],
    out_file: str | Path,
) -> None:
    """Rows = epochs, columns = batch, each titled with its epoch
    (generator_output.py:37-48)."""
    plt = pyplot()
    n_rows = len(epoch_samples)
    n_cols = epoch_samples[0].shape[0]
    fig, axes = plt.subplots(
        figsize=(20, 5 * n_rows), nrows=max(n_rows, 1), ncols=max(n_cols, 1),
        sharex=True, sharey=True, squeeze=False,
    )
    for i, samples in enumerate(epoch_samples):
        for j in range(n_cols):
            ax = axes[i, j]
            _hide_axes(ax)
            ax.set_title("Epoch:" + str(epochs_used[i]))
            plot_image(ax, samples[j])
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file)
    plt.close(fig)


def translation_sheet(
    inputs_g: np.ndarray, inputs_f: np.ndarray, outputs_g: np.ndarray,
    outputs_f: np.ndarray, batch_label: int | str, out_file: str | Path,
) -> None:
    """CycleGAN preview: input and output columns for both generators
    (cyclegan/CycleGAN.py:274-313)."""
    plt = pyplot()
    n_cases = len(inputs_g) + len(inputs_f)
    fig, axes = plt.subplots(
        figsize=(10, 5 * n_cases), nrows=n_cases, ncols=2,
        sharex=True, sharey=True, squeeze=False,
    )

    def show(ax, img):
        _hide_axes(ax)
        ax.imshow(np.clip(img / 2.0 + 0.5, 0.0, 1.0))

    axes[0, 0].set_title("Images for G-GAN")
    pairs = [*zip(inputs_g, outputs_g), *zip(inputs_f, outputs_f)]
    for row, (x, y) in enumerate(pairs):
        show(axes[row, 0], x)
        show(axes[row, 1], y)
    fig.suptitle(f"Batch: {batch_label}", size="xx-large")
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file)
    plt.close(fig)
