"""Offline sampling CLI — signature-compatible with sndcgan/generator_output.py:103-115.

  python -m imagegeneration_tpu_torch.cli.generator_output <every>
      [-b BSIZE] [-d DIR] [-o OUTPUT] [-s START] [--height H] [--width W]
      [--z Z] [--seed S] [--from-checkpoints] [--device {cuda,cpu}]

The counterpart of imagegeneration_tpu.cli.generator_output:

- enumerates the epoch-stamped generator exports under
  <dir>/models/generator/ (`gen_model-<epoch>.msgpack`), keeps the epochs
  >= start, then every `every`-th of them (generator_output.py:51-63);
  `--from-checkpoints` reads the port's whole-state checkpoints under
  <dir>/checkpoints/ instead (:73-100);
- ONE fixed z ~ U[-1, 1) for every epoch, from the port's "preview" stream
  (drawn on the CPU, so the same for a seed on every device), and cuDNN
  kept to deterministic algorithms: the samples are bitwise stable;
- samples G(z, train=False) in [0, 1] (`create_samples`) and draws them as
  one grid, a row per epoch, into <dir>/<output>.pdf with the reference's
  double denormalisation (core/preview.epoch_grid). The PDF needs
  matplotlib; without it the CLI prints one line and writes no PDF.

Sampling runs on one CUDA device; `--device cpu` runs it on the CPU. The
generator's base width is read from the first export or checkpoint.
"""

from __future__ import annotations

import argparse
from os import path

import numpy as np
import torch

from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.core import platform
from imagegeneration_tpu_torch.core import preview as previewlib
from imagegeneration_tpu_torch.core import rng as rnglib
from imagegeneration_tpu_torch.core.checkpoint import (
    CheckpointManager,
    find_epoch_files,
    load_params,
)
from imagegeneration_tpu_torch.models.sndcgan import Generator, SNDCGANConfig


@torch.inference_mode()
def create_samples(gen: Generator, g_variables, input_z, batch_size: int,
                   image_size) -> np.ndarray:
    """(G(z, train=False) + 1) / 2 as (B, H, W, C) numpy
    (generator_output.py:25-28). `g_variables`: a flax-layout export tree
    loaded into `gen` first, or None to sample `gen` as it is."""
    if g_variables is not None:
        bridge.load_flax_variables(gen, g_variables)
    device = next(gen.parameters()).device
    z = torch.as_tensor(np.asarray(input_z, np.float32), device=device)
    imgs = (gen(z, train=False) + 1.0) / 2.0
    return imgs.permute(0, 2, 3, 1).cpu().numpy().reshape(batch_size, *image_size)


def _fixed_z(batch_size: int, z_size: int, seed: int) -> np.ndarray:
    gen = rnglib.KeyChain(seed).generator("preview")
    return rnglib.uniform_z(gen, batch_size, z_size, "cpu").numpy()


def _generator(base_width: int, image_size, z_size: int, device) -> Generator:
    """A generator to load epochs into, on `device` (None: the card)."""
    device = platform.require_cuda() if device is None else torch.device(device)
    platform.configure_numerics(deterministic=True)
    cfg = SNDCGANConfig(image_size=tuple(image_size), z_size=z_size, base_width=base_width)
    return Generator(cfg, torch.Generator()).to(device)  # weights loaded next


def _finish(epoch_samples, epochs_used, dir_path, output_image, return_samples):
    if previewlib.matplotlib_available(f"the sample grid {output_image}.pdf"):
        previewlib.epoch_grid(
            epoch_samples, epochs_used, path.join(dir_path, output_image + ".pdf"))
    return (epochs_used, epoch_samples) if return_samples else epochs_used


def output_results_models(
    batch_size: int,
    dir_path: str,
    every: int,
    output_image: str,
    start_epoch: int,
    image_size=(144, 256, 3),
    z_size: int = 128,
    seed: int = 62,
    *,
    device: torch.device | None = None,
    return_samples: bool = False,
):
    """Sample every chosen generator export with one fixed z. Returns the
    epochs used, and with `return_samples` their (B, H, W, C) samples too.
    `device` None is the CUDA card, which must exist."""
    model_path = path.join(dir_path, "models", "generator")
    found = find_epoch_files(model_path, "gen_model-{epoch}.msgpack")
    epochs_used = [e for e, _ in found if e >= start_epoch][::every]
    files = dict(found)
    if not epochs_used:
        raise FileNotFoundError(f"no generator exports under {model_path}")
    fixed_z, gen = _fixed_z(batch_size, z_size, seed), None
    epoch_samples = []
    for i, epoch in enumerate(epochs_used):
        print(f"\r Load Model {i}", end="", flush=True)
        g_vars = load_params(files[epoch])
        if gen is None:
            gen = _generator(bridge.sndcgan_base_width(g_vars), image_size, z_size, device)
        epoch_samples.append(create_samples(gen, g_vars, fixed_z, batch_size, image_size))
    print()
    return _finish(epoch_samples, epochs_used, dir_path, output_image, return_samples)


def output_results_ckpts(
    batch_size: int,
    dir_path: str,
    every: int,
    output_image: str,
    start_epoch: int,
    image_size=(144, 256, 3),
    z_size: int = 128,
    seed: int = 62,
    *,
    device: torch.device | None = None,
    return_samples: bool = False,
):
    """As `output_results_models`, over the whole-state checkpoints the
    SNDCGAN engine keeps (generator_output.py:73-100)."""
    mgr = CheckpointManager(path.join(dir_path, "checkpoints"))
    epochs_used = [e for e in mgr.all_epochs() if e >= start_epoch][::every]
    if not epochs_used:
        raise FileNotFoundError(f"no checkpoints under {dir_path}/checkpoints")
    fixed_z, gen = _fixed_z(batch_size, z_size, seed), None
    epoch_samples = []
    for i, epoch in enumerate(epochs_used):
        print(f"\r Load Checkpoint {i}", end="", flush=True)
        g_state = mgr.restore(epoch)["gen"]
        if gen is None:  # ConvTranspose weight (in, out, kh, kw): up0 maps base -> base / 2
            gen = _generator(g_state["up0.weight"].shape[0], image_size, z_size, device)
        gen.load_state_dict(g_state)
        epoch_samples.append(create_samples(gen, None, fixed_z, batch_size, image_size))
    print()
    return _finish(epoch_samples, epochs_used, dir_path, output_image, return_samples)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train GAN to generate landscapes")
    parser.add_argument("every", type=int, help="Produce example for every xth checkpoint")
    parser.add_argument("-b", "--bSize", type=int, dest="bSize", default=3)
    parser.add_argument("-d", "--directory", type=str, dest="dirPath", default="training")
    parser.add_argument("-o", "--output", type=str, dest="output", default="training")
    parser.add_argument("-s", "--start", type=int, dest="start", default=0)
    parser.add_argument("--height", type=int, default=144)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--z", type=int, dest="z_size", default=128)
    parser.add_argument("--seed", type=int, default=62)
    parser.add_argument("--from-checkpoints", action="store_true",
                        help="restore training checkpoints instead of exports")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda (default; fails without a GPU) or cpu")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    fn = output_results_ckpts if args.from_checkpoints else output_results_models
    fn(args.bSize, args.dirPath, args.every, args.output, args.start,
       (args.height, args.width, 3), args.z_size, args.seed,
       device=platform.resolve_device(args.device))


if __name__ == "__main__":
    main()
