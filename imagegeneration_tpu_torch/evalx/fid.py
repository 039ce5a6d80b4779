"""Discriminator-feature FID over epoch-stamped exports (the reference's FID).

The counterpart of imagegeneration_tpu/evalx/fid.py, after
sndcgan/generator_evaluation.py:

- the features are the trained discriminator's own trunk with its head
  removed and an 8x8 average pool + flatten appended (:134-138), run
  without dropout (`Discriminator(x, kw=None, features=True)`), not
  InceptionV3. `feature_source="inception"` is not ported yet;
- the evaluation state (<= MAX_BATCHES real batches, their latents and the
  epoch list) is pinned once into `fid_tmp_init.pickle`, so runs resume and
  every epoch is measured on the same batches (:58-102). The real batches
  are the first full batches of the dataset's epoch-0 order
  (`permutation(0)`), the latents the port's "eval" stream, one draw per
  batch. The port's order differs from the JAX package's, so the two agree
  only from a shared init pickle;
- per-epoch FIDs (one per pinned batch) accumulate in `fids.pickle`, and
  an interrupted evaluation resumes where it stopped (:143-157, 178-184);
- FID math per batch: mean and covariance, with the cross term from
  ops/sqrtm (`lowrank` by default: exact, no d x d matrix is formed).

`quirk_range_mismatch=True` reproduces the reference's range mismatch:
fakes in [0, 1] (create_samples) against reals in [-1, 1]
(generator_evaluation.py:163-176). By default both are in [-1, 1].

On the device, synthesis and features are one pass per batch: the fake
batch never leaves the card, and only the (B, 4096) feature matrices come
back. The models run in float32, with TF32 off and cuDNN kept to
deterministic algorithms, so an epoch evaluated again gives the same FIDs.
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from os import path
from pathlib import Path

import numpy as np
import torch

from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.core import platform
from imagegeneration_tpu_torch.core import preview as previewlib
from imagegeneration_tpu_torch.core import rng as rnglib
from imagegeneration_tpu_torch.core.checkpoint import find_epoch_files, load_params
from imagegeneration_tpu_torch.models.sndcgan import (
    Discriminator,
    Generator,
    SNDCGANConfig,
)
from imagegeneration_tpu_torch.ops.sqrtm import (
    trace_sqrtm_product,
    trace_sqrtm_product_lowrank,
)

MAX_BATCHES = 16  # generator_evaluation.py:29
GEN_PATTERN = "gen_model-{epoch}.msgpack"
DISC_PATTERN = "disc_model-{epoch}.msgpack"


def calculate_fid_from_features(
    feats_fake: np.ndarray, feats_real: np.ndarray, method: str = "lowrank",
    device: torch.device | None = None,
) -> float:
    """Frechet distance between the two feature Gaussians
    (generator_evaluation.py:36-55), in float64 on the host.

    method "lowrank" (default): the exact cross term from the small cross
    matrix; "scipy": the reference's d x d host sqrtm; "newton_schulz": the
    float32 iteration on `device` (None: the CUDA card)."""
    feats_fake = np.asarray(feats_fake, np.float64)
    feats_real = np.asarray(feats_real, np.float64)
    mu_f, mu_r = feats_fake.mean(axis=0), feats_real.mean(axis=0)
    ssdiff = float(np.sum((mu_f - mu_r) ** 2))

    def trace_cov(f, mu):  # tr(cov) without forming it
        return float(np.sum((f - mu) ** 2) / max(f.shape[0] - 1, 1))

    if method == "lowrank":
        tr_cross = trace_sqrtm_product_lowrank(feats_fake, feats_real)
        return (ssdiff + trace_cov(feats_fake, mu_f) + trace_cov(feats_real, mu_r)
                - 2.0 * tr_cross)
    cov_f = np.cov(feats_fake, rowvar=False)
    cov_r = np.cov(feats_real, rowvar=False)
    tr_cross = trace_sqrtm_product(
        cov_f.astype(np.float32), cov_r.astype(np.float32), method, device)
    return ssdiff + float(np.trace(cov_f + cov_r)) - 2.0 * tr_cross


class FIDEvaluator:
    """Pinned-batch, resumable FID over the exports of one training run.

    `device` None is the CUDA card (which must exist). The generator is
    built at the base width of the first export it loads."""

    def __init__(
        self,
        dir_path: str,
        output_dir: str,
        image_size=(144, 256, 3),
        z_size: int = 128,
        dropout: float = 0.5,
        seed: int = rnglib.DEFAULT_MODEL_SEED,
        sqrtm_method: str = "lowrank",
        spectral_norm: bool = False,  # must match the trained discriminator
        quirk_range_mismatch: bool = False,
        feature_source: str = "disc",
        *,
        device: torch.device | None = None,
    ) -> None:
        if feature_source == "inception":
            raise NotImplementedError(
                "feature_source='inception' (InceptionV3 pool3 features) is not "
                "ported to PyTorch yet; use the discriminator features")
        if feature_source != "disc":
            raise ValueError(f"unknown feature_source {feature_source!r}")
        self.dir_path = dir_path
        self.output_dir = output_dir
        self.device = platform.require_cuda() if device is None else torch.device(device)
        platform.configure_numerics(deterministic=True)
        self.cfg = SNDCGANConfig(
            image_size=tuple(image_size), z_size=z_size, dropout_rate=dropout,
            spectral_norm=spectral_norm,
        )
        # Every use loads an export into these; the discriminator's widths
        # are fixed, the generator's are read from its first export.
        self.disc = Discriminator(self.cfg, torch.Generator()).to(self.device)
        self.gen: Generator | None = None
        self.seed = seed
        self.sqrtm_method = sqrtm_method
        self.quirk_range_mismatch = quirk_range_mismatch
        # Host seconds of the last evaluate(): pinning, and per epoch the
        # features (synthesis included, ending in the copy to the host)
        # and the FID math.
        self.pin_seconds: float | None = None
        self.epoch_seconds: dict[int, dict[str, float]] = {}

    # ------------------------------------------------------------ pinning
    def init_fid_evaluation(
        self, dataset, batch_size: int, step_size: int, start_epoch: int,
        disc_epoch: int,
    ) -> dict:
        """Pin <= MAX_BATCHES real batches, their latents and the epoch
        list, and pickle them (generator_evaluation.py:58-102)."""
        found = find_epoch_files(self._models("generator"), GEN_PATTERN)
        epochs_used = [e for e, _ in found if e >= start_epoch][::step_size]
        chain = rnglib.KeyChain(self.seed)
        batches_used = min(MAX_BATCHES, dataset.num_batches(batch_size))
        order = dataset.permutation(0)
        img_real_used, random_z_used = [], []
        for i in range(batches_used):
            batch_u8 = dataset.images[order[i * batch_size:(i + 1) * batch_size]]
            img_real_used.append(batch_u8.astype(np.float32) / 127.5 - 1.0)
            z = rnglib.uniform_z(chain.generator("eval", step=i), batch_u8.shape[0],
                                 self.cfg.z_size, "cpu")
            random_z_used.append(z.numpy())
        init_dict = {
            "epochs_used": epochs_used,
            "img_real_used": img_real_used,
            "random_z_used": random_z_used,
            "batches_used": batches_used,
            "disc_epoch": disc_epoch,
        }
        Path(self.output_dir).mkdir(parents=True, exist_ok=True)
        with open(path.join(self.output_dir, "fid_tmp_init.pickle"), "wb") as f:
            pickle.dump(init_dict, f)
        return init_dict

    def load_init(self) -> dict:
        with open(path.join(self.output_dir, "fid_tmp_init.pickle"), "rb") as f:
            return pickle.load(f)  # written by init_fid_evaluation

    # --------------------------------------------------------- evaluation
    def _models(self, kind: str) -> str:
        return path.join(self.dir_path, "models", kind)

    def load_disc(self, epoch: int) -> None:
        bridge.load_flax_variables(self.disc, load_params(
            path.join(self._models("discriminator"), DISC_PATTERN.format(epoch=epoch))))

    def load_gen(self, epoch: int) -> None:
        variables = load_params(
            path.join(self._models("generator"), GEN_PATTERN.format(epoch=epoch)))
        if self.gen is None:
            cfg = dataclasses.replace(
                self.cfg, base_width=bridge.sndcgan_base_width(variables))
            self.gen = Generator(cfg, torch.Generator()).to(self.device)
        bridge.load_flax_variables(self.gen, variables)

    @torch.inference_mode()
    def features(self, images: np.ndarray) -> np.ndarray:
        """Discriminator features of (B, H, W, 3) float images."""
        x = torch.from_numpy(np.asarray(images, np.float32)).to(self.device)
        return self.disc(x.permute(0, 3, 1, 2), features=True).cpu().numpy()

    @torch.inference_mode()
    def fake_features(self, z: torch.Tensor) -> torch.Tensor:
        """Features of G(z), on the device: the fake batch stays there."""
        fake = self.gen(z, train=False)
        if self.quirk_range_mismatch:
            fake = (fake + 1.0) / 2.0  # create_samples' [0, 1] output
        return self.disc(fake, features=True)

    def evaluate(
        self, dataset=None, batch_size: int = 32, step_size: int = 1,
        start_epoch: int = 0, disc_epoch: int | None = None,
        continue_: bool = False,
    ) -> dict[int, list[float]]:
        """Per-epoch FID lists (one value per pinned batch), resumable."""
        t0 = time.perf_counter()
        if not continue_:
            if dataset is None:
                raise ValueError("dataset required unless continuing")
            if disc_epoch is None:
                found = find_epoch_files(self._models("discriminator"), DISC_PATTERN)
                if not found:
                    raise FileNotFoundError(
                        f"no discriminator exports under {self._models('discriminator')}")
                disc_epoch = found[-1][0]
            init = self.init_fid_evaluation(
                dataset, batch_size, step_size, start_epoch, disc_epoch)
        else:
            init = self.load_init()
        self.pin_seconds = time.perf_counter() - t0

        results_file = Path(self.output_dir) / "fids.pickle"
        results: dict[int, list[float]] = {}
        if results_file.exists():
            with open(results_file, "rb") as f:
                results = pickle.load(f)  # written below by an earlier run

        self.load_disc(init["disc_epoch"])
        real_feats = [self.features(x) for x in init["img_real_used"]]
        zs = [torch.from_numpy(np.asarray(z, np.float32)).to(self.device)
              for z in init["random_z_used"]]
        self.epoch_seconds = {}
        for epoch in init["epochs_used"]:
            if epoch in results:
                continue  # resumability (generator_evaluation.py:155-157)
            t0 = time.perf_counter()
            self.load_gen(epoch)
            fake_feats = [self.fake_features(z).cpu().numpy() for z in zs]
            t1 = time.perf_counter()
            fids = [calculate_fid_from_features(ff, rf, self.sqrtm_method, self.device)
                    for ff, rf in zip(fake_feats, real_feats)]
            self.epoch_seconds[epoch] = {
                "features": t1 - t0, "fid": time.perf_counter() - t1}
            results[epoch] = fids
            with open(results_file, "wb") as f:
                pickle.dump(results, f)
            print(f"epoch {epoch}: FID mean {np.mean(fids):.4f}")
        return results

    # --------------------------------------------------------------- plots
    def plot(self, results: dict[int, list[float]]) -> None:
        """Boxplot and mean-line plot (generator_evaluation.py:202-245);
        needs matplotlib."""
        plt = previewlib.pyplot()
        epochs = sorted(results)
        data = [results[e] for e in epochs]
        plt.clf()
        plt.boxplot(data, tick_labels=[str(e) for e in epochs])
        plt.xlabel("Epoch")
        plt.ylabel("FID")
        plt.savefig(path.join(self.output_dir, "fids_boxplot.png"))
        plt.close()
        plt.clf()
        plt.plot(epochs, [float(np.mean(d)) for d in data])
        plt.xlabel("Epoch")
        plt.ylabel("FID")
        plt.savefig(path.join(self.output_dir, "fids_line.png"))
        plt.close()
