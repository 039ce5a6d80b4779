"""SNDCGAN training engine: epoch loop, checkpoint/resume, loss history.

The counterpart of imagegeneration_tpu/train/sndcgan_engine.py (itself the
reference class `SNDCGAN`, sndcgan/SNDCGAN.py:148-335), on one device or
on the ranks of a data-parallel group:

- the constructor wipes the output directory unless continuing, loads
  `losses.pickle`, keeps `max_to_keep=2` checkpoints and restores the
  latest one when `continue_`;
- `train(num_epochs, checkpoint_frequency)` runs epochs [start,
  num_epochs); every epoch it appends a line to `perf.jsonl`, and every
  `preview_frequency` epochs (epoch % preview_frequency == 0; 1, the
  reference's every epoch, by default) it draws a 3-image live preview
  into `<live_output>.pdf` (SNDCGAN.py:311-314);
  every `checkpoint_frequency` epochs it checkpoints the whole train state,
  appends + pickles the loss history, writes the params-only exports
  `models/generator/gen_model-<e>.msgpack` ({params, batch_stats}) and
  `models/discriminator/disc_model-<e>.msgpack` ({params, spectral}) and
  redraws `plot_line_plot_loss.png` (:317-333).

`profile=True` traces the run's second epoch with torch.profiler into
`<dir>/traces/` (core/metrics.ProfilerHook; one file per rank).

The preview and the loss plot need matplotlib; without it (the GPU
machine) the engine prints one line when it is built and draws neither.

The data path is `train/feed.EpochFeed`: resident on the device when the
dataset fits, streamed from the host otherwise. As in the JAX engine, a
resident epoch takes its order from the engine's "data" stream and a
streamed one from the dataset's own.

Data parallelism (`mesh`, a core.mesh.DataGroup; the JAX engine's `mesh=`):
every rank builds the engine; `batch_size` is the global batch and each
rank trains on its rows (train/feed.py, parallel/dp.py). Rank 0 alone
wipes the directory (the others wait at a barrier before they touch it)
and writes every artifact: checkpoints, exports, losses.pickle,
perf.jsonl (global images/s) and figures. Every rank restores on
`continue_`; the state is then broadcast from rank 0, and after every
epoch the ranks' state digests are checked equal (`last_digest`). The
epoch's metrics are averaged over the ranks with one all-reduce.
`host_sharded_data=True` with a folder: each data block decodes only its
shard of the files (core/data.py), and rank 0 prints once per epoch how
many rows the epoch leaves out. A group with a spatial factor > 1 trains
H-partitioned (the JAX engine's `spatial=True`; `spatial=None` follows the
group): the request is first held to core/mesh.check_spatial_partition at
the model's `min_sharded_height`, as the JAX engine holds it.
"""

from __future__ import annotations

import os
import shutil
from os import path
from time import gmtime, perf_counter, strftime

import numpy as np
import torch

from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.core import checkpoint as ckptlib
from imagegeneration_tpu_torch.core import data as datalib
from imagegeneration_tpu_torch.core import mesh as meshlib
from imagegeneration_tpu_torch.core import metrics as metricslib
from imagegeneration_tpu_torch.core import platform
from imagegeneration_tpu_torch.core import preview as previewlib
from imagegeneration_tpu_torch.core import rng as rnglib
from imagegeneration_tpu_torch.models import sndcgan as modellib
from imagegeneration_tpu_torch.parallel import dp
from imagegeneration_tpu_torch.train import feed as feedlib
from imagegeneration_tpu_torch.train import sndcgan_step as steplib

LOSS_KEYS = ("epoch", "avg_g_loss", "avg_d_loss", "d_real", "d_fake")


class SNDCGANEngine:
    """Capability match for the reference SNDCGAN trainer class."""

    def __init__(
        self,
        dir_path: str,
        dataset,  # path to an image folder, or any object with images/permutation
        batch_size: int,
        dropout: float = 0.5,
        learning_rate_disc: float = 2e-4,
        learning_rate_gen: float = 2e-4,
        continue_: bool = False,
        image_size: tuple[int, int, int] = (144, 256, 3),
        z_size: int = 128,
        *,
        device: torch.device,
        spectral_norm: bool = False,
        loss: str = "bce",
        d_updates: int = 2,
        quirk_eval_bn: bool = False,
        base_width: int = 512,
        dtype: torch.dtype = torch.float32,
        seed: int = rnglib.DEFAULT_MODEL_SEED,
        live_output: str = "live",
        mesh=None,
        host_sharded_data: bool = False,
        spatial: bool | None = None,
        profile: bool = False,
        preview_frequency: int = 1,
    ) -> None:
        self.profile = profile
        self.preview_frequency = max(1, preview_frequency)
        self.cfg = steplib.SNDCGANTrainConfig(
            model=modellib.SNDCGANConfig(
                image_size=image_size, z_size=z_size, dropout_rate=dropout,
                base_width=base_width, spectral_norm=spectral_norm,
                quirk_eval_bn=quirk_eval_bn, dtype=dtype,
            ),
            batch_size=batch_size,
            lr_gen=learning_rate_gen,
            lr_disc=learning_rate_disc,
            loss=loss,
            d_updates=d_updates,
            seed=seed,
        )
        meshlib.check_engine_spatial(mesh, spatial, modellib.min_sharded_height(self.cfg.model),
                                     "sndcgan", image_size[0])
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        if self.is_main:
            if not continue_ and os.path.exists(dir_path):
                shutil.rmtree(dir_path)
            os.makedirs(dir_path, exist_ok=True)
        dp.barrier(mesh)  # no rank touches the directory before rank 0 has made it
        self.dir_path = dir_path
        self.device = torch.device(device)
        if isinstance(dataset, (str, os.PathLike)):
            shard = (mesh.d, mesh.data) if host_sharded_data and mesh else None
            dataset = datalib.ImageFolderDataset(dataset, image_size[:2], labeled=True,
                                                 shard=shard)
        self.dataset = dataset
        self.batch_size = batch_size
        self.chain = rnglib.KeyChain(seed)
        self.state = steplib.init_state(self.cfg, self.device)
        self.feed = feedlib.EpochFeed([dataset], self.cfg, self.device, steplib, mesh)
        self.resident = self.feed.resident
        self.num_batches = self.feed.num_batches
        if self.num_batches < 1:
            raise ValueError(f"dataset of {len(dataset.images)} images has no full batch "
                             f"of {batch_size}")
        self._sample = steplib.make_sampler(self.cfg)
        self.last_epoch_metrics: dict[str, float] | None = None

        self.live_preview_file = live_output + ".pdf"
        self.plots = self.is_main and previewlib.matplotlib_available(
            f"the live preview {self.live_preview_file} or plot_line_plot_loss.png")
        self.losses = metricslib.LossHistory(
            path.join(dir_path, "losses.pickle"), LOSS_KEYS
        )
        self.ckpt_manager = ckptlib.CheckpointManager(
            path.join(dir_path, "checkpoints"), max_to_keep=2
        )
        restored = continue_ and self.ckpt_manager.latest_epoch() is not None
        if restored:
            self.state.load_state_dict(self.ckpt_manager.restore())
            self.start_epoch = self.ckpt_manager.latest_epoch() + 1
        else:
            self.start_epoch = 0
        self.last_digest = dp.replicate_state(self.state, mesh)
        self._say("Latest checkpoint restored!!" if restored else "No checkpoints were restored!!")

        n_g = sum(p.numel() for p in self.state.gen.parameters())
        n_d = sum(p.numel() for p in self.state.disc.parameters())
        self._say(f"Generator params: {n_g:,} | Discriminator params: {n_d:,}")
        self._say("\nInitialized SNDCGAN successfully!\n")

    def _say(self, text: str) -> None:
        if self.is_main:
            print(text, flush=True)

    def sample(self, z: torch.Tensor) -> np.ndarray:
        """G(z) in [0, 1], (B, H, W, C) (generator_output semantics)."""
        return self._sample(self.state, z.to(self.device)).cpu().numpy()

    def plot_history(self) -> None:
        self.losses.plot(path.join(self.dir_path, "plot_line_plot_loss.png"))

    def _save_artifacts(self, epoch: int) -> None:
        self.ckpt_manager.save(epoch, self.state.state_dict())
        self.losses.save()
        models = path.join(self.dir_path, "models")
        ckptlib.export_params(
            path.join(models, "generator", f"gen_model-{epoch}.msgpack"),
            bridge.export_variables(self.state.gen))
        ckptlib.export_params(
            path.join(models, "discriminator", f"disc_model-{epoch}.msgpack"),
            bridge.export_variables(self.state.disc))
        if self.plots:
            self.plot_history()

    # --------------------------------------------------------------- train
    def train(self, num_epochs: int, checkpoint_frequency: int = 5) -> None:
        start_time = perf_counter()
        watch = metricslib.Stopwatch()
        profiler = metricslib.ProfilerHook(self.dir_path, self.profile, self.device,
                                           0 if self.mesh is None else self.mesh.rank)
        local = {k: [] for k in LOSS_KEYS}

        for epoch in range(self.start_epoch, num_epochs):
            watch.epoch_start()
            profiler.maybe_start(epoch, self.start_epoch + 1)
            if self.resident:
                perm = self.chain.numpy_rng("data", epoch).permutation(len(self.dataset.images))
            else:
                perm = self.dataset.permutation(epoch)
            self.state, metrics = self.feed.run(self.state, [perm])
            metrics = dp.reduce_metrics(metrics, self.mesh)
            n_steps = self.num_batches
            # The epoch's one host sync: the device finishes its steps here.
            agg = {k: float(v.float().mean()) for k, v in metrics.items()}
            profiler.maybe_stop()
            perf = watch.epoch_report(n_steps, n_steps * self.batch_size)
            self.last_digest = dp.check_replicated(self.state, self.mesh)
            if self.feed.dropped:
                self._say(f"host-sharded data: {self.feed.dropped} rows left out this epoch")
            if self.is_main:
                metricslib.write_metrics_jsonl(
                    path.join(self.dir_path, "perf.jsonl"),
                    {"epoch": epoch, "device": platform.device_name(self.device),
                     "ranks": 1 if self.mesh is None else self.mesh.world, **perf},
                )
            local["epoch"].append(epoch)
            local["avg_g_loss"].append(agg["g_loss"])
            local["avg_d_loss"].append(agg["d_loss"])
            local["d_real"].append(agg["d_loss_real"])
            local["d_fake"].append(agg["d_loss_fake"])
            self.last_epoch_metrics = agg

            info_text = (
                "Epoch {:04d} | ET {} min | Avg Losses G/D {:.4f}/{:.4f} "
                "[D-Real: {:.4f} D-Fake {:.4f}] | {:.2f} steps/s".format(
                    epoch,
                    strftime("%H:%M:%S", gmtime(perf_counter() - start_time)),
                    agg["g_loss"], agg["d_loss"], agg["d_loss_real"],
                    agg["d_loss_fake"], perf["steps_per_sec"],
                )
            )
            self._say(info_text)
            # The reference's per-epoch preview (SNDCGAN.py:311-314), every
            # preview_frequency epochs.
            if self.plots and epoch % self.preview_frequency == 0:
                gen = self.chain.generator("preview", self.device, step=epoch)
                z = rnglib.uniform_z(gen, 3, self.cfg.model.z_size, self.device)
                previewlib.live_preview(self.sample(z), info_text, self.live_preview_file)
            if epoch % checkpoint_frequency == 0:
                self.losses.extend(local)
                local = {k: [] for k in LOSS_KEYS}
                if self.is_main:
                    self._save_artifacts(epoch)
                dp.barrier(self.mesh)  # a resume on any rank finds the checkpoint
