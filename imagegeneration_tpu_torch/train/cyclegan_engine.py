"""CycleGAN training engine: paired loader, auto-resume, loss history.

The counterpart of imagegeneration_tpu/train/cyclegan_engine.py (itself the
reference class `CycleGAN`, cyclegan/CycleGAN.py:211-425), on one device or
on the ranks of a data-parallel group:

- the directory scaffold (`path`, `checkpoints/`, `models/generator_{f,g}/`)
  is created and never wiped;
- the latest checkpoint is restored UNCONDITIONALLY (the reference quirk of
  CycleGAN.py:263-269: the trainer's -ct flag is parsed but never
  forwarded), and the epoch numbering continues from it;
- two label-free image folders are zipped per batch, full batches only
  (core/data.PairedDataset);
- every epoch: the mean of the 7 tracked losses is appended to
  `losses.pickle`, a line to `perf.jsonl`, a checkpoint of the whole train
  state is saved (numbered epoch + 1, `max_to_keep=5`) and the preview
  sheet `preview.pdf` is drawn: the first two images of the epoch's last
  X batch go through BOTH generators (the reference quirk of :408-409);
- every `checkpoint_frequency` epochs: the params-only generator exports
  `models/generator_{f,g}/gen_weights_{f,g}-<epoch>.msgpack` ({params})
  (:414-420);
- after `train()`: the loss plot `plot_line_plot_loss.png`.

`profile=True` traces the second epoch of the `train()` call with
torch.profiler into `<path>/traces/` (core/metrics.ProfilerHook; one file
per rank).

The preview sheet and the loss plot need matplotlib; without it (the GPU
machine) the engine prints one line when it is built and draws neither.

The data path is `train/feed.EpochFeed`: both domains resident on the
device when together they fit, streamed from the host otherwise, each in
the order of its own permutation.

Data parallelism (`mesh`, a core.mesh.DataGroup): as in the SNDCGAN
engine, `batch_size` is global, rank 0 alone makes the scaffold (a barrier
follows) and writes every artifact, every rank restores, the state is
broadcast from rank 0 and its digest checked after every epoch, and the
epoch's metrics are averaged over the ranks with one all-reduce.
`host_sharded_data=True` with folders: each data block decodes only its
shard of each domain's files; rank 0 prints once per epoch how many rows
the epoch leaves out. A group with a spatial factor > 1 trains
H-partitioned (the JAX engine's `spatial=True`; `spatial=None` follows the
group): the request is first held to core/mesh.check_spatial_partition at
the generator's H/4 maps, before the engine touches its directory, and
each rank takes its block of image rows of both domains (train/feed.py).
"""

from __future__ import annotations

import os
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
from imagegeneration_tpu_torch.models import cyclegan as modellib
from imagegeneration_tpu_torch.parallel import dp
from imagegeneration_tpu_torch.train import cyclegan_step as steplib
from imagegeneration_tpu_torch.train import feed as feedlib

LOSS_KEYS = (
    "gen_g_loss", "gen_f_loss", "identity_loss_g", "identity_loss_f",
    "total_gen_g_loss", "total_gen_f_loss", "total_cycle_loss",
)


class CycleGANEngine:
    def __init__(
        self,
        dataset1_path,  # a folder, or any object with images/permutation
        dataset2_path,
        path_like: str,
        batch_size: int,
        image_size: tuple[int, int],  # (width, height), as the reference passes it
        *,
        device: torch.device,
        quirk_axis1: bool = False,
        base_width: int = 64,
        n_res_blocks: int = 9,
        dtype: torch.dtype = torch.float32,
        seed: int = rnglib.DEFAULT_MODEL_SEED,
        mesh=None,
        host_sharded_data: bool = False,
        spatial: bool | None = None,
        profile: bool = False,
    ) -> None:
        self.profile = profile
        w, h = image_size
        self.cfg = steplib.CycleGANTrainConfig(
            model=modellib.CycleGANConfig(
                image_size=(h, w, 3), base_width=base_width,
                n_res_blocks=n_res_blocks, quirk_axis1=quirk_axis1, dtype=dtype,
            ),
            batch_size=batch_size,
            seed=seed,
        )
        meshlib.check_engine_spatial(mesh, spatial, modellib.min_sharded_height(self.cfg.model),
                                     "cyclegan", h)
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        if self.is_main:
            for d in ("", path.join("models", "generator_f"), path.join("models", "generator_g")):
                os.makedirs(path.join(path_like, d), exist_ok=True)
        dp.barrier(mesh)  # no rank touches the directory before rank 0 has made it
        self.path = path_like
        self.preview_output = path.join(path_like, "preview")
        self.device = torch.device(device)
        shard = (mesh.d, mesh.data) if host_sharded_data and mesh else None
        if isinstance(dataset1_path, (str, os.PathLike)):
            dataset1_path = datalib.ImageFolderDataset(dataset1_path, (h, w), labeled=False,
                                                       shard=shard)
        if isinstance(dataset2_path, (str, os.PathLike)):
            dataset2_path = datalib.ImageFolderDataset(dataset2_path, (h, w), labeled=False,
                                                       shard=shard)
        self.loader = datalib.PairedDataset(dataset1_path, dataset2_path)
        self.batch_size = batch_size
        self.state = steplib.init_state(self.cfg, self.device)
        self.feed = feedlib.EpochFeed(
            [self.loader.ds_x, self.loader.ds_y], self.cfg, self.device, steplib, mesh)
        self.resident = self.feed.resident
        self.num_batches = self.feed.num_batches
        if self.num_batches < 1:
            raise ValueError(f"the two domains have no common full batch of {batch_size}")
        self.translate_g, self.translate_f = steplib.make_translators()
        self.last_epoch_metrics: dict[str, float] | None = None

        self.plots = self.is_main and previewlib.matplotlib_available(
            f"the preview sheet {self.preview_output}.pdf or plot_line_plot_loss.png")
        self.losses = metricslib.LossHistory(path.join(path_like, "losses.pickle"), LOSS_KEYS)
        self.ckpt_manager = ckptlib.CheckpointManager(
            path.join(path_like, "checkpoints"), max_to_keep=5)
        # Unconditional auto-resume (CycleGAN.py:263-269).
        latest = self.ckpt_manager.latest_epoch()
        if latest is not None:
            self.state.load_state_dict(self.ckpt_manager.restore())
            self.epoch = latest
        else:
            self.epoch = 0
        self.last_digest = dp.replicate_state(self.state, mesh)
        self._say("Latest checkpoint restored!!" if latest is not None
                  else "No checkpoints were restored!!")
        self._say("Initialized CycleGAN SUCCESS!")

    def _say(self, text: str) -> None:
        if self.is_main:
            print(text, flush=True)

    # ------------------------------------------------------------- preview
    def plot_history(self) -> None:
        self.losses.plot(path.join(self.path, "plot_line_plot_loss.png"))

    def _preview(self, perms, epoch: int) -> None:
        """The first two images of the epoch's last X and Y batches; the X
        pair goes through both generators (CycleGAN.py:408-409); under data
        parallelism, rank 0's rows of those batches."""
        last = self.num_batches - 1
        bx01, by01 = (ds.images[self.feed.rows_of(p, last)[:2]].astype(np.float32) / 127.5 - 1.0
                      for ds, p in zip(self.feed.datasets, perms))
        x = torch.from_numpy(bx01).to(self.device)
        out_g = self.translate_g(self.state, x).cpu().numpy()
        out_f = self.translate_f(self.state, x).cpu().numpy()
        previewlib.translation_sheet(bx01, by01, out_g, out_f, epoch,
                                     self.preview_output + ".pdf")

    def _save_artifacts(self, perms, epoch: int, checkpoint_frequency: int) -> None:
        self.ckpt_manager.save(self.epoch, self.state.state_dict())
        if self.plots:
            self._preview(perms, epoch)
        if epoch % checkpoint_frequency == 0:
            models = path.join(self.path, "models")
            for name, gen in (("f", self.state.gen_f), ("g", self.state.gen_g)):
                ckptlib.export_params(
                    path.join(models, f"generator_{name}", f"gen_weights_{name}-{epoch}.msgpack"),
                    bridge.export_variables(gen))
        self.losses.save()

    # --------------------------------------------------------------- train
    def train(self, epochs: int, checkpoint_frequency: int = 5) -> None:
        """Train `epochs` more epochs; the train state is checkpointed every
        epoch, the generators exported every `checkpoint_frequency`."""
        start_time = perf_counter()
        watch = metricslib.Stopwatch()
        profiler = metricslib.ProfilerHook(self.path, self.profile, self.device,
                                           0 if self.mesh is None else self.mesh.rank)
        first_real_epoch = self.epoch + 1  # the second epoch of this call
        for _ in range(epochs):
            watch.epoch_start()
            epoch = self.epoch
            profiler.maybe_start(epoch, first_real_epoch)
            self._say(f"####### Epoch {epoch} #######")
            perms = [ds.permutation(epoch) for ds in self.feed.datasets]
            self.state, metrics = self.feed.run(self.state, perms)
            metrics = dp.reduce_metrics(metrics, self.mesh)
            # The epoch's one host sync: the device finishes its steps here.
            agg = {k: float(v.float().mean()) for k, v in metrics.items()}
            n_steps = self.num_batches
            profiler.maybe_stop()
            perf = watch.epoch_report(n_steps, n_steps * self.batch_size)
            self.last_digest = dp.check_replicated(self.state, self.mesh)
            if self.feed.dropped:
                self._say(f"host-sharded data: {self.feed.dropped} rows left out this epoch")
            if self.is_main:
                metricslib.write_metrics_jsonl(
                    path.join(self.path, "perf.jsonl"),
                    {"epoch": epoch, "device": platform.device_name(self.device),
                     "ranks": 1 if self.mesh is None else self.mesh.world, **perf})
            self.losses.extend({k: [agg[k]] for k in LOSS_KEYS})
            self.last_epoch_metrics = agg
            self._say(
                f">Gen losses (g/f): {agg['gen_g_loss']:.4f}/{agg['gen_f_loss']:.4f},"
                f" identity: {agg['identity_loss_g']:.4f}/{agg['identity_loss_f']:.4f},"
                f" cycle: {agg['total_cycle_loss']:.4f},"
                f" total: {agg['total_gen_g_loss']:.4f}/{agg['total_gen_f_loss']:.4f},"
                f" {perf['steps_per_sec']:.2f} steps/s,"
                f" passed time: {strftime('%H:%M:%S', gmtime(perf_counter() - start_time))}")
            self.epoch = epoch + 1
            if self.is_main:
                self._save_artifacts(perms, epoch, checkpoint_frequency)
            dp.barrier(self.mesh)  # a resume on any rank finds the checkpoint
        if self.plots:
            self.plot_history()
