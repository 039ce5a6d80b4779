"""WGAN training engine: epoch loop, n_critic history windows, checkpoints.

The counterpart of imagegeneration_tpu/train/wgan_engine.py (itself the
reference class `WGAN`, wasserstein_gan/WGAN.py:155-326), on one device or
on the ranks of a data-parallel group:

- the directory scaffold `g_models/`, `c_models/`, `samples/` is wiped
  unless `load` (WGAN.py:161-167);
- a label-free image folder (symlinks followed), or any dataset object
  with images/permutation/num_batches;
- epochs are 1-based: `self.epoch` is the last finished one, and a resume
  (`load=True`) restores the latest checkpoint of the whole train state
  and continues from its epoch; `train(epochs)` runs up to epoch `epochs`;
- the loss history is kept exactly as the reference keeps it (WGAN.py:
  284-318): c1 and c2 are averaged over each window of batches that ends
  at a gan update and appended with that update's g; the open window is
  reset at each `train()` call; `stats.pickle` holds {c1_hist, c2_hist,
  g_hist};
- every epoch (`summarize_performance`, WGAN.py:251-268): a line to
  `perf.jsonl`, the reference's console line, a checkpoint numbered with
  the epoch (`max_to_keep=2`), `stats.pickle`, the 10x10 sample sheet
  `samples/generated_plot_%04d.jpg` and the params-only exports
  `g_models/model_%04d.msgpack` and `c_models/model_%04d.msgpack`
  ({params, batch_stats}); the previous epoch's exports are removed unless
  that epoch is a multiple of `save_interval` (the trainer's `-c`);
- after `train()`, the loss plot `plot_line_plot_loss_<epoch>.png` with the
  reference's series labels (WGAN.py:270-277).

`learning_rate` is RMSprop's (the reference's 5e-5 by default), and
`profile=True` traces the run's second epoch with torch.profiler into
`<path>/traces/` (core/metrics.ProfilerHook; one file per rank).

The sample sheet and the loss plot need matplotlib; without it (the GPU
machine) the engine prints one line when it is built and draws neither.

The data path is `train/feed.EpochFeed`: resident on the device when the
dataset fits, streamed from the host otherwise, both in the order of the
dataset's own permutation, so they train alike.

Data parallelism (`mesh`, a core.mesh.DataGroup): as in the SNDCGAN
engine, `batch_size` is global, rank 0 alone wipes the scaffold (a barrier
follows) and writes every artifact, every rank restores on `load`, the
state is broadcast from rank 0 and its digest checked after every epoch,
and the epoch's metrics are averaged over the ranks with one all-reduce.
`host_sharded_data=True` with a folder: each data block decodes only its
shard of the files; rank 0 prints once per epoch how many rows the epoch
leaves out. A group with a spatial factor > 1 trains H-partitioned (as the
SNDCGAN engine: `spatial=`, and the guard at construction).
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
from imagegeneration_tpu_torch.models import wgan as modellib
from imagegeneration_tpu_torch.parallel import dp
from imagegeneration_tpu_torch.train import feed as feedlib
from imagegeneration_tpu_torch.train import wgan_step as steplib

HIST_KEYS = ("c1_hist", "c2_hist", "g_hist")


class WGANEngine:
    def __init__(
        self,
        dataset,  # folder path or dataset object (label-free)
        image_size: tuple[int, int, int],
        batch_size: int,
        critic_learn_iterations: int = 5,
        path_like: str = "training",
        load: bool = False,
        save_interval: int = 20,
        *,
        device: torch.device,
        learning_rate: float = 5e-5,
        gp_lambda: float = 0.0,
        base_width: int = 512,
        dtype: torch.dtype = torch.float32,
        seed: int = rnglib.DEFAULT_MODEL_SEED,
        mesh=None,
        host_sharded_data: bool = False,
        spatial: bool | None = None,
        profile: bool = False,
    ) -> None:
        self.profile = profile
        self.cfg = steplib.WGANTrainConfig(
            model=modellib.WGANConfig(image_size=image_size, base_width=base_width,
                                      dtype=dtype),
            batch_size=batch_size,
            n_critic=critic_learn_iterations,
            learning_rate=learning_rate,
            gp_lambda=gp_lambda,
            seed=seed,
        )
        meshlib.check_engine_spatial(mesh, spatial, modellib.min_sharded_height(self.cfg.model),
                                     "wgan", image_size[0])
        self.path = path_like
        self.save_interval = save_interval
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        if self.is_main:
            if not load and path.exists(path_like):
                shutil.rmtree(path_like)
            for sub in ("g_models", "c_models", "samples"):
                os.makedirs(path.join(path_like, sub), exist_ok=True)
        dp.barrier(mesh)  # no rank touches the directory before rank 0 has made it
        self.device = torch.device(device)
        if isinstance(dataset, (str, os.PathLike)):
            shard = (mesh.d, mesh.data) if host_sharded_data and mesh else None
            dataset = datalib.ImageFolderDataset(
                dataset, image_size[:2], labeled=False, follow_links=True, shard=shard)
        self.dataset = dataset
        self.batch_size = batch_size
        self.chain = rnglib.KeyChain(seed)
        self.state = steplib.init_state(self.cfg, self.device)
        self.latent_dim = self.cfg.model.z_size
        self.feed = feedlib.EpochFeed([dataset], self.cfg, self.device, steplib, mesh)
        self.resident = self.feed.resident
        self.num_batches = self.feed.num_batches
        if self.num_batches < 1:
            raise ValueError(
                f"dataset of {len(dataset)} images has no full batch of {batch_size}")
        self._sample = steplib.make_sampler(self.cfg)
        self.last_epoch_metrics: dict[str, float] | None = None
        self._c1_tmp: list[float] = []
        self._c2_tmp: list[float] = []

        self.plots = self.is_main and previewlib.matplotlib_available(
            "samples/generated_plot_<epoch>.jpg or plot_line_plot_loss_<epoch>.png")
        self.loss_hist = metricslib.LossHistory(path.join(path_like, "stats.pickle"), HIST_KEYS)
        self.ckpt_manager = ckptlib.CheckpointManager(
            path.join(path_like, "checkpoints"), max_to_keep=2)
        latest = self.ckpt_manager.latest_epoch()
        if load and latest is not None:
            self.state.load_state_dict(self.ckpt_manager.restore())
            self.epoch = latest
            self._say(f"Restored WGAN state at epoch {self.epoch}")
        else:
            self.epoch = 0
        self.last_digest = dp.replicate_state(self.state, mesh)
        self._say("Initialized WGAN SUCCESS!")

    def _say(self, text: str) -> None:
        if self.is_main:
            print(text, flush=True)

    # ------------------------------------------------------------- sampling
    def generate_fake_samples(self, n_samples: int) -> np.ndarray:
        """n fake images (n, H, W, C) in [0, 1] from the epoch's "preview"
        draw (WGAN.py:220-227)."""
        gen = self.chain.generator("preview", self.device, step=self.epoch)
        z = rnglib.normal_z(gen, n_samples, self.latent_dim, self.device)
        return self._sample(self.state, z).cpu().numpy()

    def summarize_performance(self, step: int) -> None:
        """The epoch's checkpoint, history, 10x10 sample sheet and exports
        (WGAN.py:251-268)."""
        self.ckpt_manager.save(step, self.state.state_dict())
        if self.plots:
            previewlib.sample_grid(
                self.generate_fake_samples(100), 10, 10,
                path.join(self.path, "samples", f"generated_plot_{step:04d}.jpg"))
        self.loss_hist.save()
        # remove the previous exports off the save interval (WGAN.py:255-261)
        if (step - 1) % self.save_interval != 0:
            for folder in ("g_models", "c_models"):
                prev = path.join(self.path, folder, f"model_{step - 1:04d}.msgpack")
                if path.exists(prev):
                    os.remove(prev)
        fname = f"model_{step:04d}.msgpack"
        ckptlib.export_params(path.join(self.path, "g_models", fname),
                              bridge.export_variables(self.state.gen))
        ckptlib.export_params(path.join(self.path, "c_models", fname),
                              bridge.export_variables(self.state.critic))
        print(f">Saved: generated_plot_{step:04d}.jpg and {fname}" if self.plots
              else f">Saved: {fname}")

    def plot_history(self) -> None:
        """The loss plot with the reference's series labels (WGAN.py:270-277)."""
        plt = previewlib.pyplot()
        plt.clf()
        plt.plot(self.loss_hist.data["c1_hist"], label="crit_real loss")
        plt.plot(self.loss_hist.data["c2_hist"], label="crit_fake loss")
        plt.plot(self.loss_hist.data["g_hist"], label="gen loss")
        plt.legend()
        plt.savefig(path.join(self.path, f"plot_line_plot_loss_{self.epoch}.png"))
        plt.close()

    # ---------------------------------------------------------------- train
    def _fold_metrics(self, c1, c2, g, did) -> None:
        """The reference's history bookkeeping (WGAN.py:284-318): c1/c2 go
        into the open window; at each gan update the window's means and
        that update's g are appended and the window starts again."""
        for i in range(len(c1)):
            self._c1_tmp.append(float(c1[i]))
            self._c2_tmp.append(float(c2[i]))
            if did[i] > 0.5:
                self.loss_hist.extend({
                    "c1_hist": [float(np.mean(self._c1_tmp))],
                    "c2_hist": [float(np.mean(self._c2_tmp))],
                    "g_hist": [float(g[i])],
                })
                self._c1_tmp, self._c2_tmp = [], []

    def train(self, epochs: int) -> None:
        """Train until `epochs` epochs are done in all (the reference's
        count, resumed runs included)."""
        self._c1_tmp, self._c2_tmp = [], []
        start_time = perf_counter()
        watch = metricslib.Stopwatch()
        profiler = metricslib.ProfilerHook(self.path, self.profile, self.device,
                                           0 if self.mesh is None else self.mesh.rank)
        first_real_epoch = self.epoch + 2  # epochs count from 1: the run's second
        for _ in range(epochs - self.epoch):
            self.epoch += 1
            watch.epoch_start()
            profiler.maybe_start(self.epoch, first_real_epoch)
            self._say(f"####### Epoch {self.epoch} "
                      f"Time: {strftime('%H:%M:%S', gmtime(perf_counter() - start_time))} #######")
            self.state, metrics = self.feed.run(
                self.state, [self.dataset.permutation(self.epoch)])
            metrics = dp.reduce_metrics(metrics, self.mesh)
            # The epoch's one host sync: the device finishes its steps here.
            c1, c2, g, did = torch.stack(
                [metrics[k].float() for k in steplib.METRIC_KEYS]).cpu().numpy()
            self._fold_metrics(c1, c2, g, did)
            n_steps = len(c1)
            profiler.maybe_stop()
            perf = watch.epoch_report(n_steps, n_steps * self.batch_size)
            self.last_digest = dp.check_replicated(self.state, self.mesh)
            if self.feed.dropped:
                self._say(f"host-sharded data: {self.feed.dropped} rows left out this epoch")
            if self.is_main:
                metricslib.write_metrics_jsonl(
                    path.join(self.path, "perf.jsonl"),
                    {"epoch": self.epoch, "device": platform.device_name(self.device),
                     "ranks": 1 if self.mesh is None else self.mesh.world, **perf})
            first_step = int(self.state.step) - n_steps + 1
            self.last_epoch_metrics = {
                "c_loss_real": float(c1.mean()), "c_loss_fake": float(c2.mean()),
                "g_loss": float(g[did > 0.5].mean()) if did.any() else 0.0,
                "gan_updates": int(did.sum()),
                # 1-based global steps that ran a gan update
                "gan_update_steps": [first_step + int(i) for i in np.flatnonzero(did > 0.5)],
            }
            if self.loss_hist.data["c1_hist"]:
                self._say(">RealLoss=%.3f, FakeLoss=%.3f GeneratorLoss=%.3f | %.2f steps/s" % (
                    self.loss_hist.data["c1_hist"][-1], self.loss_hist.data["c2_hist"][-1],
                    self.loss_hist.data["g_hist"][-1], perf["steps_per_sec"]))
            if self.is_main:
                self.summarize_performance(self.epoch)
            dp.barrier(self.mesh)  # a resume on any rank finds the checkpoint
        if self.plots:
            self.plot_history()
