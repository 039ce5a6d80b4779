"""The engines' data path: one epoch of a train step over uint8 datasets.

Shared by the SNDCGAN and WGAN engines (one dataset) and the CycleGAN
engine (two domains, zipped per batch). The datasets are resident on the
device when their images together fit `core.data.resident_budget`: an
epoch is then the step library's epoch runner over permutation gathers,
the images uploaded once. Otherwise pinned host batches stream through a
prefetch thread (depth 2). Both paths take the orders the engine passes,
so they train alike, and return the metrics stacked over the steps, still
on the device, for the epoch's one host sync.
"""

from __future__ import annotations

from types import ModuleType
from typing import Sequence

import numpy as np
import torch

from imagegeneration_tpu_torch.core import data as datalib


class EpochFeed:
    def __init__(self, datasets: Sequence, cfg, device: torch.device,
                 steplib: ModuleType) -> None:
        """`steplib` is a step module: its `make_train_step(cfg)` step takes
        `(state, *batches)` and its `make_epoch_runner(cfg)` runner takes
        `(state, *images, *index_tables)`, one of each per dataset."""
        self.datasets = tuple(datasets)
        self.batch_size = cfg.batch_size
        self.device = device
        self.num_batches = min(len(ds.images) for ds in self.datasets) // self.batch_size
        nbytes = sum(ds.images.nbytes for ds in self.datasets)
        self.resident = nbytes <= datalib.resident_budget(device)
        self.step = steplib.make_train_step(cfg)
        self._runner = steplib.make_epoch_runner(cfg) if self.resident else None
        self._images: list[torch.Tensor] | None = None

    def run(self, state, perms: Sequence[np.ndarray]):
        """One epoch, each dataset in the order of its permutation in
        `perms`: `(state, {metric: (num_batches,) device tensor})`."""
        nb, bs = self.num_batches, self.batch_size
        if self.resident:
            if self._images is None:
                self._images = [torch.from_numpy(ds.images).to(self.device)
                                for ds in self.datasets]
            tables = [torch.from_numpy(p[:nb * bs].reshape(nb, bs)).to(self.device)
                      for p in perms]
            return self._runner(state, *self._images, *tables)
        host = ([ds.images[p[b * bs:(b + 1) * bs]] for ds, p in zip(self.datasets, perms)]
                for b in range(nb))
        pinned = self.device.type == "cuda"
        per_step = []
        for batches in datalib.prefetch(host, depth=2):
            tensors = [torch.from_numpy(a) for a in batches]
            if pinned:
                tensors = [t.pin_memory() for t in tensors]
            state, m = self.step(
                state, *(t.to(self.device, non_blocking=True) for t in tensors))
            per_step.append(m)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}
