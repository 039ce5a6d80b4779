"""The engines' data path: one epoch of a train step over uint8 datasets.

Shared by the SNDCGAN and WGAN engines (one dataset) and the CycleGAN
engine (two domains, zipped per batch). The datasets are resident on the
device when their images together fit `core.data.resident_budget`: an
epoch is then the step library's epoch runner over permutation gathers,
the images uploaded once. Otherwise pinned host batches stream through a
prefetch thread (depth 2). Both paths take the orders the engine passes,
so they train alike, and return the metrics stacked over the steps, still
on the device, for the epoch's one host sync.

Data parallelism (`group`, a core.mesh.DataGroup): the batch size is the
global one, and each rank takes its block of rows of every global batch
(core/mesh.process_row_range) and, under a spatial partition, its block
of image rows (core/mesh.spatial_row_range). Resident: the uint8 dataset
sits on each rank's card (as the JAX package replicates it), cut to the
rank's image rows, and each rank gathers only its rows of the shared
permutation. Streamed: each rank gathers, cuts and copies up only its
rows. The ranks agree on resident or streamed (one all-reduce at set-up),
since the two take their orders from different streams in the engines.
Host-sharded (datasets built with `shard=(d, data)`, the data block's):
each rank holds only its shard of the files and takes its B / data rows
per batch from its own shuffle of it; every rank reaches the same batch
count, the smallest shard's, and `dropped` counts the rows of every shard
that an epoch leaves out.
"""

from __future__ import annotations

from types import ModuleType
from typing import Sequence

import numpy as np
import torch

from imagegeneration_tpu_torch.core import data as datalib
from imagegeneration_tpu_torch.core import mesh as meshlib
from imagegeneration_tpu_torch.core import trace
from imagegeneration_tpu_torch.parallel import dp


class EpochFeed:
    def __init__(self, datasets: Sequence, cfg, device: torch.device,
                 steplib: ModuleType, group=None) -> None:
        """`steplib` is a step module: its `make_train_step(cfg, group)` step
        takes `(state, *batches)` and its `make_epoch_runner(cfg, group)`
        runner takes `(state, *images, *index_tables)`, one of each per
        dataset."""
        self.datasets = tuple(datasets)
        self.batch_size = cfg.batch_size
        self.device = device
        self.rows = meshlib.process_row_range(group, self.batch_size)
        height = self.datasets[0].images.shape[1]
        self.image_rows = slice(*meshlib.spatial_row_range(group, height))
        local = self.rows[1] - self.rows[0]
        shards = [getattr(ds, "shard", None) for ds in self.datasets]
        self.host_sharded = any(shards)
        if self.host_sharded:
            if group is None or not all(shards):
                raise ValueError("host-sharded data needs a group and datasets built with shard=")
            self.num_batches = min(int(ds.shard_sizes.min()) for ds in self.datasets) // local
            self.dropped = sum(int(ds.shard_sizes.sum()) for ds in self.datasets) \
                - len(self.datasets) * self.num_batches * self.batch_size
        else:
            self.num_batches = min(len(ds.images) for ds in self.datasets) // self.batch_size
            self.dropped = 0
        nbytes = sum(ds.images[:, self.image_rows].nbytes for ds in self.datasets)
        self.resident = dp.all_ranks(nbytes <= datalib.resident_budget(device), group)
        self.step = steplib.make_train_step(cfg, group)
        self._runner = steplib.make_epoch_runner(cfg, group) if self.resident else None
        self._images: list[torch.Tensor] | None = None

    def rows_of(self, perm: np.ndarray, b: int) -> np.ndarray:
        """This rank's indices of batch b of an epoch in the order `perm`."""
        if self.host_sharded:
            local = self.rows[1] - self.rows[0]
            return perm[b * local:(b + 1) * local]
        return perm[b * self.batch_size + self.rows[0]:b * self.batch_size + self.rows[1]]

    def run(self, state, perms: Sequence[np.ndarray]):
        """One epoch, each dataset in the order of its permutation in
        `perms`: `(state, {metric: (num_batches,) device tensor})`, this
        rank's metrics (the engine averages them over the ranks)."""
        nb = self.num_batches
        if self.resident:
            if self._images is None:
                self._images = [
                    torch.from_numpy(np.ascontiguousarray(ds.images[:, self.image_rows]))
                    .to(self.device) for ds in self.datasets]
            tables = [torch.from_numpy(np.stack([self.rows_of(p, b) for b in range(nb)]))
                      .to(self.device) for p in perms]
            return self._runner(state, *self._images, *tables)
        host = ([np.ascontiguousarray(ds.images[self.rows_of(p, b)][:, self.image_rows])
                 for ds, p in zip(self.datasets, perms)] for b in range(nb))
        pinned = self.device.type == "cuda"
        per_step = []
        for batches in datalib.prefetch(host, depth=2):
            tensors = [torch.from_numpy(a) for a in batches]
            if pinned:
                tensors = [t.pin_memory() for t in tensors]
            with trace.span(trace.STEP):
                state, m = self.step(
                    state, *(t.to(self.device, non_blocking=True) for t in tensors))
            per_step.append(m)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

