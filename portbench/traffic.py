"""The general generator of the training traffic: resident uint8 datasets
and the epoch orders over them, from a traffic file and the run's seed.

A traffic file (`portbench/traffic/<name>.json`) holds:

    batch_size  images per step and domain
    images      images in each domain's dataset
    domains     1 (one dataset) or 2 (paired domains, as CycleGAN's)

The datasets are random uint8 images of the configuration's size, drawn on
the device (each domain from its own generator), and stay resident there,
as the program's feed keeps a dataset that fits its budget. The order is a
fresh permutation of each domain at every epoch boundary, drawn on the
device; step b of an epoch takes rows [b B, (b + 1) B) of it, handed to the
program as a (1, B) index table, one per domain. The first steps of a run
therefore train on rows that all differ.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

KEYS = ("batch_size", "images", "domains")


def load(path: Path) -> dict:
    t = json.loads(Path(path).read_text())
    missing = [k for k in KEYS if k not in t]
    if missing:
        raise ValueError(f"traffic file {path} lacks {missing}")
    if t["domains"] not in (1, 2) or t["images"] < t["batch_size"] or t["batch_size"] < 2:
        raise ValueError(f"traffic file {path}: bad sizes {t}")
    return t


def make_datasets(traffic: dict, image_size, seed: int, device) -> list[torch.Tensor]:
    """One (images, H, W, C) uint8 tensor on the device per domain."""
    out = []
    for d in range(traffic["domains"]):
        gen = torch.Generator(device=device).manual_seed(seed + d)
        out.append(torch.randint(0, 256, (traffic["images"], *image_size), generator=gen,
                                 device=device, dtype=torch.uint8))
    return out


class EpochOrder:
    """The index tables of successive steps, epoch after epoch."""

    def __init__(self, traffic: dict, seed: int, device) -> None:
        self.batch = traffic["batch_size"]
        self.images = traffic["images"]
        self.domains = traffic["domains"]
        self.per_epoch = self.images // self.batch
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.b = self.per_epoch
        self.tables: list[torch.Tensor] = []

    def next(self) -> list[torch.Tensor]:
        """Each domain's (1, B) int64 index table of the next step."""
        if self.b == self.per_epoch:
            n = self.per_epoch * self.batch
            self.tables = [torch.randperm(self.images, generator=self.gen, device=self.device)[:n]
                           .view(self.per_epoch, self.batch) for _ in range(self.domains)]
            self.b = 0
        rows = [t[self.b:self.b + 1] for t in self.tables]
        self.b += 1
        return rows
