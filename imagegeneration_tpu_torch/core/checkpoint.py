"""Whole-train-state checkpoints over torch.save / torch.load.

The counterpart of imagegeneration_tpu/core/checkpoint.py's
`CheckpointManager` (orbax there): epoch-numbered saves of the full train
state, `max_to_keep` newest kept, restore of the latest. A save writes
`<dir>/<epoch>/state.pt` through a temporary file and a rename, so a save
cut short never leaves a half-written checkpoint under an epoch's name.

Loading uses `weights_only=True`: a checkpoint holds tensors, numbers and
containers only, and nothing in it can run code.

Params-only msgpack exports in the JAX package's format are not ported yet.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any

import torch

_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str | Path, max_to_keep: int = 2):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def all_epochs(self) -> list[int]:
        return sorted(
            int(p.name) for p in self._dir.iterdir()
            if p.name.isdigit() and (p / _FILE).exists()
        )

    def latest_epoch(self) -> int | None:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def save(self, epoch: int, state: dict[str, Any]) -> None:
        d = self._dir / str(epoch)
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / f"{_FILE}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, d / _FILE)
        for old in self.all_epochs()[: -self.max_to_keep]:
            shutil.rmtree(self._dir / str(old))

    def restore(
        self, epoch: int | None = None, map_location: torch.device | str = "cpu"
    ) -> dict[str, Any]:
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {self._dir}")
        return torch.load(
            self._dir / str(epoch) / _FILE, map_location=map_location,
            weights_only=True,
        )
