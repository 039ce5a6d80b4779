"""Loss history, per-epoch timing and the perf.jsonl writer.

The counterpart of imagegeneration_tpu/core/metrics.py. `LossHistory`
pickles the same dict-of-lists as the reference (SNDCGAN keys: epoch,
avg_g_loss, avg_d_loss, d_real, d_fake). matplotlib is imported only inside
`plot()`, because the GPU machine does not have it.
"""

from __future__ import annotations

import json
import pickle
import time
from pathlib import Path


class LossHistory:
    """Append-mostly dict-of-lists with pickle load/save (reference format)."""

    def __init__(self, path: str | Path, keys: tuple[str, ...]):
        self.path = Path(path)
        self.keys = keys
        self.data: dict[str, list] = {}
        if self.path.exists():
            with open(self.path, "rb") as f:
                data = pickle.load(f)  # written by this class
            if isinstance(data, dict):
                self.data = data
        for k in keys:
            self.data.setdefault(k, [])

    def extend(self, other: dict[str, list]) -> None:
        for k, v in other.items():
            self.data.setdefault(k, []).extend(v)

    def save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "wb") as f:
            pickle.dump(self.data, f)

    def plot(self, out_path: str | Path, skip_keys: tuple[str, ...] = ("epoch",)):
        """Line plot of every tracked series (needs matplotlib)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.clf()
        for key, val in self.data.items():
            if key in skip_keys or not len(val):
                continue
            plt.plot(val, label=key)
        plt.legend()
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        plt.savefig(out_path)
        plt.close()


class Stopwatch:
    """Per-epoch wall-clock and throughput. The caller synchronizes the
    device before `epoch_report`, so the time covers the device work."""

    def __init__(self) -> None:
        self.start = time.perf_counter()
        self._epoch_start = self.start

    def epoch_start(self) -> None:
        self._epoch_start = time.perf_counter()

    def epoch_report(self, steps: int, images: int) -> dict[str, float]:
        now = time.perf_counter()
        dt = max(now - self._epoch_start, 1e-9)
        return {
            "epoch_seconds": dt,
            "steps_per_sec": steps / dt,
            "images_per_sec": images / dt,
            "total_seconds": now - self.start,
        }


def write_metrics_jsonl(path: str | Path, record: dict) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "a") as f:
        f.write(json.dumps(record) + "\n")
