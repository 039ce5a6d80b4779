"""Loss history, per-epoch timing, the perf.jsonl writer and the trainers'
profiler hook.

The counterpart of imagegeneration_tpu/core/metrics.py. `LossHistory`
pickles the same dict-of-lists as the reference (SNDCGAN keys: epoch,
avg_g_loss, avg_d_loss, d_real, d_fake). matplotlib is imported only inside
`plot()`, because the GPU machine does not have it. `ProfilerHook` is the
trainers' `--profile`: a torch.profiler trace of one epoch.
"""

from __future__ import annotations

import json
import pickle
import time
from pathlib import Path

import torch


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


class ProfilerHook:
    """torch.profiler capture of one epoch (the JAX hook's jax.profiler
    trace): the engines call `maybe_start(epoch, first_real_epoch)` before
    each epoch and `maybe_stop()` after its host sync, and the hook traces
    `first_real_epoch`, the run's second epoch (its first is the warm-up).
    CPU activity, and CUDA activity (kernels, copies) when `device` is a
    card; the Chrome trace goes to
    `<out_dir>/traces/epoch_<epoch>.rank<rank>.json`. Every process of a
    mesh runs the hook, as the JAX one does, so each rank writes its own
    file. A run of one epoch writes none."""

    def __init__(self, out_dir: str | Path, enabled: bool = False, device=None,
                 rank: int = 0):
        self.out_dir = Path(out_dir) / "traces"
        self.enabled = enabled
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.device = device
        self.rank = rank
        self._prof = None
        self._epoch: int | None = None

    def maybe_start(self, epoch: int, first_real_epoch: int) -> None:
        if self.enabled and self._prof is None and epoch == first_real_epoch:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.cuda:
                torch.cuda.synchronize(self.device)  # earlier work stays out
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
            self._epoch = epoch

    def maybe_stop(self) -> None:
        if self._prof is None:
            return
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / f"epoch_{self._epoch}.rank{self.rank}.json"
        self._prof.export_chrome_trace(str(path))
        self._prof = None
        self.enabled = False
        print(f"profiler trace written to {path}", flush=True)


def write_metrics_jsonl(path: str | Path, record: dict) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "a") as f:
        f.write(json.dumps(record) + "\n")
