"""Reading a torch.profiler trace of the profiled sub-window.

The harness exports the profiler's Chrome trace, and this module keeps what
the per-layer metrics read: the span of the window (a user annotation the
harness records around it), the device's activity inside it (kernels,
copies, memsets) and the host's operations. The busy time is the union of
the device intervals clipped to the span, so overlapping work on two
streams counts once and an idle gap counts as idle.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def gaps_us(intervals, t0: float, t1: float) -> list[tuple[float, float]]:
    """The (start, end) stretches of [t0, t1] that no interval covers."""
    out, end = [], t0
    for s, e in sorted(intervals):
        if s > end:
            out.append((end, min(s, t1)))
        end = max(end, e)
        if end >= t1:
            break
    if end < t1:
        out.append((end, t1))
    return [(s, e) for s, e in out if e > s]


class Window:
    """The events of one annotated window of a Chrome trace."""

    def __init__(self, events: list[dict], annotation: str) -> None:
        spans = [e for e in events if e.get("name") == annotation
                 and e.get("cat") == "user_annotation"]
        if len(spans) != 1:
            raise RuntimeError(f"expected one {annotation!r} span, found {len(spans)}")
        self.t0 = float(spans[0]["ts"])
        self.t1 = self.t0 + float(spans[0]["dur"])
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and float(e["ts"]) < self.t1
                       and float(e["ts"]) + float(e["dur"]) > self.t0]
        self.host = [e for e in events if e.get("cat") in HOST_CATS and e is not spans[0]]

    @classmethod
    def from_file(cls, path: Path, annotation: str) -> Window:
        events = json.loads(Path(path).read_text())["traceEvents"]
        return cls([e for e in events if e.get("ph") == "X"], annotation)

    @property
    def span_us(self) -> float:
        return self.t1 - self.t0

    def _clipped(self, events) -> list[tuple[float, float]]:
        return [(max(self.t0, float(e["ts"])), min(self.t1, float(e["ts"]) + float(e["dur"])))
                for e in events]

    def busy_us(self) -> float:
        return union_us(self._clipped(self.device))

    def kernel_us(self, pattern: re.Pattern) -> float:
        """Device time of the kernels whose names match `pattern`."""
        return sum(e - s for s, e in self._clipped(
            [ev for ev in self.device if ev.get("cat") == "kernel" and pattern.search(ev["name"])]))

    def top_device_ops(self, n: int = 10) -> list[list]:
        """[[name, seconds], ...] of the device operations that took most time."""
        by_name: dict[str, float] = {}
        for ev, (s, e) in zip(self.device, self._clipped(self.device)):
            key = _short(ev["name"])
            by_name[key] = by_name.get(key, 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, lookback: int = 4096) -> list[list]:
        """[[host op, seconds], ...]: the device's idle time inside the
        window, each gap named by the innermost host operation running at
        its start (of those that contain it, the one that started last,
        looking back at most `lookback` operations), summed by name,
        largest first."""
        order = sorted(range(len(self.host)), key=lambda i: float(self.host[i]["ts"]))
        starts = np.array([float(self.host[i]["ts"]) for i in order])
        ends = starts + np.array([float(self.host[i]["dur"]) for i in order])
        by_name: dict[str, float] = {}
        for s, e in gaps_us(self._clipped(self.device), self.t0, self.t1):
            name = "(no host op)"
            j = int(np.searchsorted(starts, s, side="right")) - 1
            for k in range(j, max(j - lookback, -1), -1):
                if ends[k] > s:
                    name = _short(self.host[order[k]]["name"])
                    break
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def _short(name: str, limit: int = 120) -> str:
    name = name.removeprefix("void ").replace("at::native::", "")
    return name if len(name) <= limit else name[:limit - 3] + "..."
