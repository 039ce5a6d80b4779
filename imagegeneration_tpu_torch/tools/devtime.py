"""Device time of a call on one CUDA card, warm or with the L2 flushed.

Both read CUDA events on the call's stream (the profiler has been seen to
drop a window's first device event on the card, so it is not used here).

`device_ms(fn)`: the card is held in a spin kernel (twice as long as the
host took to queue one call, times `iters`) while the host queues `iters`
back-to-back calls between two events; the mean interval per call is the
device time with no host launch gaps, inputs of a few MB staying in the
50 MB L2 from one call to the next.

`device_ms(fn, flush=L2Flush(dev))`: before every call a copy of
FLUSH_BYTES evicts the L2, so the call finds its inputs in device memory,
as a call inside a train step does. Events recorded just before and just
after each call leave the copy out; it lasts ~0.2 ms on the card, time
enough for the host to queue the call behind it.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

FLUSH_BYTES = 256 << 20  # 5x the H100's 50 MB L2
CYCLES_PER_S = 2e9  # above the H100's SM clock, so a hold lasts at least as asked


class L2Flush:
    """A device-to-device copy of FLUSH_BYTES, which evicts the L2."""

    def __init__(self, device: torch.device, nbytes: int = FLUSH_BYTES):
        self.src = torch.empty(nbytes, dtype=torch.uint8, device=device)
        self.dst = torch.empty_like(self.src)

    def __call__(self) -> None:
        self.dst.copy_(self.src)


def _event() -> torch.cuda.Event:
    return torch.cuda.Event(enable_timing=True)


def device_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3,
              flush: L2Flush | None = None) -> float:
    """Mean device milliseconds per call of `fn` (see the module note)."""
    for _ in range(warmup):
        if flush is not None:
            flush()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        queued_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if flush is None:
        start, end = _event(), _event()
        torch.cuda._sleep(int(CYCLES_PER_S * (2 * iters * queued_s + 1e-3)))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    marks = []
    for _ in range(iters):
        flush()
        start, end = _event(), _event()
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / iters
