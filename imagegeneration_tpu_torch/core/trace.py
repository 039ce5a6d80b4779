"""Spans of the train step on the profiler's clock, and the step's counters.

`span(name)` marks a phase of the program. While no torch profiler records,
it returns one shared object that does nothing, so a span costs one test
of the profiler's own is-enabled flag. While one records, the span is a
`torch.profiler.record_function` range: a `user_annotation` event in the
profiler's Chrome trace, on the same clock as the kernels it launches.
Spans nest as the host thread enters them.

The spans of the train step (train/*_step.py, train/common.py,
train/feed.py):

    train.step      one step, with the gather of its batch
    train.forward   a forward pass and its losses
    train.backward  a pull of parameter gradients (torch.autograd.grad)
    train.apply     an optimizer apply: the gradients' reduce, the checks,
                    the step size and the launches

The step's counter: the CUDA caching allocator's device calls (cudaMalloc
and cudaFree, which make the host wait), once a card is in use. While a
profiler records, the outermost `train.step` reads it at entry and at exit
and appends the step's record, the count of each span inside it and the
counter's delta, to an in-memory list of at most MAX_STEPS steps:
`steps()` returns the list, `reset()` clears it. Nothing is written out
here; whoever reads the list does that, after the window
(portbench/metrics/device_mallocs_per_step.py).
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

STEP = "train.step"
MAX_STEPS = 4096

_STEPS: list[dict] = []
_open_step: dict | None = None  # the record of the outermost train.step being run


OFF = contextlib.nullcontext()  # the span while no profiler records


class _Span:
    """A recording span: a record_function range; the outermost train.step
    also takes the step's record."""

    __slots__ = ("name", "_range", "_outer", "_before")

    def __init__(self, name: str) -> None:
        self.name = name
        self._range = _profiler.record_function(name)
        self._outer = False
        self._before: int | None = None

    def __enter__(self):
        global _open_step
        if _open_step is not None:
            spans = _open_step["spans"]
            spans[self.name] = spans.get(self.name, 0) + 1
        elif self.name == STEP:
            self._outer = True
            self._before = _allocator_calls()
            _open_step = {"spans": {STEP: 1}}
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        global _open_step
        self._range.__exit__(*exc)
        if self._outer:
            record, _open_step = _open_step, None
            if exc[0] is None and len(_STEPS) < MAX_STEPS:
                after = _allocator_calls()
                if after is not None and self._before is not None:
                    record["allocator_calls"] = after - self._before
                _STEPS.append(record)
        return False


def span(name: str):
    """A context manager marking `name` in the profiler's trace while one
    records; else the shared no-op OFF."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Span(name)


def steps() -> list[dict]:
    """The records of the steps run under a profiler since the last reset:
    {"spans": {name: count}, "allocator_calls": delta}, the second only
    where a card was in use through the step."""
    return _STEPS


def reset() -> None:
    _STEPS.clear()


def _allocator_calls() -> int | None:
    """The caching allocator's device allocations and frees so far, on the
    current card; None before CUDA is in use or where torch does not count
    them."""
    if not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats_as_nested_dict()
    if "num_device_alloc" not in stats:
        return None
    return stats["num_device_alloc"] + stats["num_device_free"]
