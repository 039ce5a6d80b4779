"""The program's own spans in the profiled sub-window: device time, host
time and the host's waits, by phase of the train step.

The program marks its train step with `torch.profiler.record_function`
ranges (imagegeneration_tpu_torch/core/trace.py): `train.step` around each
step, and inside it `train.forward`, `train.backward` and `train.apply`.
In the exported trace each is a `user_annotation` event on the host's
clock, the clock of the kernels too. A program without them gives no
split (None), and the metrics that read it are left out of the line.

A device event (kernel, memcpy, memset) goes with its launch, the CUDA
API call (a `cuda_runtime` or `cuda_driver` event) with the same
`correlation` id, and the launch with the innermost program span that
contains its start, whatever the thread: the
autograd engine's thread launches the backward's kernels while the main
thread is inside `train.backward`. Of the spans that contain a time, the
innermost is the one that started last (the spans nest on one thread).
A step's device events inside `train.step` but outside every phase are
its `other` (the gather of the batch, the inputs' casts, the metrics);
those launched outside every step are `outside`. A part's device time is
the union of its events' intervals, as the window's busy time is
(device_ms_per_step): kernels that run at once on two streams count once.

The CUDA API calls that start inside a `train.step` are kept for the
host's waits, in two parts that move apart: a launch blocked for room in
the queue (metrics/host_wait_ms.py: the device paces the step) and a call
that stops the host until the device drains or the driver answers
(metrics/host_sync_ms.py: a synchronize, a blocking copy, cudaMalloc).
Both are host times under the profiler, which adds its own cost to every
operator and launch it records: they compare traced runs with traced runs
of the same card, never with an untraced run's host time.
"""

from __future__ import annotations

import bisect

from portbench import trace

STEP = "train.step"
PHASES = {"train.forward": "forward", "train.backward": "backward", "train.apply": "apply"}
SPANS = (STEP, *PHASES)
PARTS = ("forward", "backward", "apply", "other", "outside")
CALL_CATS = ("cuda_runtime", "cuda_driver")


SYNC_CALLS = frozenset({
    "cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize",
    "cuCtxSynchronize", "cuStreamSynchronize", "cuEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cuMemcpy", "cuMemcpyDtoH_v2", "cuMemcpyHtoD_v2",
    "cudaMalloc", "cudaFree", "cudaMallocHost", "cudaFreeHost", "cudaHostAlloc",
    "cuMemAlloc_v2", "cuMemFree_v2",
})
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
    "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
})
LAUNCH_US = 50.0  # a launch's own cost stays under this; the rest is waiting


def sync_us(calls) -> float:
    """Microseconds of (name, start, duration) calls in SYNC_CALLS, as the
    union of their intervals (a driver call inside a runtime call counts
    once)."""
    return trace.union_us([(ts, ts + dur) for name, ts, dur in calls if name in SYNC_CALLS])


def launch_wait_us(calls) -> float:
    """Microseconds of (name, start, duration) launch calls past their first
    LAUNCH_US: a launch waiting for room in the queue, as a union."""
    return trace.union_us([(ts + LAUNCH_US, ts + dur) for name, ts, dur in calls
                           if name in LAUNCH_CALLS and dur > LAUNCH_US])


class Split:
    """A profiled window's steps, split by phase."""

    def __init__(self, steps: int, device_us: dict, apply_host_us: float,
                 step_calls: list, span_counts: dict) -> None:
        self.steps = steps
        self.device_us = device_us  # by part, over the window
        self.apply_host_us = apply_host_us
        self.step_calls = step_calls  # (name, start, duration) of the calls in a step
        self.span_counts = span_counts  # by span name, over the window

    def device_ms(self, part: str) -> float:
        """Device milliseconds a step of `part`."""
        return self.device_us[part] / 1e3 / self.steps


class _Spans:
    """Program spans sorted by start (a parent before a child that starts
    with it), for the innermost span at a time."""

    def __init__(self, events: list[dict]) -> None:
        order = sorted(events, key=lambda e: (float(e["ts"]), -float(e["dur"])))
        self.starts = [float(e["ts"]) for e in order]
        self.ends = [(float(e["ts"]) + float(e["dur"]), e["name"]) for e in order]

    def innermost(self, t: float) -> str | None:
        for k in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            end, name = self.ends[k]
            if end > t:
                return name
            if name == STEP:  # a step that ended before t holds nothing after it
                return None
        return None


def split(window: trace.Window | None) -> Split | None:
    """The window's steps split by phase; None without program steps."""
    if window is None:
        return None
    spans = [e for e in window.host if e.get("cat") == "user_annotation"
             and e.get("name") in SPANS and window.t0 <= float(e["ts"]) <= window.t1]
    steps = [e for e in spans if e["name"] == STEP]
    if not steps:
        return None
    by_time = _Spans(spans)
    calls = [e for e in window.host if e.get("cat") in CALL_CATS]
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in calls
                if "correlation" in e.get("args", {})}

    intervals: dict[str, list] = {part: [] for part in PARTS}
    for ev, interval in zip(window.device, window._clipped(window.device)):
        t = launched.get(ev.get("args", {}).get("correlation"))
        name = None if t is None else by_time.innermost(t)
        intervals[PHASES.get(name, "other" if name == STEP else "outside")].append(interval)
    device_us = {part: trace.union_us(iv) for part, iv in intervals.items()}

    step_spans = _Spans(steps)
    step_calls = [(c["name"], float(c["ts"]), float(c["dur"])) for c in calls
                  if step_spans.innermost(float(c["ts"])) == STEP]
    counts = {name: sum(e["name"] == name for e in spans) for name in SPANS}
    apply_us = sum(float(e["dur"]) for e in spans if e["name"] == "train.apply")
    return Split(len(steps), device_us, apply_us, step_calls, counts)


_last: tuple = (None, None)


def of(cell) -> Split | None:
    """The split of the cell's profiled sub-window, computed once."""
    global _last
    if _last[0] is not cell.profiled:
        _last = (cell.profiled, split(cell.profiled))
    return _last[1]
