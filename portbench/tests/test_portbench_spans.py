"""The readers of the program's spans (portbench/phases.py and the seven
metrics on it), on hand-built Chrome events: kernels go with their launches
by correlation id, launches with the innermost program span by time on any
thread, kernels that overlap count once, a long launch counts its part
over 50 us as waiting for the queue apart from the synchronizing calls, and a step's work outside every phase is its
`other`."""

import types

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench import harness, phases, spec as speclib, trace

SPEC = speclib.Spec.load(harness.ROOT)
MAIN, AUTOGRAD = 1, 2
SPAN_METRICS = ("fwd_device_ms", "bwd_device_ms", "apply_device_ms", "apply_host_ms",
                "host_wait_ms", "host_sync_ms")


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _span(name, ts, dur):
    return _x("user_annotation", name, ts, dur)


def _launch(ts, dur, corr, tid=MAIN, name="cudaLaunchKernel"):
    return _x("cuda_runtime", name, ts, dur, tid, correlation=corr)


def _kernel(ts, dur, corr, cat="kernel"):
    return _x(cat, f"kernel_{corr}", ts, dur, 7, correlation=corr)


def _events():
    return [
        _span(harness.ANNOTATION, 0.0, 10_000.0),
        # step 1: every phase; an apply span nested in the forward
        _span("train.step", 100.0, 1000.0),
        _span("train.forward", 150.0, 200.0),
        _launch(200.0, 5.0, 1), _kernel(210.0, 40.0, 1),
        _launch(220.0, 4.0, 8, name="cudaMemcpyAsync"), _kernel(260.0, 6.0, 8, "gpu_memcpy"),
        _launch(206.0, 3.0, 9), _kernel(215.0, 10.0, 9),        # beside kernel 1: counts once
        _span("train.apply", 300.0, 40.0),
        _launch(310.0, 3.0, 7), _kernel(320.0, 11.0, 7),         # the innermost: apply
        _span("train.backward", 400.0, 300.0),
        _launch(450.0, 80.0, 2, tid=AUTOGRAD), _kernel(460.0, 100.0, 2),  # 30 us waiting
        _span("train.apply", 750.0, 150.0),
        _launch(760.0, 4.0, 3), _kernel(800.0, 20.0, 3),
        _launch(950.0, 3.0, 4), _kernel(960.0, 10.0, 4),         # in the step, no phase
        _x("cuda_runtime", "cudaStreamSynchronize", 1050.0, 40.0),  # waits 40 us
        # step 2: no phase span at all
        _span("train.step", 2000.0, 500.0),
        _launch(2100.0, 2.0, 5), _kernel(2200.0, 50.0, 5),
        # outside every step: a launch, a long synchronize
        _launch(3000.0, 2.0, 6), _kernel(3010.0, 7.0, 6),
        _x("cuda_runtime", "cudaStreamSynchronize", 3100.0, 100.0),
        _x("cpu_op", "aten::add", 3300.0, 10.0),
    ]


def _cell(events):
    return types.SimpleNamespace(profiled=trace.Window(events, harness.ANNOTATION))


def test_device_time_goes_by_correlation_and_innermost_span():
    s = phases.split(trace.Window(_events(), harness.ANNOTATION))
    assert s.steps == 2
    assert s.device_us == {"forward": 40.0 + 6.0, "backward": 100.0,
                           "apply": 11.0 + 20.0, "other": 10.0 + 50.0, "outside": 7.0}
    assert s.span_counts == {"train.step": 2, "train.forward": 1, "train.backward": 1,
                             "train.apply": 2}
    assert s.device_ms("forward") == pytest.approx(46.0 / 1e3 / 2)


def test_the_readers_per_step():
    c = _cell(_events())
    got = {m: SPEC.reader(m).read(c) for m in SPAN_METRICS}
    assert got == pytest.approx({
        "fwd_device_ms": 0.046 / 2, "bwd_device_ms": 0.1 / 2, "apply_device_ms": 0.031 / 2,
        "apply_host_ms": (0.04 + 0.15) / 2,
        # the 80 us launch waits 30 us for the queue; the synchronize inside
        # step 1 40 us; the one outside every step is the harness's
        "host_wait_ms": 0.03 / 2, "host_sync_ms": 0.04 / 2})


def test_a_backward_launch_on_another_thread_goes_by_time():
    events = _events()
    moved = [e for e in events if e.get("args", {}).get("correlation") == 2
             and e["cat"] == "cuda_runtime"][0]
    moved["ts"] = 720.0  # after the backward span, still in the step
    s = phases.split(trace.Window(events, harness.ANNOTATION))
    assert s.device_us["backward"] == 0.0 and s.device_us["other"] == 160.0


def test_waits_count_once_and_only_their_blocking_part():
    base = [_span(harness.ANNOTATION, 0.0, 1000.0), _span("train.step", 0.0, 1000.0)]
    events = base + [
        _launch(100.0, 49.0, 1), _launch(200.0, 50.0, 2),         # no wait
        _launch(300.0, 80.0, 3),                                   # 30
        _x("cuda_driver", "cuLaunchKernel", 310.0, 60.0),          # inside the one above
        _x("cuda_runtime", "cudaMalloc", 500.0, 25.0),             # 25
        _x("cuda_runtime", "cudaGetDevice", 600.0, 90.0),          # not a wait
    ]
    calls = phases.split(trace.Window(events, harness.ANNOTATION)).step_calls
    assert phases.launch_wait_us(calls) == 30.0
    assert phases.sync_us(calls) == 25.0


def test_a_program_without_spans_gives_no_reading():
    events = [e for e in _events() if not e["name"].startswith("train.")]
    c = _cell(events)
    assert phases.split(c.profiled) is None
    assert all(SPEC.reader(m).read(c) is None for m in SPAN_METRICS)
    assert all(SPEC.reader(m).read(types.SimpleNamespace(profiled=None)) is None
               for m in SPAN_METRICS)


def test_device_mallocs_per_step_is_the_mean_of_the_step_records(monkeypatch):
    from imagegeneration_tpu_torch.core import trace as program_trace

    reader = SPEC.reader("device_mallocs_per_step")
    program_trace.reset()
    assert reader.read(None) is None
    calls = iter(range(0, 100, 3))
    monkeypatch.setattr(program_trace, "_allocator_calls", lambda: next(calls))
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                with program_trace.span(program_trace.STEP):
                    pass
        assert reader.read(None) == 3.0
    finally:
        program_trace.reset()
