"""core/trace.py: the train step's spans and per-step counter records.

Without a recording profiler `span()` is one shared no-op object; under a
CPU torch.profiler each span is a `user_annotation` event of the exported
trace, nested as entered, and each outermost `train.step` leaves a record
of its span counts and of the allocator counter's delta. The per-step span counts of
the three train steps are the ones portbench's phase metrics read
(PERF.md §3).
"""

import json
import tracemalloc
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from imagegeneration_tpu_torch.core import data as datalib
from imagegeneration_tpu_torch.core import trace
from imagegeneration_tpu_torch.models.cyclegan import CycleGANConfig
from imagegeneration_tpu_torch.models.sndcgan import SNDCGANConfig
from imagegeneration_tpu_torch.models.wgan import WGANConfig
from imagegeneration_tpu_torch.train import cyclegan_step, feed, sndcgan_step, wgan_step

torch.set_num_threads(1)

FWD, BWD, APPLY = "train.forward", "train.backward", "train.apply"


def _counts(step=1, forward=0, backward=0, apply=0):
    out = {trace.STEP: step, FWD: forward, BWD: backward, APPLY: apply}
    return {k: v for k, v in out.items() if v}


@pytest.fixture(autouse=True)
def _fresh_records():
    trace.reset()
    yield
    trace.reset()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("train.")]


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    def no_cuda(*args, **kwargs):
        raise AssertionError("span() touched torch.cuda without a profiler")

    monkeypatch.setattr(torch.cuda, "is_initialized", no_cuda)
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", no_cuda)
    counts = {"n": 0}
    assert trace.span(trace.STEP) is trace.OFF and trace.span(FWD) is trace.OFF
    tracemalloc.start()
    try:
        for _ in range(100):
            with trace.span(trace.STEP), trace.span(FWD):
                counts["n"] += 1
        snap = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, trace.__file__)])
    finally:
        tracemalloc.stop()
    assert sum(s.size for s in snap.statistics("lineno")) == 0
    assert trace.steps() == [] and trace._open_step is None


def test_spans_nest_in_the_exported_trace(tmp_path):
    def run():
        with trace.span(trace.STEP):
            with trace.span(FWD):
                torch.ones(8).add_(1)
            with trace.span(BWD):
                torch.ones(8).mul_(2)

    prof, _ = _profiled(run)
    events = _annotations(prof, tmp_path)
    assert sorted(e["name"] for e in events) == sorted([trace.STEP, FWD, BWD])
    step = next(e for e in events if e["name"] == trace.STEP)
    for e in events:
        assert step["ts"] <= e["ts"] and e["ts"] + e["dur"] <= step["ts"] + step["dur"]
        assert e["tid"] == step["tid"]
    assert [r["spans"] for r in trace.steps()] == [_counts(forward=1, backward=1)]


@pytest.mark.parametrize("initialized, stats, want", [
    (False, None, None),  # no card in use: not read at all
    (True, {"num_alloc_retries": 0}, None),  # a torch that does not count them
    (True, {"num_device_alloc": 7, "num_device_free": 2, "num_ooms": 0}, 9),
])
def test_the_allocator_counter_reads_the_cards_device_calls(monkeypatch, initialized,
                                                             stats, want):
    def nested():
        assert initialized, "memory stats read before a card is in use"
        return stats

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: initialized)
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", nested)
    assert trace._allocator_calls() == want


def test_a_counters_delta_lands_in_its_step_record(monkeypatch):
    counts = {"calls": 5}
    monkeypatch.setattr(trace, "_allocator_calls", lambda: counts["calls"])

    def run():
        for added in (3, 0):
            with trace.span(trace.STEP):
                with trace.span(trace.STEP):  # an inner step span: no record of its own
                    counts["calls"] += added
        with pytest.raises(RuntimeError), trace.span(trace.STEP):
            counts["calls"] += 100
            raise RuntimeError("a step that raises leaves no record")
        with trace.span(FWD):  # outside any step: no record
            counts["calls"] += 1

    _profiled(run)
    records = trace.steps()
    assert [r["allocator_calls"] for r in records] == [3, 0]
    assert [r["spans"] for r in records] == [{trace.STEP: 2}] * 2
    assert trace._open_step is None


def test_a_step_without_a_card_records_no_counter():
    def run():
        with trace.span(trace.STEP):
            pass

    _profiled(run)
    assert trace.steps() == [{"spans": {trace.STEP: 1}}]


def test_the_records_stop_at_max_steps(monkeypatch):
    monkeypatch.setattr(trace, "MAX_STEPS", 2)

    def run():
        for _ in range(3):
            with trace.span(trace.STEP):
                pass

    _profiled(run)
    assert len(trace.steps()) == 2
    trace.reset()
    assert trace.steps() == []


def _sndcgan(d_updates):
    cfg = sndcgan_step.SNDCGANTrainConfig(
        model=SNDCGANConfig(image_size=(16, 16, 3), base_width=16), batch_size=2,
        d_updates=d_updates)
    images = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, (4, 16, 16, 3), dtype=np.uint8))
    state = sndcgan_step.init_state(cfg, "cpu")
    run = sndcgan_step.make_epoch_runner(cfg)
    return lambda: run(state, images, torch.tensor([[0, 1], [2, 3]]))


def _cyclegan():
    cfg = cyclegan_step.CycleGANTrainConfig(
        model=CycleGANConfig(image_size=(96, 96, 3), base_width=4, n_res_blocks=1),
        batch_size=1)
    rng = np.random.default_rng(4)
    x, y = (torch.from_numpy(rng.integers(0, 256, (2, 96, 96, 3), dtype=np.uint8))
            for _ in range(2))
    state = cyclegan_step.init_state(cfg, "cpu")
    run = cyclegan_step.make_epoch_runner(cfg)
    return lambda: run(state, x, y, torch.tensor([[0]]), torch.tensor([[1]]))


def _wgan():
    cfg = wgan_step.WGANTrainConfig(model=WGANConfig(image_size=(32, 48, 3), base_width=16),
                                    batch_size=2, n_critic=2)
    images = torch.from_numpy(
        np.random.default_rng(5).integers(0, 256, (4, 32, 48, 3), dtype=np.uint8))
    state = wgan_step.init_state(cfg, "cpu")
    run = wgan_step.make_epoch_runner(cfg)
    return lambda: run(state, images, torch.tensor([[0, 1], [2, 3]]))


# Per step, at the table of PERF.md §3. SNDCGAN with d_updates 2: the G pass
# (with D on the fakes), the D-real pass, the D-fake pass, each with its
# gradients and its Adam apply; with d_updates 1 one D pass. CycleGAN: one
# shared forward, three gradient pulls (G, F, both Ds), four Adam applies.
# WGAN with n_critic 2: a no-grad G pass for the fakes and two critic
# updates every step (the gradient-penalty pull, when on, is part of the
# critic's forward); every second step also the GAN update.
CASES = {
    "sndcgan-d2": (lambda: _sndcgan(2), [_counts(forward=3, backward=3, apply=3)] * 2),
    "sndcgan-d1": (lambda: _sndcgan(1), [_counts(forward=2, backward=2, apply=2)] * 2),
    "cyclegan": (_cyclegan, [_counts(forward=1, backward=3, apply=4)]),
    "wgan-ncritic2": (_wgan, [_counts(forward=3, backward=2, apply=2),
                              _counts(forward=4, backward=3, apply=3)]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_a_steps_spans(case, tmp_path):
    make, want = CASES[case]
    prof, _ = _profiled(make())
    assert [r["spans"] for r in trace.steps()] == want
    events = _annotations(prof, tmp_path)
    steps = sorted((e for e in events if e["name"] == trace.STEP), key=lambda e: e["ts"])
    assert len(steps) == len(want)
    for step, counts in zip(steps, want):
        inside = [e["name"] for e in events if e is not step
                  and step["ts"] <= e["ts"] <= step["ts"] + step["dur"]]
        assert {n: inside.count(n) for n in set(inside)} == {
            k: v for k, v in counts.items() if k != trace.STEP}


def test_the_streamed_feed_marks_each_step(monkeypatch):
    monkeypatch.setattr(datalib, "resident_budget", lambda device: 0)
    cfg = sndcgan_step.SNDCGANTrainConfig(
        model=SNDCGANConfig(image_size=(16, 16, 3), base_width=16), batch_size=2,
        d_updates=1)
    images = np.random.default_rng(6).integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)
    epoch = feed.EpochFeed([types.SimpleNamespace(images=images)], cfg,
                           torch.device("cpu"), sndcgan_step)
    assert not epoch.resident
    state = sndcgan_step.init_state(cfg, "cpu")
    _profiled(lambda: epoch.run(state, [np.arange(4)]))
    assert [r["spans"] for r in trace.steps()] == [_counts(forward=2, backward=2, apply=2)] * 2
