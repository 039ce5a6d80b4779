#!/usr/bin/env python3
"""Where a headline train step's time goes, on one CUDA card.

    python -m imagegeneration_tpu_torch.tools.profile_step --out DIR
        [--workload {sndcgan,cyclegan,wgan}]

The step is a headline configuration, with random weights from the default
seed and synthetic uint8 batches made on the card:
- sndcgan (default): 256x144, batch 32, base_width 512, spectral-norm D,
  hinge loss, bf16 compute, d_updates=2;
- cyclegan: 128x128, batch 4, base_width 64, 9 res blocks, float32 (the
  reference's configuration; TF32 off);
- wgan: 256x144, batch 32, base_width 512, float32 (TF32 off), n_critic 5,
  weight clipping (bench.py:445-468); a 10-step window holds two gan
  updates, the 5-step profile one.

Phases:

1. rate: host clock around windows of WINDOW steps, each ending in a
   synchronize; the device memory a step takes at its peak (the most over
   one window).
2. memory: the allocator's history over one window of WINDOW steps,
   replayed to the moment the allocated bytes peak. The blocks live then
   are grouped by the innermost frame of this package that allocated them
   (blocks with no Python frame come from the autograd engine's backward
   thread) and by the train step's function; memory.txt lists them, and
   each block of LARGE_BLOCK bytes or more in the order of allocation.
3. profile: torch.profiler over PROFILE_STEPS steps. Device time by kernel
   class and by kernel name, self device time by aten op, and the device's
   busy share: the union of the trace's kernel, copy and memset intervals
   over the span of the profiled window. That is the busy share under the
   profiler, whose host overhead lengthens the window.
4. ab: windows of the step with its hand kernels ("kernels"), and with the
   plain version in place of one kernel family at a time (sndcgan:
   "plain_dropout", "plain_adam"; cyclegan: "plain_instance_norm",
   "plain_adam"), in turns k 1 2 2 1 k, twice. nvidia-smi samples the SM
   clock and the power draw every 100 ms beside the windows. Skipped for
   wgan, whose only hand kernels are the BatchNorm ones, which have no
   variant here.
5. data: the engine's resident and streaming epochs, in turns r s s r:
   steps/s of the second epoch of a fresh engine.

Writes summary.json, memory.txt, kernels.txt, ops.txt and trace.json.gz
under DIR. The
card's name and power limit are printed before the last line, which is
the summary as one JSON object. Without a CUDA card the tool fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import gc
import gzip
import json
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from imagegeneration_tpu_torch.core import data as datalib
from imagegeneration_tpu_torch.core import platform
from imagegeneration_tpu_torch.models.cyclegan import CycleGANConfig
from imagegeneration_tpu_torch.models.sndcgan import SNDCGANConfig
from imagegeneration_tpu_torch.models.wgan import WGANConfig
from imagegeneration_tpu_torch.ops import adam, dropout
from imagegeneration_tpu_torch.ops import instance_norm as inorm
from imagegeneration_tpu_torch.train import cyclegan_engine, cyclegan_step, sndcgan_engine
from imagegeneration_tpu_torch.train import sndcgan_step as steplib
from imagegeneration_tpu_torch.train import wgan_engine, wgan_step

N_BATCHES = 8  # distinct device batches the step cycles through
WINDOW = 10
RATE_WINDOWS = 3
PROFILE_STEPS = 5
DATA_EPOCH_BATCHES = 16
DATA_ORDER = ("resident", "streaming", "streaming", "resident")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LARGE_BLOCK = 64 * 2**20


@dataclasses.dataclass(frozen=True)
class Workload:
    config: str  # printed beside every number
    train_config: object
    # Module attributes swapped for each A/B variant: the wrappers look
    # their kernel entry points up at call time, so the plain version runs.
    variants: dict
    make_engine: Callable  # (out_dir, device) -> engine with .resident, .train


def adam_table_plain(table: adam.LeafTable, grads, alpha, b1: float, b2: float,
                     eps: float = adam.KERAS_EPS) -> None:
    """The plain version in place of the Adam kernel, on the table's leaves."""
    adam.adam_plain(table.params, grads, table.m, table.v, alpha, b1, b2, eps)


def _sndcgan() -> Workload:
    h, w, b, base = 144, 256, 32, 512
    ds = datalib.SyntheticImageDataset(DATA_EPOCH_BATCHES * b, (h, w))
    return Workload(
        config=f"{w}x{h} bs{b} base{base} SN hinge bf16 d_updates=2",
        train_config=steplib.SNDCGANTrainConfig(
            model=SNDCGANConfig(image_size=(h, w, 3), base_width=base,
                                spectral_norm=True, dtype=torch.bfloat16),
            batch_size=b, loss="hinge"),
        variants={
            "kernels": {},
            "plain_dropout": {dropout: {"fwd_kernel": dropout.fwd_plain,
                                        "bwd_kernel": dropout.bwd_plain}},
            "plain_adam": {adam: {"adam_kernel": adam_table_plain}},
        },
        make_engine=lambda out, dev: sndcgan_engine.SNDCGANEngine(
            out, ds, b, image_size=(h, w, 3), device=dev, spectral_norm=True,
            loss="hinge", dtype=torch.bfloat16, base_width=base,
            live_output=f"{out}/live"),
    )


def _cyclegan() -> Workload:
    size, b, base, res = 128, 4, 64, 9
    ds = [datalib.SyntheticImageDataset(DATA_EPOCH_BATCHES * b, (size, size), seed=s)
          for s in (1, 2)]
    return Workload(
        config=f"{size}x{size} bs{b} base{base} res{res} f32",
        train_config=cyclegan_step.CycleGANTrainConfig(
            model=CycleGANConfig(image_size=(size, size, 3), base_width=base,
                                 n_res_blocks=res),
            batch_size=b),
        variants={
            "kernels": {},
            "plain_instance_norm": {inorm: {"in_fwd_kernel": inorm.in_fwd_plain,
                                            "in_bwd_kernel": inorm.in_bwd_plain}},
            "plain_adam": {adam: {"adam_kernel": adam_table_plain}},
        },
        make_engine=lambda out, dev: cyclegan_engine.CycleGANEngine(
            *ds, out, b, (size, size), device=dev, base_width=base, n_res_blocks=res),
    )


def _wgan() -> Workload:
    h, w, b, base = 144, 256, 32, 512
    ds = datalib.SyntheticImageDataset(DATA_EPOCH_BATCHES * b, (h, w))
    return Workload(
        config=f"{w}x{h} bs{b} base{base} f32 n_critic5 clip",
        train_config=wgan_step.WGANTrainConfig(
            model=WGANConfig(image_size=(h, w, 3), base_width=base), batch_size=b),
        variants={"kernels": {}},
        make_engine=lambda out, dev: wgan_engine.WGANEngine(
            ds, (h, w, 3), b, path_like=out, device=dev, base_width=base),
    )


WORKLOADS = {"sndcgan": _sndcgan, "cyclegan": _cyclegan, "wgan": _wgan}
STEP_LIBS = {steplib.SNDCGANTrainConfig: steplib,
             cyclegan_step.CycleGANTrainConfig: cyclegan_step,
             wgan_step.WGANTrainConfig: wgan_step}


def log(msg: str) -> None:
    print(msg, flush=True)


class StepLoop:
    """The train step over a few synthetic uint8 batches held on the card
    (two domains' batches for CycleGAN)."""

    def __init__(self, cfg, dev: torch.device):
        paired = isinstance(cfg, cyclegan_step.CycleGANTrainConfig)
        lib = STEP_LIBS[type(cfg)]
        self.state = lib.init_state(cfg, dev)
        self.step = lib.make_train_step(cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        self.batches = torch.randint(
            0, 256, (N_BATCHES, 1 + paired, cfg.batch_size, *cfg.model.image_size),
            generator=gen, device=dev, dtype=torch.uint8)
        self.i = 0

    def run(self, n: int) -> None:
        for _ in range(n):
            self.state, _ = self.step(self.state, *self.batches[self.i % N_BATCHES])
            self.i += 1
        torch.cuda.synchronize()

    def ms_per_step(self, n: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.run(n)
        return (time.perf_counter() - t0) * 1e3 / n


# ------------------------------------------------------------------ rate
def phase_rate(loop: StepLoop, dev: torch.device) -> dict:
    loop.run(3)  # warm-up: cuDNN algorithm choice, the caching allocator
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    loop.run(WINDOW)  # a whole window: WGAN's gan update runs every 5th step
    peak = torch.cuda.max_memory_allocated(dev)
    ms = [loop.ms_per_step(WINDOW) for _ in range(RATE_WINDOWS)]
    return {
        "ms_per_step": ms,
        "steps_per_sec": [1e3 / m for m in ms],
        "allocated_before_step_bytes": before,
        "window_peak_allocated_bytes": peak,
        "free_bytes": torch.cuda.mem_get_info(dev)[0],
        "resident_budget_bytes": datalib.resident_budget(dev),
    }


# ---------------------------------------------------------------- memory
PACKAGE = "imagegeneration_tpu_torch/"
NO_FRAME = "(no Python frame: autograd backward)"


def _site(frames: list[dict], inside: str) -> str:
    """The innermost frame whose file lies under `inside`, as file:line fn."""
    for f in frames:
        name = f.get("filename", "")
        if inside in name:
            return f"{name[name.index(PACKAGE) + len(PACKAGE):]}:{f['line']} {f['name']}"
    return NO_FRAME if not frames else "(outside the package)"


def peak_blocks(trace: list[dict], base: int) -> tuple[int, list[dict], dict | None]:
    """Replay an allocator trace from `base` allocated bytes: the peak, the
    blocks the trace allocated that are live at it, and the allocation that
    reached it. A free of a block the trace never allocated lowers the
    base (it was live before the trace began)."""
    live: dict[int, dict] = {}
    cur = peak = base
    at_peak: list[dict] = []
    peak_event = None
    for e in trace:
        if e["action"] == "alloc":
            live[e["addr"]] = e
            cur += e["size"]
            if cur > peak:
                peak, at_peak, peak_event = cur, list(live.values()), e
        elif e["action"] == "free_requested":
            cur -= e["size"]
            live.pop(e["addr"], None)
    return peak, at_peak, peak_event


def phase_memory(loop: StepLoop, dev: torch.device, out: Path) -> dict:
    loop.run(1)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="python", max_entries=2_000_000,
        clear_history=True)
    try:
        loop.run(WINDOW)
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    trace = snap["device_traces"][dev.index or 0]
    peak, blocks, peak_event = peak_blocks(trace, base)
    groups = {}
    for title, inside in (("by allocating frame", PACKAGE), ("by train step function", "train/")):
        sums: dict[str, list[int]] = {}
        for b in blocks:
            rec = sums.setdefault(_site(b.get("frames", []), inside), [0, 0])
            rec[0] += b["size"]
            rec[1] += 1
        groups[title] = sorted(([k, v[0], v[1]] for k, v in sums.items()),
                               key=lambda r: -r[1])
    reached_at = _site(peak_event.get("frames", []), PACKAGE) if peak_event else None
    large = [[_site(b.get("frames", []), PACKAGE), _site(b.get("frames", []), "train/"),
              b["size"]] for b in blocks if b["size"] >= LARGE_BLOCK]
    with open(out / "memory.txt", "w") as f:
        f.write(f"peak {peak / 2**30:.3f} GiB over {WINDOW} steps; allocated before the "
                f"window {base / 2**30:.3f} GiB; reached by an allocation at {reached_at}\n")
        for title, rows in groups.items():
            f.write(f"\n# live at the peak, {title}: GiB, blocks, site\n")
            for site, nbytes, count in rows:
                f.write(f"{nbytes / 2**30:9.3f} {count:6d}  {site}\n")
        f.write(f"\n# blocks of {LARGE_BLOCK >> 20} MiB or more live at the peak, in the "
                f"order of allocation: bytes, site, step function\n")
        for site, fn, nbytes in large:
            f.write(f"{nbytes:14d}  {site}  ({fn})\n")
    return {
        "trace_events": len(trace),
        "allocated_before_window_bytes": base,
        "peak_allocated_bytes": peak,
        "peak_reached_at": reached_at,
        "live_at_peak_bytes_by_site": groups["by allocating frame"][:15],
        "live_at_peak_bytes_by_step_function": groups["by train step function"],
        "large_blocks_at_peak": large[:40],
    }


# --------------------------------------------------------------- profile
def kernel_class(name: str) -> str:
    n = name.lower()
    if "lrd_" in n:
        return "dropout kernels (csrc/leaky_relu_dropout.cu)"
    if "in_fwd_kernel" in n or "in_bwd_kernel" in n:
        return "instance norm kernels (csrc/instance_norm.cu)"
    if "adam_multi_kernel" in n:
        return "adam kernel (csrc/adam.cu)"
    if "multi_tensor_apply" in n:
        return "foreach (multi-tensor: RMSprop, clip)"
    # cuDNN's FFT algorithms: DSE::*fft*, fft2d_*, pointwise_mult_and_sum_complex
    if any(s in n for s in ("conv", "cudnn", "xmma", "fprop", "dgrad", "wgrad", "fft",
                            "pointwise_mult_and_sum_complex")):
        return "convolution (cuDNN)"
    if any(s in n for s in ("gemm", "cutlass", "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if "reduce" in n:
        return "reduction"
    if "elementwise" in n or "vectorized" in n or "unrolled" in n:
        return "elementwise"
    if "copy" in n or "memcpy" in n or "memset" in n:
        return "copy / memset"
    return "other"


def union_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def self_device_us(avg) -> float:
    # The attribute's name changed from `cuda` to `device` in torch 2.4.
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(avg, attr):
            return float(getattr(avg, attr))
    raise AttributeError("profiler average has no self device time")


def phase_profile(loop: StepLoop, out: Path) -> dict:
    loop.run(2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        with record_function("profile_window"):
            loop.run(PROFILE_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        raw = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(raw))
        text = raw.read_text()
    with gzip.open(out / "trace.json.gz", "wt") as f:
        f.write(text)
    events = [e for e in json.loads(text)["traceEvents"] if e.get("ph") == "X"]

    window = [e for e in events
              if e.get("name") == "profile_window" and e.get("cat") == "user_annotation"]
    if len(window) != 1:
        raise RuntimeError(f"expected one profile_window span, found {len(window)}")
    t0 = float(window[0]["ts"])
    t1 = t0 + float(window[0]["dur"])
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not device:
        raise RuntimeError("the trace holds no device activity")
    busy = union_us([(max(t0, float(e["ts"])), min(t1, float(e["ts"]) + float(e["dur"])))
                     for e in device
                     if float(e["ts"]) < t1 and float(e["ts"]) + float(e["dur"]) > t0])

    by_name: dict[str, list[float]] = {}
    for e in device:
        rec = by_name.setdefault(e["name"], [0.0, 0])
        rec[0] += float(e["dur"])
        rec[1] += 1
    by_class: dict[str, float] = {}
    for name, (us, _) in by_name.items():
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + us / PROFILE_STEPS / 1e3
    device_ms = sum(by_class.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    with open(out / "kernels.txt", "w") as f:
        f.write(f"device ms/step, calls/step, class, kernel ({PROFILE_STEPS} steps)\n")
        for name, (us, calls) in ranked:
            f.write(f"{us / PROFILE_STEPS / 1e3:9.4f} {calls / PROFILE_STEPS:7.1f}  "
                    f"{kernel_class(name)}  {name[:200]}\n")

    with open(out / "ops.txt", "w") as f:
        for title, avgs in (
            ("by aten op", prof.key_averages()),
            ("by aten op and input shapes", prof.key_averages(group_by_input_shape=True)),
        ):
            rows = sorted((a for a in avgs if self_device_us(a) > 0),
                          key=lambda a: -self_device_us(a))
            f.write(f"# self device ms/step, calls/step, {title}\n")
            for a in rows[:60]:
                shapes = f"  {a.input_shapes}" if "shapes" in title else ""
                f.write(f"{self_device_us(a) / PROFILE_STEPS / 1e3:9.4f} "
                        f"{a.count / PROFILE_STEPS:7.1f}  {a.key}{shapes}\n")
            f.write("\n")

    return {
        "steps": PROFILE_STEPS,
        "window_ms_per_step": (t1 - t0) / PROFILE_STEPS / 1e3,
        "device_busy_ms_per_step": busy / PROFILE_STEPS / 1e3,
        "busy_share_under_profiler": busy / (t1 - t0),
        "device_ms_per_step_by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "device_share_by_class": {k: v / device_ms for k, v in by_class.items()},
        "top_kernels_ms_per_step": [
            [name[:120], us / PROFILE_STEPS / 1e3, calls / PROFILE_STEPS]
            for name, (us, calls) in ranked[:12]],
    }


# -------------------------------------------------------------------- ab
@contextlib.contextmanager
def swapped(module, attr: str, value):
    old = getattr(module, attr)
    setattr(module, attr, value)
    try:
        yield
    finally:
        setattr(module, attr, old)


def variant(variants: dict, name: str) -> contextlib.ExitStack:
    """A context in which the A/B variant `name` is in place."""
    stack = contextlib.ExitStack()
    for module, attrs in variants[name].items():
        for attr, fn in attrs.items():
            stack.enter_context(swapped(module, attr, fn))
    return stack


def _smi_time(stamp: str) -> float:
    return datetime.datetime.strptime(stamp.strip(), "%Y/%m/%d %H:%M:%S.%f").timestamp()


@contextlib.contextmanager
def smi_samples(path: Path):
    """nvidia-smi writes timestamp, SM clock, power draw every 100 ms to
    `path` while the block runs; yields a list filled after it ends."""
    samples: list[tuple[float, float, float]] = []
    with open(path, "w") as f:
        proc = subprocess.Popen(
            [shutil.which("nvidia-smi") or "nvidia-smi",
             "--query-gpu=timestamp,clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=f, stderr=subprocess.DEVNULL)
        try:
            yield samples
        finally:
            proc.terminate()
            proc.wait(timeout=10)
    for line in path.read_text().splitlines():
        try:  # a line nvidia-smi could not fill ("[N/A]") is left out
            stamp, clock, power = line.split(",")
            samples.append((_smi_time(stamp), float(clock), float(power)))
        except ValueError:
            continue


def phase_ab(loop: StepLoop, variants: dict, out: Path) -> dict | None:
    if len(variants) == 1:
        return None  # no variant to swap in
    first, second = [v for v in variants if v != "kernels"]
    order = ("kernels", first, second, second, first, "kernels") * 2
    windows = []
    with smi_samples(out / "smi_ab.csv") as samples:
        for name in order:
            with variant(variants, name):
                loop.run(1)
                t0 = time.time()
                ms = loop.ms_per_step(WINDOW)
                t1 = time.time()
            windows.append({"variant": name, "ms_per_step": ms, "t0": t0, "t1": t1})
            log(f"ab: {name} {ms:.2f} ms/step")
    for w in windows:
        inside = [s for s in samples if w["t0"] <= s[0] <= w["t1"]]
        w["smi_samples"] = len(inside)
        w["sm_clock_mhz"] = sum(s[1] for s in inside) / len(inside) if inside else None
        w["power_w"] = sum(s[2] for s in inside) / len(inside) if inside else None
        del w["t0"], w["t1"]
    return {
        "order": list(order),
        "windows": windows,
        "ms_per_step": {v: [w["ms_per_step"] for w in windows if w["variant"] == v]
                        for v in variants},
    }


# ------------------------------------------------------------------ data
def phase_data(work: Workload, dev: torch.device) -> dict:
    rates: dict[str, list[float]] = {"resident": [], "streaming": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, mode in enumerate(DATA_ORDER):
            with contextlib.ExitStack() as stack:
                if mode == "streaming":
                    stack.enter_context(swapped(datalib, "resident_budget",
                                                 lambda device: 0))
                eng = work.make_engine(f"{tmp}/{i}", dev)
                if eng.resident != (mode == "resident"):
                    raise RuntimeError(f"engine picked the wrong data path for {mode}")
                eng.train(2)  # the first epoch warms up; the second is read
            perf = json.loads(Path(f"{tmp}/{i}/perf.jsonl").read_text().splitlines()[-1])
            rates[mode].append(perf["steps_per_sec"])
            del eng
            gc.collect()
            torch.cuda.empty_cache()
    return {"epoch_steps": DATA_EPOCH_BATCHES, "order": list(DATA_ORDER),
            "steps_per_sec": rates}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory for the results")
    ap.add_argument("--workload", choices=sorted(WORKLOADS), default="sndcgan")
    args = ap.parse_args(argv)
    dev = platform.require_cuda()
    card = platform.card_description()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    work = WORKLOADS[args.workload]()
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}; {work.config}; card: {card}")

    summary: dict = {"card": card, "workload": args.workload, "config": work.config,
                     "torch": torch.__version__}
    loop = StepLoop(work.train_config, dev)
    rate = summary["rate"] = phase_rate(loop, dev)
    log(f"rate: {[f'{s:.3f}' for s in rate['steps_per_sec']]} steps/s over "
        f"{WINDOW}-step windows; peak allocation over a window "
        f"{rate['window_peak_allocated_bytes'] / 2**30:.2f} GiB ({card})")
    mem = summary["memory"] = phase_memory(loop, dev, out)
    log(f"memory: peak {mem['peak_allocated_bytes'] / 2**30:.2f} GiB from the allocator's "
        f"history ({mem['allocated_before_window_bytes'] / 2**30:.2f} GiB before the "
        f"window), reached at {mem['peak_reached_at']} ({card})")
    for site, nbytes, count in mem["live_at_peak_bytes_by_site"][:8]:
        log(f"  {nbytes / 2**30:8.3f} GiB in {count:5d} blocks  {site}")
    prof = summary["profile"] = phase_profile(loop, out)
    log(f"profile: {prof['window_ms_per_step']:.2f} ms/step under the profiler, "
        f"device busy {prof['device_busy_ms_per_step']:.2f} ms/step "
        f"(share {prof['busy_share_under_profiler']:.3f}) ({card})")
    for cls, ms in prof["device_ms_per_step_by_class"].items():
        log(f"  {ms:8.3f} ms/step  {cls}")
    ab = summary["ab"] = phase_ab(loop, work.variants, out)
    for v, ms in (ab or {"ms_per_step": {}})["ms_per_step"].items():
        log(f"ab: {v} ms/step {[round(m, 2) for m in ms]} ({card})")
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    data = summary["data"] = phase_data(work, dev)
    log(f"data: steps/s {data['steps_per_sec']} ({card})")

    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
