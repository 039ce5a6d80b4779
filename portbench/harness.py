"""One run of one benchmark cell: set-up, the measured window, the check.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic and its metrics are found by name
from BENCHMARK.json (`spec.py`). A run:

1. set-up: makes the weights, the resident datasets and the epoch order
   from the seed, builds the program's training state and hands it the
   weights, and drives it through its first CHECKED_STEPS steps by the
   window's own call, reading what the comparison needs, then WARM_STEPS
   more; nothing compiles after that;
2. the window, `--seconds` long:
   - `--trace 0`: the steps run back to back; a CUDA event after each
     marks its end; the window ends in a synchronize. The end-to-end
     metrics come from it;
   - `--trace 1`: a free-running part (all but the last TRACED_TAIL
     seconds), then a profiled sub-window (torch.profiler, CPU and CUDA
     activities, PROFILE_SECONDS), then a synced sub-window (a synchronize
     before each call, SYNCED_SECONDS). The per-layer metrics come from
     them;
3. the check: the program's state is freed, the reference runs the same
   first steps from the same inputs, and `compare.py` decides `correct`;
4. the result: one JSON line on standard output, the numbers compared
   beside their limits last on standard error and last in the line.

A run exits with another code than 0, and prints no result, without a CUDA
card (or fewer than the cell asks for), without the program in the
checkout, and when JAX or the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
PROGRAM = "imagegeneration_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "imagegeneration_tpu")
CHECKED_STEPS = 3
WARM_STEPS = 2
TRACED_TAIL = 2.5
PROFILE_SECONDS = 0.5
SYNCED_SECONDS = 1.5
MIN_SUB_STEPS = 3
ANNOTATION = "portbench.profiled"


class BenchError(RuntimeError):
    """A run that cannot give a result."""


def _process_age() -> float | None:
    """Seconds since this process started (/proc), or None where unknown."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = float(Path("/proc/uptime").read_text().split()[0]) - started
    except (OSError, ValueError, IndexError):
        return None
    return age if 0.0 <= age < 3600.0 else None


_IMPORTED_AT = time.monotonic()


def _age() -> float:
    age = _process_age()
    return age if age is not None else time.monotonic() - _IMPORTED_AT


def _seeds(seed: int) -> dict[str, int]:
    """Independent 63-bit seeds of each use, from the run's seed."""
    import hashlib
    out = {}
    for purpose in ("weights", "data", "order", "z", "model"):
        digest = hashlib.sha256(f"{seed}:{purpose}".encode()).digest()
        out[purpose] = int.from_bytes(digest[:8], "little") >> 1
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Marks:
    """Step ends: CUDA events on a card, the host clock on the CPU."""

    def __init__(self, device) -> None:
        import torch
        self.cuda = device.type == "cuda"
        self.torch = torch
        self.marks: list = []

    def record(self) -> None:
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list[float]:
        if self.cuda:
            times = [self.marks[0].elapsed_time(e) for e in self.marks]
        else:
            times = [(t - self.marks[0]) * 1e3 for t in self.marks]
        return [b - a for a, b in zip(times, times[1:])]


class Cell:
    """What a run knows and measured; the metric readers read it."""

    def __init__(self, spec, workload: str) -> None:
        self.spec = spec
        self.name = workload
        self.workload = spec.workload(workload)
        self.cfg = spec.config(self.workload["config"])
        self.traffic = spec.traffic(self.workload["traffic"])
        self.limits = spec.limits(workload)
        self.family = importlib.import_module(f"portbench.families.{self.cfg['family']}")
        self.reference = importlib.import_module(f"portbench.reference.{self.family.REFERENCE}")
        self.batch = self.traffic["batch_size"]
        self.kind = "cpu"
        self.setup_s = math.nan
        self.window: dict = {}
        self.peak_bytes = 0
        self.free: dict = {}
        self.profiled = None
        self.profiled_steps = 0
        self.host_s: list[float] = []
        self.power_limit = "unknown"


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_for(prog, datasets, order, seconds: float, device, marks: Marks | None = None,
             min_steps: int = 1) -> tuple[int, float]:
    """Steps back to back for `seconds` (at least `min_steps`), ending in a
    synchronize: (steps, wall seconds)."""
    _sync(device)
    t0 = time.perf_counter()
    if marks is not None:
        marks.record()
    steps = 0
    while steps < min_steps or time.perf_counter() - t0 < seconds:
        prog.step(datasets, order.next())
        steps += 1
        if marks is not None:
            marks.record()
    _sync(device)
    return steps, time.perf_counter() - t0


def _profile(cell: Cell, prog, datasets, order, device) -> None:
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import trace

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(ANNOTATION):
            cell.profiled_steps, _ = _run_for(prog, datasets, order, PROFILE_SECONDS, device,
                                              min_steps=MIN_SUB_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        cell.profiled = trace.Window.from_file(path, ANNOTATION)


def _synced(cell: Cell, prog, datasets, order, device) -> None:
    t_end = time.perf_counter() + SYNCED_SECONDS
    while len(cell.host_s) < MIN_SUB_STEPS or time.perf_counter() < t_end:
        rows = order.next()
        _sync(device)
        t0 = time.perf_counter()
        prog.step(datasets, rows)
        cell.host_s.append(time.perf_counter() - t0)
    _sync(device)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out[0].strip() if out else "unknown"


def open_cell(workload: str, spec=None, device: str = "cuda"):
    """(cell, device) with the program imported from the checkout and its
    numerics set; raises BenchError where a run cannot go on."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    import torch

    from portbench import spec as speclib

    cell = Cell(spec or speclib.Spec.load(ROOT), workload)
    chips = cell.workload["chips"]
    if device == "cuda":
        if not torch.cuda.is_available():
            raise BenchError("no CUDA card is visible")
        if torch.cuda.device_count() < chips:
            raise BenchError(f"the cell needs {chips} card(s), "
                             f"{torch.cuda.device_count()} visible")
    try:
        program = importlib.import_module(PROGRAM)
    except ImportError as e:
        raise BenchError(f"the program ({PROGRAM}) is not in this checkout: {e}") from e
    if ROOT not in Path(program.__file__).resolve().parents:
        raise BenchError(f"{PROGRAM} was found outside the checkout, at {program.__file__}")
    from imagegeneration_tpu_torch.core import platform

    dev = platform.require_cuda() if device == "cuda" else platform.resolve_device("cpu")
    if dev.type == "cuda":
        cell.kind = torch.cuda.get_device_name(dev)
    return cell, dev


class Inputs:
    """What the benchmark makes from the run's seed and hands to both sides."""

    def __init__(self, cell: Cell, seed: int, dev) -> None:
        from portbench import traffic as trafficlib

        self.seeds = _seeds(seed)
        self.specs = cell.reference.param_specs(cell.cfg)
        self.dev = dev
        self.datasets = trafficlib.make_datasets(cell.traffic, cell.cfg["image_size"],
                                                 self.seeds["data"], dev)
        self.order = trafficlib.EpochOrder(cell.traffic, self.seeds["order"], dev)
        self.checked_rows: list[list] = []

    def weights(self) -> dict:
        from portbench import weights as weightlib
        return weightlib.make(self.specs, self.seeds["weights"], self.dev)


def program_readings(cell: Cell, prog, inputs: Inputs, start: dict) -> dict:
    """Drive the program through its checked steps by the window's own call,
    keeping each step's index tables: its readings, as floats."""
    from portbench import compare

    losses, grad1 = [], {}
    for s in range(CHECKED_STEPS):
        rows = inputs.order.next()
        inputs.checked_rows.append([r.clone() for r in rows])
        metrics = prog.step(inputs.datasets, rows)
        losses.append({k: metrics[k][0] for k in cell.family.LOSSES})
        if s == 0:
            grad1 = compare.first_moments(prog.leaves())
    change = compare.changes({n: p for n, p, _, _ in prog.leaves()}, start)
    return compare.to_floats({"losses": losses, "grad1": grad1, "change": change})


def reference_readings(cell: Cell, inputs: Inputs, precision: str = "f32",
                       fault: str | None = None) -> dict:
    """The reference's readings over the checked steps' batches."""
    from portbench import compare

    start = inputs.weights()
    trainer = cell.reference.Trainer(cell.cfg, start, inputs.seeds, inputs.dev, cell.batch,
                                     precision=precision, fault=fault)
    batches = [[d.index_select(0, r[0]) for d, r in zip(inputs.datasets, rows)]
               for rows in inputs.checked_rows]
    with trainer.prec.numerics():
        return compare.reference_readings(trainer, batches, start)


def free_device(dev) -> None:
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run(workload: str, seed: int, seconds: float, traced: bool, *, spec=None,
        device: str = "cuda", plant=None) -> dict:
    """One run of a cell; the result's JSON object. `device="cpu"` and
    `plant` (a callable run before set-up, which may break the program
    under test) are for the harness's own tests."""
    import torch

    from portbench import compare

    cell, dev = open_cell(workload, spec, device)
    if plant is not None:
        plant()

    # ---- set-up
    inputs = Inputs(cell, seed, dev)
    start = inputs.weights()
    prog = cell.family.Program(cell.cfg, cell.traffic, start, inputs.seeds, dev)
    prog_readings = program_readings(cell, prog, inputs, start)
    del start
    datasets, order = inputs.datasets, inputs.order
    for _ in range(WARM_STEPS):
        prog.step(datasets, order.next())
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cell.setup_s = _age()

    # ---- the window
    if not traced:
        marks = Marks(dev)
        steps, wall = _run_for(prog, datasets, order, seconds, dev, marks)
        cell.window = {"steps": steps, "seconds": wall, "intervals_ms": marks.intervals_ms()}
    else:
        steps, wall = _run_for(prog, datasets, order, max(seconds - TRACED_TAIL, 1.0), dev)
        cell.free = {"steps": steps, "seconds": wall}
    if dev.type == "cuda":
        cell.peak_bytes = torch.cuda.max_memory_allocated(dev)
    if traced:
        _profile(cell, prog, datasets, order, dev)
        _synced(cell, prog, datasets, order, dev)
        steps += cell.profiled_steps + len(cell.host_s)
        cell.power_limit = _power_limit()

    # ---- the check, after the program's state is freed
    del prog
    free_device(dev)
    metrics = _read_metrics(cell, traced)
    numbers = compare.gaps(prog_readings, reference_readings(cell, inputs),
                           cell.family.FIRST_LOSSES)
    correct = compare.verdict(numbers, cell.limits)

    loaded = forbidden_modules()
    if loaded:
        raise BenchError(f"JAX or the JAX package is loaded: {', '.join(loaded)}")
    result = {
        "correct": correct,
        "attempted": steps,
        "failed": sum(1 for k, limit in cell.limits.items() if not numbers[k] <= limit),
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": cell.kind,
                   "count": cell.workload["chips"], "memory_peak_bytes": cell.peak_bytes},
    }
    if traced:
        result["device"].update({"busy_s": cell.profiled.busy_us() * 1e-6,
                                 "window_s": cell.profiled.span_us * 1e-6,
                                 "card": cell.power_limit})
        result["breakdown"] = {"device_ops": cell.profiled.top_device_ops(),
                               "idle_gaps": cell.profiled.idle_gaps()}
    result["checks"] = {k: {"value": numbers[k], "limit": limit}
                        for k, limit in cell.limits.items()}
    return result


def _read_metrics(cell: Cell, traced: bool) -> dict:
    out = {}
    for m in cell.spec.metrics_of(cell.name, traced):
        value = cell.spec.reader(m["name"]).read(cell)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except BenchError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    if args.trace:
        print(f"card: {result['device']['card']}", file=sys.stderr)
    for name, m in result["metrics"].items():
        print(f"metric {name} {m['value']!r} {m['unit']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
