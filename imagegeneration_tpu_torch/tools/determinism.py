#!/usr/bin/env python3
"""What deterministic cuDNN costs the three train steps, on one CUDA card.

    python -m imagegeneration_tpu_torch.tools.determinism --out DIR
        [--workload {sndcgan,cyclegan,wgan} ...]

The steps are tools/profile_step.py's headline configurations (the ones
chip_smoke.py's phase 5 trains), from the seeded state, on synthetic
batches held on the card. The trainers run with cuDNN held to deterministic
algorithms (core/platform.configure_numerics); this tool sets the flags
itself to read the settings beside each other:

- "free": `cudnn.deterministic` off, `cudnn.benchmark` off (cuDNN's
  heuristics may pick an algorithm that accumulates with atomics);
- "deterministic": on, off (the trainers' setting);
- "deterministic_benchmark": on, on (the fastest deterministic algorithm,
  timed per shape on first use).

Phases, per workload:

1. probe: one step, under the trainers' setting, with
   `torch.use_deterministic_algorithms(True)`: an op that PyTorch itself
   knows to be non-deterministic on the card (an `index_add_`, a scatter,
   an atomic in a library backward), in the forward or in the autograd
   backward, raises; the first such op's message is kept (None: no op
   raised). cuBLAS's alert asks for CUBLAS_WORKSPACE_CONFIG=:4096:8, which
   the tool sets before the card is first used: it is PyTorch's default
   workspace on the H100 (32 MiB), so the timings are the trainers'.
2. twice: under each setting, RUN_TWICE_STEPS steps from the seeded state,
   run twice; the two states' digests and their largest difference
   per collection (relative to its largest |v|).
3. rate: windows of WINDOW steps under each setting in turns (free, det,
   bench, bench, det, free) twice, each after WARMUP steps under it; ms per
   step on the host clock around work that ends in a synchronize.

Before them, `pads`: the backward of a REFLECT pad at the CycleGAN
generator's pads (PAD_SHAPES), run twice on the same gradient, for
F.pad(mode="reflect") and for the port's nn/layers.reflection_pad_2d:
bit-equal or not (cuDNN's setting does not reach it).

Writes DIR/determinism.json; the card's name and power limit are printed
before the last line, the summary as one JSON object. Without a CUDA card
the tool fails.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
from pathlib import Path

import torch

from imagegeneration_tpu_torch.core import platform
from imagegeneration_tpu_torch.parallel import dp
from imagegeneration_tpu_torch.tools.profile_step import WORKLOADS, StepLoop

# cudnn.deterministic, cudnn.benchmark
SETTINGS = {"free": (False, False), "deterministic": (True, False),
            "deterministic_benchmark": (True, True)}
ORDER = ("free", "deterministic", "deterministic_benchmark",
         "deterministic_benchmark", "deterministic", "free") * 2
WINDOW = 10
WARMUP = 2
RUN_TWICE_STEPS = 5  # one WGAN gan update among them (n_critic 5)
# (B, C, H, W), pad: the CycleGAN generator's stem input and res-block maps
PAD_SHAPES = (((4, 3, 128, 128), 3), ((4, 256, 32, 32), 1))


def log(msg: str) -> None:
    print(msg, flush=True)


def use(setting: str) -> None:
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = SETTINGS[setting]


def state_gap(a: dict, b: dict) -> dict:
    """Per collection (a model, or an optimizer's moment), the largest
    |a - b| over the collection's largest |b|; the worst, and where."""
    diff: dict[str, float] = {}
    scale: dict[str, float] = {}
    leaves_a = dict(dp._leaves(a))
    for path, vb in dp._leaves(b):
        if not isinstance(vb, torch.Tensor) or not vb.is_floating_point():
            continue
        parts = path.strip("/").split("/")
        coll = "/".join(parts[:2] if parts[0].endswith("_opt") else parts[:1])
        va, vb = leaves_a[path].double(), vb.double()
        diff[coll] = max(diff.get(coll, 0.0), float((va - vb).abs().max()))
        scale[coll] = max(scale.get(coll, 0.0), float(vb.abs().max()))
    rel = {c: (d / scale[c] if scale[c] else (math.inf if d else 0.0)) for c, d in diff.items()}
    worst = max(rel, key=rel.get)
    return {"worst": rel[worst], "at": worst}


def pads(dev: torch.device) -> list[dict]:
    import torch.nn.functional as F

    from imagegeneration_tpu_torch.nn.layers import reflection_pad_2d

    out = []
    gen = torch.Generator(device=dev).manual_seed(3)
    for shape, pad in PAD_SHAPES:
        x = torch.randn(shape, generator=gen, device=dev).contiguous(
            memory_format=torch.channels_last).requires_grad_(True)
        rec = {"shape": list(shape), "pad": pad}
        for name, fn in (("F.pad", lambda t: F.pad(t, (pad,) * 4, mode="reflect")),
                         ("reflection_pad_2d", lambda t: reflection_pad_2d(t, (pad, pad)))):
            y = fn(x)
            g = torch.randn(y.shape, generator=gen, device=dev)
            a, b = (torch.autograd.grad(fn(x), x, g)[0] for _ in range(2))
            rec[name] = {"bit_equal": bool(torch.equal(a, b)),
                         "max_diff": float((a - b).abs().max())}
        out.append(rec)
    return out


def probe(cfg, dev: torch.device) -> str | None:
    use("deterministic")
    loop = StepLoop(cfg, dev)
    loop.run(1)
    torch.use_deterministic_algorithms(True)
    try:
        loop.run(1)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return str(e).split("\n")[0]
    finally:
        torch.use_deterministic_algorithms(False)
    return None


def _cloned(tree):
    """A copy of a state dict's tensors (the steps update them in place)."""
    if isinstance(tree, dict):
        return {k: _cloned(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cloned(v) for v in tree)
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def run_twice(cfg, dev: torch.device, setting: str) -> dict:
    use(setting)
    states, digests = [], []
    for _ in range(2):
        loop = StepLoop(cfg, dev)
        loop.run(RUN_TWICE_STEPS)
        digests.append(dp.state_digest(loop.state))
        states.append(_cloned(loop.state.state_dict()))
        del loop
    return {"bit_equal": digests[0] == digests[1], "digests": digests,
            **state_gap(states[0], states[1])}


def rates(cfg, dev: torch.device) -> dict:
    loop = StepLoop(cfg, dev)
    windows = []
    for setting in ORDER:
        use(setting)
        loop.run(WARMUP)
        ms = loop.ms_per_step(WINDOW)
        windows.append({"setting": setting, "ms_per_step": ms})
        log(f"  rate: {setting} {ms:.2f} ms/step")
    del loop
    return {"order": list(ORDER), "windows": windows,
            "steps_per_sec": {s: [1e3 / w["ms_per_step"] for w in windows
                                  if w["setting"] == s] for s in SETTINGS}}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory for the results")
    ap.add_argument("--workload", nargs="+", choices=sorted(WORKLOADS),
                    default=["sndcgan", "cyclegan", "wgan"])
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # see the probe
    dev = platform.require_cuda()
    card = platform.card_description()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    summary: dict = {"card": card, "torch": torch.__version__, "pads": pads(dev),
                     "workloads": {}}
    for rec in summary["pads"]:
        log(f"pads: {rec} ({card})")
    for name in args.workload:
        work = WORKLOADS[name]()
        cfg = work.train_config
        log(f"{name}: {work.config} ({card})")
        res = {"config": work.config, "probe": probe(cfg, dev)}
        log(f"  probe: {res['probe'] or 'no op raised'}")
        res["twice"] = {s: run_twice(cfg, dev, s) for s in SETTINGS}
        for s, r in res["twice"].items():
            log(f"  twice: {s} bit-equal {r['bit_equal']}, worst {r['worst']:.3g} at {r['at']}")
        res["rate"] = rates(cfg, dev)
        for s, v in res["rate"]["steps_per_sec"].items():
            log(f"  rate: {s} steps/s {[round(x, 3) for x in v]} ({card})")
        summary["workloads"][name] = res
        gc.collect()
        torch.cuda.empty_cache()
    use("deterministic")  # the trainers' setting again
    (out / "determinism.json").write_text(json.dumps(summary, indent=1))
    print(card)
    print(json.dumps({k: v for k, v in summary.items() if k != "workloads"}
                     | {"steps_per_sec": {n: w["rate"]["steps_per_sec"]
                                          for n, w in summary["workloads"].items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
