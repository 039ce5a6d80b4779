#!/usr/bin/env python3
"""Device and host time of the Keras-Adam apply over each headline slice's
leaves, on one CUDA card, for the checkout it is pointed at.

    python imagegeneration_tpu_torch/tools/adam_times.py [--tree DIR] [--out FILE]

`--tree` (default: the checkout holding this file) goes first on the import
path, so that one command can time two checkouts in turns (a parent
unpacked beside the change). A tree whose ops/adam.py has `LeafTable`
applies a list of leaves in one launch per table group; an older tree
launches once per leaf (`adam_leaf_kernel`). Each slice's leaves are those
of its headline state (SNDCGAN 256x144 base 512: 29 leaves, b1 0.9;
CycleGAN 128x128 base 64, 9 res blocks: 224 leaves, b1 0.5), with random
g, m, v in each leaf's own layout. For each slice:

- `warm_ms`: device ms of one apply over every leaf, from CUDA events, the
  card held while the host queues `iters` applies back to back
  (tools/devtime.py), for each iters of QUEUED. If the host cannot queue
  the launches as fast as the card runs them, the card runs dry inside the
  window and the longer windows read high.
- `profiler`: the same apply under torch.profiler: its kernels' summed
  durations, and the span from the first kernel's start to the last one's
  end, per apply (events found beside the count expected).
- `host_us_per_apply`: host microseconds per `adam_apply` over each model's
  leaves (perf_counter, no sync), as the step calls it; beside it the
  kernel call alone (the table apply, or the loop of per-leaf calls) and
  the alpha chain alone (`count.add_` and `adam_alpha`).
- `by_chunk` (one-launch route only): warm ms for each chunk size of
  CHUNKS.
- `library`: the one PyTorch call that computes the same update (never
  used by the port), `torch._fused_adam_` with lr, the same betas, and eps
  rescaled to eps / sqrt(1 - b2^t): its denominator sqrt(v) / sqrt(1 -
  b2^t) + eps' is then (sqrt(v) + eps) / sqrt(1 - b2^t), and its step
  lr * sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps), the Keras form.
  Its m and v after one apply are first held to the plain version
  (`adam_plain`) within LIBRARY_MAX_ULP float32 ulps of each element's
  largest term (b * m or (1 - b) * g; likewise for v) plus the library's
  constant: it forms 1 - b from b rounded to float32, the plain version
  rounds 1 - b itself (1 - 0.999f is 1.3e-5 off 0.001, 1 - 0.9f 2.4e-7 off
  0.1), times g (g^2 for v). p is held within as many ulps of max(|p|, the
  update's scale alpha * that m term / (sqrt(v) + eps)) plus the float32
  rounding of b2^t that 1 - b2^t magnifies (2^-23 / (1 - b2^t) of the
  update, on either side: both compute the bias correction in float32).
  Then it is timed as the kernel is (`warm_ms`).

Prints one line per measurement, the card's name and power limit, and as
the last line the results as one JSON object (also written to --out).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

QUEUED = (1, 2, 10)
CHUNKS = (1024, 2048, 4096, 8192, 16384)
PROFILED_APPLIES = 10
HOST_ROUNDS = 20
STEP = 3  # the Adam step count t of the timed applies
LIBRARY = ("torch._fused_adam_(p, g, m, v, [], steps, lr=lr, beta1=b1, beta2=0.999, "
           "weight_decay=0, eps=1e-7 / sqrt(1 - 0.999**t), amsgrad=False, maximize=False)")
# Beyond its constants (the module note), the library rounds the moments
# and the step (lr / (1 - b1^t), then m / (sqrt(v) / sqrt(1 - b2^t) +
# eps')) in another order than the plain version: a few float32 ulps of
# the terms. A wrong update (Keras's eps unscaled, a moment's b swapped) is
# off by orders of magnitude more.
LIBRARY_MAX_ULP = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def library_call(p: list, g: list, m: list, v: list, b1: float, lr: float = 2e-4):
    """The library call over the leaves (in place) at step STEP, as a
    callable (the module note; never used by the port)."""
    import torch

    steps = [torch.tensor(float(STEP), device=t.device) for t in p]
    eps = 1e-7 / math.sqrt(1.0 - 0.999**STEP)  # Keras's eps, rescaled
    return lambda: torch._fused_adam_(p, g, m, v, [], steps, lr=lr, beta1=b1, beta2=0.999,
                                      weight_decay=0.0, eps=eps, amsgrad=False,
                                      maximize=False)


def library_distance(p: list, g: list, m: list, v: list, b1: float, adam) -> dict:
    """One library apply and one plain apply (`adam.adam_plain`) from copies
    of p, m, v: each result's largest distance in units of its bound's
    terms (the module note), by p, m and v."""
    import torch

    def ulp(x):
        x = x.abs()
        return torch.nextafter(x, torch.full_like(x, math.inf)) - x

    lib = [[t.clone() for t in ts] for ts in (p, m, v)]
    ref = [[t.clone() for t in ts] for ts in (p, m, v)]
    library_call(lib[0], g, lib[1], lib[2], b1)()
    alpha = adam.adam_alpha(torch.tensor(STEP, device=p[0].device), 2e-4, b1, 0.999)
    adam.adam_plain(ref[0], g, ref[1], ref[2], alpha, b1, 0.999)
    cancel = 2.0**-23 / (1.0 - 0.999**STEP)
    one_minus = {b: abs((1.0 - float(torch.tensor(b, dtype=torch.float32)))
                        - float(torch.tensor(1.0 - b, dtype=torch.float32)))
                 for b in (b1, 0.999)}
    out = {"p": 0.0, "m": 0.0, "v": 0.0}
    for i, gi in enumerate(g):
        sm = torch.maximum((b1 * m[i]).abs(), ((1 - b1) * gi).abs())
        sv = torch.maximum((0.999 * v[i]).abs(), (0.001 * gi * gi).abs())
        update = alpha * sm / (ref[2][i].sqrt() + adam.KERAS_EPS)
        sp = ulp(torch.maximum(p[i].abs(), update)) + cancel * (ref[0][i] - p[i]).abs()
        scales = (("p", sp, 0), ("m", ulp(sm) + one_minus[b1] * gi.abs(), 1),
                  ("v", ulp(sv) + one_minus[0.999] * gi * gi, 2))
        for k, scale, j in scales:
            out[k] = max(out[k], float(((lib[j][i] - ref[j][i]).abs() / scale).max()))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose imagegeneration_tpu_torch is timed")
    ap.add_argument("--out", help="JSON file for the results")
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch
    from torch.profiler import ProfilerActivity, profile

    from imagegeneration_tpu_torch.core import platform
    from imagegeneration_tpu_torch.models.cyclegan import CycleGANConfig
    from imagegeneration_tpu_torch.models.sndcgan import SNDCGANConfig
    from imagegeneration_tpu_torch.ops import adam
    from imagegeneration_tpu_torch.tools.devtime import device_ms
    from imagegeneration_tpu_torch.train import cyclegan_step
    from imagegeneration_tpu_torch.train import sndcgan_step as steplib

    import imagegeneration_tpu_torch
    if Path(imagegeneration_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {imagegeneration_tpu_torch.__file__}, not from {tree}")
    dev = platform.require_cuda()
    card = platform.card_description()
    one_launch = hasattr(adam, "LeafTable")
    route = "one launch per table group" if one_launch else "one launch per leaf"
    log(f"tree {tree}: {route}; torch {torch.__version__}; card: {card}")

    def models_of(path: str):
        if path == "sndcgan":
            state = steplib.init_state(steplib.SNDCGANTrainConfig(model=SNDCGANConfig(
                image_size=(144, 256, 3), base_width=512, spectral_norm=True,
                dtype=torch.bfloat16)), dev)
            return [list(m.parameters()) for m in (state.gen, state.disc)], 0.9
        cfg = cyclegan_step.CycleGANTrainConfig(model=CycleGANConfig(
            image_size=(128, 128, 3), base_width=64, n_res_blocks=9))
        state = cyclegan_step.init_state(cfg, dev)
        models = (state.gen_g, state.gen_f, state.disc_x, state.disc_y)
        return [list(m.parameters()) for m in models], cfg.beta1

    def inputs(leaves, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            p = [t.detach().clone() for t in leaves]
            g = [torch.empty_like(t).normal_(generator=gen) for t in p]
            m = [torch.empty_like(t).normal_(generator=gen) for t in p]
            v = [torch.empty_like(t).uniform_(generator=gen) for t in p]
        return p, g, m, v

    def apply_fn(p, g, m, v, alpha, b1, chunk=None):
        if one_launch:
            table = adam.LeafTable(p, m, v, chunk=chunk or adam.CHUNK)
            return lambda: adam.adam_kernel(table, g, alpha, b1, 0.999)

        def per_leaf():
            for leaf in zip(p, g, m, v):
                adam.adam_leaf_kernel(*leaf, alpha, b1, 0.999)
        return per_leaf

    def profiled(fn) -> dict:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_APPLIES):
                fn()
            torch.cuda.synchronize()
        kernels = sorted(
            (e.time_range.start, e.time_range.end) for e in prof.events()
            if "adam" in e.name and e.device_type == torch.autograd.DeviceType.CUDA)
        if not kernels:
            return {"kernel_events": 0}
        return {"kernel_events": len(kernels),
                "summed_ms_per_apply": sum(b - a for a, b in kernels) / 1e3 / PROFILED_APPLIES,
                "span_ms_per_apply": (kernels[-1][1] - kernels[0][0]) / 1e3 / PROFILED_APPLIES}

    results = {"tree": str(tree), "route": route, "card": card, "torch": torch.__version__}
    for path in ("sndcgan", "cyclegan"):
        models, b1 = models_of(path)
        leaves = [t for ms in models for t in ms]
        p, g, m, v = inputs(leaves, 1)
        alpha = adam.adam_alpha(torch.tensor(STEP, device=dev), 2e-4, b1, 0.999)
        fn = apply_fn(p, g, m, v, alpha, b1)
        n = sum(t.numel() for t in leaves)
        before = adam.LAUNCHES["adam"]
        fn()
        launches = adam.LAUNCHES["adam"] - before
        rec = {"leaves": len(leaves), "elements": n, "launches_per_apply": launches,
               "bound_ms": 28 * n / 3.35e12 * 1e3,
               "warm_ms": {str(k): device_ms(fn, k) for k in QUEUED},
               "profiler": profiled(fn)}
        rec["profiler"]["kernel_events_expected"] = PROFILED_APPLIES * launches
        rec["library"] = {"call": LIBRARY, "max_ulp": library_distance(p, g, m, v, b1, adam)}
        if max(rec["library"]["max_ulp"].values()) > LIBRARY_MAX_ULP:
            raise RuntimeError(f"{path}: the library call is {rec['library']['max_ulp']} "
                               f"ulps from the plain version, over {LIBRARY_MAX_ULP}")
        rec["library"]["warm_ms"] = {str(k): device_ms(library_call(p, g, m, v, b1), k)
                                     for k in QUEUED}
        if one_launch:
            rec["by_chunk"] = {str(c): device_ms(apply_fn(p, g, m, v, alpha, b1, c), 10)
                               for c in CHUNKS}
        host = {"apply": [], "kernel_call": [], "alpha_chain": []}
        for params in models:
            pm, gm, mm, vm = inputs(params, 2)
            count = torch.zeros((), dtype=torch.int64, device=dev)
            extra = {"table": adam.LeafTable(pm, mm, vm)} if one_launch else {}

            def alpha_chain():
                count.add_(1)
                adam.adam_alpha(count, 2e-4, b1, 0.999)

            for part, call in (
                ("apply", lambda: adam.adam_apply(pm, gm, mm, vm, count, 2e-4, b1, 0.999,
                                                  **extra)),
                ("kernel_call", apply_fn(pm, gm, mm, vm, alpha, b1)),
                ("alpha_chain", alpha_chain),
            ):
                for _ in range(5):
                    call()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(HOST_ROUNDS):
                    call()
                host[part].append((time.perf_counter() - t0) * 1e6 / HOST_ROUNDS)
                torch.cuda.synchronize()
        rec["host_us_per_apply_by_model"] = host["apply"]
        rec["host_us_per_apply"] = sum(host["apply"]) / len(models)
        rec["host_us_by_part_by_model"] = host
        results[path] = rec
        log(f"{path} ({len(leaves)} leaves, {n:,} elements, bound {rec['bound_ms']:.4f} ms): "
            f"warm {', '.join(f'{k} queued {t:.4f}' for k, t in rec['warm_ms'].items())} "
            f"ms per apply; library call {rec['library']['warm_ms']} ms, "
            f"{rec['library']['max_ulp']} ulps from plain; profiler {rec['profiler']}; host "
            f"{rec['host_us_per_apply']:.1f} us per apply "
            f"{ {k: [round(h, 1) for h in v] for k, v in host.items()} }"
            + (f"; by chunk {rec['by_chunk']}" if one_launch else "") + f" ({card})")
        del p, g, m, v, models, leaves, fn
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    print(card)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
