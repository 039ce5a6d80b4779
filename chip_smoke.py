#!/usr/bin/env python3
"""Smoke run of the PyTorch port (imagegeneration_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is non-zero):

1. Require a CUDA device; print the Python/torch/CUDA versions and the
   card's name and power limit.
2. Build the hand-written CUDA kernels from csrc/ (nvcc + ctypes).
3. Each kernel against its plain PyTorch version on the card, at the shapes
   of the headline SNDCGAN step (256x144, batch 32, base_width 512, bf16):
   the fused LeakyReLU + hash dropout forward and backward at each of the
   four distinct discriminator site shapes (timed at the largest), and
   Keras Adam on every generator and discriminator leaf. Both times are
   measured with CUDA events.
4. A small float32 step on the card against the same step on the CPU (the
   plain kernel versions), from the same weights, latents and key words.
5. The training slice through its entry point, SNDCGANEngine: spectral-norm
   D, hinge loss, bf16, one epoch with a checkpoint, then a new engine that
   resumes from it for a second epoch. The kernels' launch counters are
   zeroed just before and read just after; every kernel must have run, as
   often as the step's structure says.

Output: progress lines, then a JSON line with one record per kernel, the
card's `name, power.limit` line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import sys
import tempfile
import time

import torch

from imagegeneration_tpu_torch.core import platform
from imagegeneration_tpu_torch.core.data import SyntheticImageDataset
from imagegeneration_tpu_torch.core.rng import KeyChain
from imagegeneration_tpu_torch.models.sndcgan import DISC_TRUNK, SNDCGANConfig
from imagegeneration_tpu_torch.ops import adam, dropout, native
from imagegeneration_tpu_torch.train import sndcgan_step as steplib
from imagegeneration_tpu_torch.train.sndcgan_engine import SNDCGANEngine

HEIGHT, WIDTH, BATCH, BASE = 144, 256, 32, 512
EPOCH_BATCHES = 8
BF16_ULP = 2.0**-7  # one bfloat16 ulp is at most |v| * 2^-7


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {what}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn`, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_ulp_f32(a: torch.Tensor, b: torch.Tensor) -> int:
    def key(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((key(a) - key(b)).abs().max())


def disc_site_shapes() -> list[tuple[int, int, int, int]]:
    """The distinct (B, C, H, W) dropout-site shapes of the headline D."""
    shapes, h, w = [], HEIGHT, WIDTH
    for filters, _, (sh, sw) in DISC_TRUNK:
        h, w = -(-h // sh), -(-w // sw)
        if (BATCH, filters, h, w) not in shapes:
            shapes.append((BATCH, filters, h, w))
    return shapes


def check_dropout(dev: torch.device, card: str) -> list[dict]:
    """Kernel vs plain at every distinct D site shape of the headline step
    (bf16, channels_last); timed at the largest, (32, 64, 144, 256)."""
    kw = KeyChain(7).dropout_kw(torch.zeros((), dtype=torch.int64, device=dev), 1)[0]
    cut = dropout.dropout_cut(0.5)
    names = ("leaky_relu_dropout_fwd", "leaky_relu_dropout_bwd")
    max_err = dict.fromkeys(names, 0.0)
    shapes = disc_site_shapes()
    for shape in shapes:
        gen = torch.Generator(device=dev).manual_seed(sum(shape))
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        g = g.contiguous(memory_format=torch.channels_last)
        b, c, h, w = shape
        keep_kernel = dropout.fwd_kernel(torch.ones_like(x), kw, cut) != 0
        keep_plain = dropout.hash_keep_mask(kw, x.numel(), cut).view(
            b, h, w, c).permute(0, 3, 1, 2)
        require(torch.equal(keep_kernel, keep_plain),
                f"dropout mask differs from plain at {shape}")
        frac = keep_kernel.float().mean().item()
        require(abs(frac - 0.5) < 1e-3, f"dropout keep fraction {frac} at {shape}")
        for name, kernel, plain in (
            (names[0], lambda: dropout.fwd_kernel(x, kw, cut),
             lambda: dropout.fwd_plain(x, kw, cut)),
            (names[1], lambda: dropout.bwd_kernel(x, g, kw, cut),
             lambda: dropout.bwd_plain(x, g, kw, cut)),
        ):
            yk, yp = kernel().float(), plain().float()
            err = (yk - yp).abs()
            require(torch.equal(yk == 0, yp == 0), f"{name} {shape}: zero pattern differs")
            require(bool((err <= yp.abs() * BF16_ULP).all()),
                    f"{name} {shape}: beyond 1 bf16 ulp")
            max_err[name] = max(max_err[name], err.max().item())
        log(f"dropout kernels at {shape}: mask identical, max abs err "
            f"fwd {max_err[names[0]]:.3g} bwd {max_err[names[1]]:.3g}")

    # Timed at the largest site shape.
    b, c, h, w = shapes[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(shapes[0], generator=gen, device=dev).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    g = torch.randn(shapes[0], generator=gen, device=dev).to(torch.bfloat16)
    g = g.contiguous(memory_format=torch.channels_last)
    out = []
    for name, kernel, plain, line in (
        (names[0], lambda: dropout.fwd_kernel(x, kw, cut),
         lambda: dropout.fwd_plain(x, kw, cut), 50),
        (names[1], lambda: dropout.bwd_kernel(x, g, kw, cut),
         lambda: dropout.bwd_plain(x, g, kw, cut), 61),
    ):
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        out.append({
            "name": name, "route": "cuda",
            "source": "imagegeneration_tpu_torch/csrc/leaky_relu_dropout.cu",
            "replaces": f"imagegeneration_tpu/ops/pallas/dropout.py:{line}",
            "max_abs_err": max_err[name], "tolerance": "1 bf16 ulp, mask exact",
            "checked_shapes_nchw": [list(s) for s in shapes],
            "ms": ms, "plain_ms": plain_ms, "timed_shape_nhwc": [b, h, w, c],
            "dtype": "bfloat16",
        })
        log(f"{name} at {shapes[0]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"({card})")
    return out


def check_adam(dev: torch.device, card: str) -> dict:
    """Kernel vs plain on every leaf of the headline G and D, one apply."""
    cfg = steplib.SNDCGANTrainConfig(model=SNDCGANConfig(
        image_size=(HEIGHT, WIDTH, 3), base_width=BASE, spectral_norm=True,
        dtype=torch.bfloat16))
    state = steplib.init_state(cfg, dev)
    leaves = [p.detach() for p in state.gen.parameters()] + [
        p.detach() for p in state.disc.parameters()]
    gen = torch.Generator(device=dev).manual_seed(1)
    grads = [torch.randn(p.shape, generator=gen, device=dev) for p in leaves]
    ms_ = [torch.randn(p.shape, generator=gen, device=dev) for p in leaves]
    vs_ = [torch.rand(p.shape, generator=gen, device=dev) for p in leaves]
    alpha = adam.adam_alpha(torch.tensor(3, device=dev), 2e-4, 0.9, 0.999)
    worst = 0
    max_err = 0.0
    for p, g, m, v in zip(leaves, grads, ms_, vs_):
        pk, mk, vk = p.clone(), m.clone(), v.clone()
        pp, mp, vp = p.clone(), m.clone(), v.clone()
        adam.adam_leaf_kernel(pk, g, mk, vk, alpha, 0.9, 0.999)
        adam.adam_leaf_plain(pp, g, mp, vp, alpha, 0.9, 0.999)
        for a, b in ((pk, pp), (mk, mp), (vk, vp)):
            worst = max(worst, max_ulp_f32(a, b))
            max_err = max(max_err, (a - b).abs().max().item())
    require(worst <= 2, f"adam kernel {worst} ulp from plain (bound 2)")

    def run(apply_leaf):
        for p, g, m, v in zip(leaves, grads, ms_, vs_):
            apply_leaf(p, g, m, v, alpha, 0.9, 0.999)

    ms = cuda_ms(lambda: run(adam.adam_leaf_kernel), iters=10)
    plain_ms = cuda_ms(lambda: run(adam.adam_leaf_plain), iters=10)
    n = sum(p.numel() for p in leaves)
    log(f"adam ({len(leaves)} leaves, {n:,} elements): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, max {worst} ulp ({card})")
    return {
        "name": "adam", "route": "cuda", "source": "imagegeneration_tpu_torch/csrc/adam.cu",
        "replaces": "imagegeneration_tpu/ops/pallas/adam.py:69",
        "max_abs_err": max_err, "max_ulp": worst, "tolerance": "2 ulp",
        "ms": ms, "plain_ms": plain_ms, "leaves": len(leaves), "elements": n,
        "ms_is_per": "one apply over every G and D leaf",
    }


def check_small_step_against_cpu(dev: torch.device) -> None:
    """Two float32 steps of a small config on the card and on the CPU."""
    cfg = steplib.SNDCGANTrainConfig(
        model=SNDCGANConfig(image_size=(32, 48, 3), base_width=32, spectral_norm=True),
        batch_size=4, loss="hinge")
    gen = torch.Generator().manual_seed(3)
    batches = torch.randint(0, 256, (2, 4, 32, 48, 3), generator=gen, dtype=torch.uint8)
    zs = torch.rand((2, 4, 128), generator=gen) * 2 - 1
    kw = torch.randint(0, 2**32, (steplib.N_SITES, 2), generator=gen, dtype=torch.int64)
    results = []
    for d in (torch.device("cpu"), dev):
        state = steplib.init_state(cfg, d)
        step = steplib.make_train_step(cfg)
        ms = []
        for i in range(2):
            state, m = step(state, batches[i].to(d), zs[i].to(d), kw.to(d))
            ms.append({k: float(v) for k, v in m.items()})
        sample = steplib.make_sampler(cfg)(state, zs[0].to(d)).cpu()
        results.append((ms, sample))
    (m_cpu, s_cpu), (m_gpu, s_gpu) = results
    for i, (a, b) in enumerate(zip(m_gpu, m_cpu)):
        for k in b:
            require(math.isfinite(a[k]) and abs(a[k] - b[k]) <= 1e-3 * max(1.0, abs(b[k])),
                    f"small step {i} {k}: cuda {a[k]} vs cpu {b[k]}")
    err = (s_gpu - s_cpu).abs().max().item()
    require(err <= 1e-3, f"small step samples differ by {err}")
    log(f"small float32 step, card vs CPU: metrics within 1e-3, samples max abs err {err:.3g}")


def run_slice(dev: torch.device, card: str) -> dict:
    dataset = SyntheticImageDataset(EPOCH_BATCHES * BATCH, (HEIGHT, WIDTH))
    kwargs = dict(image_size=(HEIGHT, WIDTH, 3), device=dev, spectral_norm=True,
                  loss="hinge", dtype=torch.bfloat16, base_width=BASE)
    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/sndcgan"
        engine = SNDCGANEngine(out, dataset, BATCH, **kwargs)
        n_g = len(list(engine.state.gen.parameters()))
        n_d = len(list(engine.state.disc.parameters()))
        for counts in (dropout.LAUNCHES, adam.LAUNCHES):
            for k in counts:
                counts[k] = 0
        engine.train(1, 1)  # epoch 0, checkpointed
        first = engine.last_epoch_metrics
        resumed = SNDCGANEngine(out, dataset, BATCH, continue_=True, **kwargs)
        require(resumed.start_epoch == 1, "resume did not start at epoch 1")
        require(int(resumed.state.step) == EPOCH_BATCHES, "resumed step counter")
        resumed.train(2, 1)  # epoch 1
        torch.cuda.synchronize()
        launches = {**dropout.LAUNCHES, **adam.LAUNCHES}
        second = resumed.last_epoch_metrics
        with open(f"{out}/perf.jsonl") as f:
            perf = [json.loads(line) for line in f]
        steps = int(resumed.state.step)
    require(steps == 2 * EPOCH_BATCHES, f"step counter {steps}")
    for name, m in (("epoch 0", first), ("epoch 1", second)):
        require(all(math.isfinite(v) for v in m.values()), f"{name} losses {m}")
    want = {
        "leaky_relu_dropout_fwd": steplib.N_SITES * steps,
        "leaky_relu_dropout_bwd": steplib.N_SITES * steps,
        "adam": (n_g + 2 * n_d) * steps,
    }
    require(launches == want, f"launch counts {launches}, expected {want}")
    log(f"slice: {steps} steps over 2 epochs (one resumed), losses {second}")
    log(f"slice: launches {launches}")
    log(f"slice: epoch 1 {perf[-1]['steps_per_sec']:.3f} steps/s, "
        f"{perf[-1]['images_per_sec']:.1f} images/s at {WIDTH}x{HEIGHT} bs{BATCH} "
        f"base {BASE} SN hinge bf16 ({card})")
    return {"launches": launches, "perf": perf, "metrics": second}


def main() -> int:
    dev = platform.require_cuda()
    numerics = platform.configure_numerics()
    card = platform.card_description()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {numerics}")
    log(f"card: {card}")

    t0 = time.perf_counter()
    for name in ("leaky_relu_dropout", "adam"):
        native.load(name)
        info = native.BUILD_LOG[name]
        regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
        log(f"built {name}.cu in {info['seconds']:.2f} s: {regs}")
    log(f"kernel build total {time.perf_counter() - t0:.2f} s")

    kernels = check_dropout(dev, card)
    kernels.append(check_adam(dev, card))
    check_small_step_against_cpu(dev)
    result = run_slice(dev, card)
    for k in kernels:
        k["launches"] = result["launches"][k["name"]]
    print(json.dumps({"kernels": kernels, "slice": {
        "steps_per_sec": result["perf"][-1]["steps_per_sec"],
        "config": f"{HEIGHT}x{WIDTH} bs{BATCH} base{BASE} SN hinge bf16 d_updates=2",
        "card": card}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
