#!/usr/bin/env python3
"""Smoke run of the PyTorch port (imagegeneration_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is non-zero):

1. Require a CUDA device; print the Python/torch/CUDA versions and the
   card's name and power limit.
2. Build the hand-written CUDA kernels from csrc/ (one nvcc per source, all
   started together; ctypes binding).
3. Each kernel against its plain PyTorch version on the card, at the shapes
   of the headline steps, with times beside the least time the card could
   take (bytes over 3.35 TB/s, or operations over 67 TFLOP/s float32,
   whichever is larger) and, where one PyTorch call computes the same
   function, that call's time. A time is the device time of a call from
   CUDA events (tools/devtime.py), over back-to-back calls queued while
   the card waits; for the InstanceNorm kernels, whose inputs (4-34 MB)
   would otherwise stay in the 50 MB L2, it is taken around each call with
   the L2 flushed before it, and the warm time is kept beside it as
   `warm_ms`:
   - SNDCGAN (256x144, batch 32, base_width 512, bf16): the fused LeakyReLU
     + hash dropout forward and backward at each of the four distinct
     discriminator site shapes (timed at the largest);
   - Keras Adam: one multi-tensor launch over every generator and
     discriminator leaf of each slice, with that slice's b1 (SNDCGAN 0.9,
     CycleGAN 0.5), bit-identical to the plain version leaf by leaf; timed
     per slice, with the host time per apply of the slice's own applies;
   - CycleGAN (128x128, batch 4, base_width 64, 9 res blocks): the
     InstanceNorm forward and backward, with and without ReLU, at each of
     the seven distinct norm shapes, float32 and bfloat16; timed at the
     most frequent shape (4, 256, 32, 32) and the largest (4, 64, 128, 128)
     against the plain version, F.instance_norm and the library's backward;
     each record carries the launch plan (CTAs, cluster size, shared
     memory) at every norm shape.
4. A small float32 step of each model on the card against the same step on
   the CPU (the plain kernel versions), from the same weights and inputs.
   WGAN (32x48, base 16, batch 4, n_critic 2): four steps, two of them with
   a gan update, once with the weight clip and once with the gradient
   penalty (gp_lambda 10: cuDNN's double backward); each card step starts
   from the CPU's state before it, since a free run of this trajectory
   amplifies rounding differences past its 1e-3 bound within four steps
   (PERF.md §6). The same four WGAN steps in bfloat16 (`--bf16`), with the
   clip and with the penalty, on the card alone: finite float32 losses,
   the cadence, float32 state and the clip (their numbers are held against
   the JAX bfloat16 step on the CPU, tests/test_torch_wgan_step.py).
5. Each training slice through its entry point, one after the other, the
   launch counters zeroed just before and read just after; every kernel
   of the path must have run exactly as often as the step's structure
   says, and no other (Adam: one launch per apply), and no Adam gradient
   copied to its parameter's layout more often than GRAD_COPIES_PER_STEP:
   - SNDCGANEngine: spectral-norm D, hinge loss, bf16, one epoch with a
     checkpoint, then a new engine that resumes from it for a second epoch;
     each epoch's params-only exports (gen_model-<e>, disc_model-<e>),
     loaded into fresh models, are bit-equal to the engine's state then;
   - CycleGANEngine at the headline configuration (float32): one epoch, then
     a new engine on the same directory auto-resumes for a second; both
     generators are exported every epoch, for phase 7;
   - WGANEngine at the reference's configuration (144x256, batch 32, base
     512, float32, n_critic 5, weight clip; bench.py:445-468): one epoch of
     8 steps, then a new engine resumes for a second; gan updates at steps
     5, 10 and 15, critic_count 1 at the end, critic conv weights within
     +-0.01, and no hand kernel launched (the WGAN path has none).
6. Sampling and FID on the SNDCGAN slice's directory, at its full width,
   with the launch counters zeroed before and read after (no hand kernel
   runs: inference uses neither dropout nor Adam):
   - the sampling CLI's two variants (exports, checkpoints) give the same
     epochs and bit-equal samples in [0, 1];
   - FIDEvaluator (spectral norm, lowrank cross term) over a 512-image
     144x256 synthetic dataset, 16 pinned batches of 32 and 4096 features:
     every FID finite and >= -1e-6 of its batch's trace terms, again equal
     from features taken anew; a resumed evaluate computes nothing, and an
     epoch dropped from fids.pickle comes back equal; on the first two
     pinned batches the `scipy` FID (float32 covariances, scipy's sqrtm)
     agrees with lowrank within its float32 rounding bound;
   - Newton–Schulz on the card against scipy.linalg.sqrtm (n = 512, SPD);
   - an image folder written here with cv2 (JPEG and PNG) read through
     ImageFolderDataset, its decoder named, then through the FID CLI's
     evaluate_fid at batch 2.
   It prints seconds per sampled epoch, per FID epoch (export load,
   features and FID math), for pinning, and the phase's peak memory, beside
   the card.
7. The evaluation path, with the launch counters zeroed before each run and
   read after it:
   - first the InstanceNorm forward kernel against its plain version at the
     seven CycleGAN norm shapes at batch 128 (the PD batch), float32, with
     and without ReLU, timed at (128, 64, 128, 128) with the L2 flushed
     against the plain version and F.instance_norm (not counted);
   - the perception-distance CLI (`cyclegan_evaluation.main`, -s 128) on
     phase 5's CycleGAN run dir, trained there with an export every epoch,
     once for models/generator_g and once for models/generator_f, over 128
     PNG images (128x128) written here with cv2: 2 epochs of 128 finite
     PDs each; exactly 24 InstanceNorm forward launches (6 + 2 x 9 norms)
     per translated batch and no other kernel; PD(x, x) exactly 0 under
     deterministic cuDNN; two pairs again on the CPU within 1e-4 relative;
   - FIDEvaluator(feature_source="inception") over the SNDCGAN run dir of
     phase 6 (16 pinned batches of 32 at 144x256, lowrank): FIDs finite and
     >= 0, the same after a resumed evaluation and after an epoch is dropped
     from fids.pickle; two images' Inception features on the card against
     the CPU within 1e-4 of the largest; no hand kernel launched.
   It prints seconds per PD epoch and per Inception-FID epoch (export load,
   features and math; host clock, each span ending in a device sync or a
   copy to the host) and the phase's peak memory, and adds the evaluation path's
   launches to every kernel's `launches_by_path`.

Output: progress lines, then a JSON line with one record per kernel, the
card's `name, power.limit` line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import os
import pickle
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.cli import (
    cyclegan_evaluation,
    generator_evaluation,
    generator_output,
)
from imagegeneration_tpu_torch.core import platform
from imagegeneration_tpu_torch.core.checkpoint import load_params
from imagegeneration_tpu_torch.core.data import ImageFolderDataset, SyntheticImageDataset
from imagegeneration_tpu_torch.evalx.fid import (
    MAX_BATCHES,
    FIDEvaluator,
    calculate_fid_from_features,
)
from imagegeneration_tpu_torch.core.rng import KeyChain
from imagegeneration_tpu_torch.evalx import inception
from imagegeneration_tpu_torch.evalx import pd as pdlib
from imagegeneration_tpu_torch.models.cyclegan import CycleGANConfig
from imagegeneration_tpu_torch.models.cyclegan import Generator as CycleGANGenerator
from imagegeneration_tpu_torch.models.sndcgan import (
    DISC_TRUNK,
    Discriminator,
    Generator,
    SNDCGANConfig,
    trunk_hw,
)
from imagegeneration_tpu_torch.models.wgan import CLIP_VALUE, WGANConfig, critic_kernels
from imagegeneration_tpu_torch.ops import adam, dropout, native
from imagegeneration_tpu_torch.ops import instance_norm as inorm
from imagegeneration_tpu_torch.ops.sqrtm import sqrtm_newton_schulz
from imagegeneration_tpu_torch.tools import in_plans as in_plans_tool
from imagegeneration_tpu_torch.tools.devtime import L2Flush, device_ms
from imagegeneration_tpu_torch.train import cyclegan_step
from imagegeneration_tpu_torch.train import sndcgan_step as steplib
from imagegeneration_tpu_torch.train import wgan_step
from imagegeneration_tpu_torch.train.cyclegan_engine import LOSS_KEYS as CG_LOSS_KEYS
from imagegeneration_tpu_torch.train.cyclegan_engine import CycleGANEngine
from imagegeneration_tpu_torch.train.sndcgan_engine import SNDCGANEngine
from imagegeneration_tpu_torch.train.wgan_engine import WGANEngine

HEIGHT, WIDTH, BATCH, BASE = 144, 256, 32, 512
EPOCH_BATCHES = 8
BF16_ULP = 2.0**-7  # one bfloat16 ulp is at most |v| * 2^-7
# The headline CycleGAN configuration (bench.py:489-503).
CG_SIZE, CG_BATCH, CG_BASE, CG_RES = 128, 4, 64, 9
# Distinct InstanceNorm shapes (B, C, H, W) of its step: G stem/up1,
# down0/up0, down1 + 18 res-block norms, to_rgb; D conv1-3.
IN_SHAPES = [(4, 64, 128, 128), (4, 128, 64, 64), (4, 256, 32, 32), (4, 3, 128, 128),
             (4, 128, 30, 30), (4, 256, 14, 14), (4, 512, 6, 6)]
IN_FREQUENT, IN_LARGEST = IN_SHAPES[2], IN_SHAPES[0]
EPS = 1e-3  # tfa InstanceNormalization's epsilon, the models' value
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_PER_S = 67e12  # H100 SXM float32, outside the tensor cores
KERNELS = ("leaky_relu_dropout", "adam", "instance_norm")
# Adam gradients copied to their parameter's layout per step (PERF.md §6):
# none, conv weights, their moments and cuDNN's gradients are channels_last.
GRAD_COPIES_PER_STEP = {"sndcgan": 0, "cyclegan": 0}
# The reference WGAN configuration (bench.py:445-468): the SNDCGAN image
# size, batch and base width, float32, n_critic 5, weight clipping.
WGAN_N_CRITIC = 5
# Every launch counter of the hand kernels: zeroed and read as one set, so
# that no path can launch a kernel that goes uncounted.
LAUNCH_COUNTERS = (dropout.LAUNCHES, adam.LAUNCHES, inorm.LAUNCHES)
# FID phase: MAX_BATCHES pinned batches of the headline batch size.
FID_IMAGES = MAX_BATCHES * BATCH
FID_FLOOR = 1e-6  # an FID may fall below 0 by this share of its trace terms
EPS32 = 2.0**-24  # float32 unit roundoff
NS_TOL = 1e-4  # Newton–Schulz vs scipy.linalg.sqrtm: max abs err / max |sqrtm|
# Evaluation phase: the PD CLI's default sample size, the CycleGAN norm
# shapes at that batch, and the relative bound of card against CPU.
PD_IMAGES = 128
IN_EVAL_SHAPES = [(PD_IMAGES, *s[1:]) for s in IN_SHAPES]
IN_EVAL_TIMED = IN_EVAL_SHAPES[0]
IN_PER_TRANSLATION = 6 + 2 * CG_RES  # InstanceNorm forwards per generator pass
EVAL_RTOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {what}")


def timing(kernel, plain, library=None, iters: int = 20,
           flush: L2Flush | None = None) -> dict:
    """Device ms of the kernel's wrapper, its plain version and, where there
    is one, the library call; with `flush`, timed with the L2 flushed
    between calls, and warm beside it (`warm_ms`, `plain_warm_ms`, ...)."""
    out = {"library_ms": None}
    for prefix, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        if fn is not None:
            out[f"{prefix}ms"] = device_ms(fn, iters, flush=flush)
            if flush is not None:
                out[f"{prefix}warm_ms"] = device_ms(fn, iters)
    return out


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def zero_launches() -> None:
    for counts in (*LAUNCH_COUNTERS, adam.GRAD_COPIES):
        for k in counts:
            counts[k] = 0


def read_launches() -> dict[str, int]:
    torch.cuda.synchronize()
    return {k: v for counts in LAUNCH_COUNTERS for k, v in counts.items()}


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
        times = timing(kernel, plain)
        n_tensors = 2 if name == names[0] else 3  # x, y / x, g, dx
        out.append({
            "name": name, "route": "cuda",
            "source": "imagegeneration_tpu_torch/csrc/leaky_relu_dropout.cu",
            "replaces": f"imagegeneration_tpu/ops/pallas/dropout.py:{line}",
            "max_abs_err": max_err[name], "tolerance": "1 bf16 ulp, mask exact",
            "checked_shapes_nchw": [list(s) for s in shapes],
            **times, "timed_shape_nhwc": [b, h, w, c], "dtype": "bfloat16",
            # ~20 integer and float operations per element (hash, select, scale)
            **bound(n_tensors * x.numel() * x.element_size(), 20 * x.numel()),
            "library_note": "no PyTorch call computes this hash-masked dropout",
        })
        log(f"{name} at {shapes[0]}: kernel {times['ms']:.4f} ms, plain "
            f"{times['plain_ms']:.4f} ms device time ({card})")
    return out


def adam_leaves(path: str, dev: torch.device) -> tuple[list[list[torch.Tensor]], float]:
    """The leaves of each model of one headline slice's state (one Adam
    apply each: SNDCGAN G, D; CycleGAN G, F, D_X, D_Y), and its b1."""
    if path == "sndcgan":
        state = steplib.init_state(steplib.SNDCGANTrainConfig(model=SNDCGANConfig(
            image_size=(HEIGHT, WIDTH, 3), base_width=BASE, spectral_norm=True,
            dtype=torch.bfloat16)), dev)
        return [[p.detach() for p in m.parameters()] for m in (state.gen, state.disc)], 0.9
    cfg = cyclegan_step.CycleGANTrainConfig(model=CycleGANConfig(
        image_size=(CG_SIZE, CG_SIZE, 3), base_width=CG_BASE, n_res_blocks=CG_RES))
    state = cyclegan_step.init_state(cfg, dev)
    models = (state.gen_g, state.gen_f, state.disc_x, state.disc_y)
    return [[p.detach() for p in m.parameters()] for m in models], cfg.beta1


def adam_host_us(models: list[list[torch.Tensor]], b1: float, dev: torch.device,
                 rounds: int = 20) -> dict:
    """Host microseconds per apply of `adam.adam_apply` (perf_counter
    around the calls, no sync: what the step's host thread spends), over
    each model's leaves with its own table, as the step applies them."""
    gen = torch.Generator(device=dev).manual_seed(2)
    per_model = []
    for leaves in models:
        params = [p.clone() for p in leaves]
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        grads = [torch.empty_like(p).normal_(generator=gen) for p in params]
        count = torch.zeros((), dtype=torch.int64, device=dev)
        table = adam.LeafTable(params, m, v)
        per_model.append((params, grads, m, v, count, table))
    us = []
    for params, grads, m, v, count, table in per_model:
        for _ in range(3):
            adam.adam_apply(params, grads, m, v, count, 2e-4, b1, 0.999, table)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            adam.adam_apply(params, grads, m, v, count, 2e-4, b1, 0.999, table)
        us.append((time.perf_counter() - t0) * 1e6 / rounds)
        torch.cuda.synchronize()
    return {"host_us_per_apply_by_model": us, "host_us_per_apply": sum(us) / len(us)}


def check_adam_path(path: str, dev: torch.device, card: str) -> dict:
    """One multi-tensor launch over every leaf of one slice, with its b1,
    against the plain version leaf by leaf (0 ulp); then that apply timed,
    and the host time per apply of the slice's own applies."""
    models, b1 = adam_leaves(path, dev)
    leaves = [p for ps in models for p in ps]
    gen = torch.Generator(device=dev).manual_seed(1)
    # In each leaf's own layout (channels_last conv weights), as the step
    # hands them to the kernel.
    grads = [torch.empty_like(p).normal_(generator=gen) for p in leaves]
    ms_ = [torch.empty_like(p).normal_(generator=gen) for p in leaves]
    vs_ = [torch.empty_like(p).uniform_(generator=gen) for p in leaves]
    alpha = adam.adam_alpha(torch.tensor(3, device=dev), 2e-4, b1, 0.999)
    pk, mk, vk = ([t.clone() for t in ts] for ts in (leaves, ms_, vs_))
    pp, mp, vp = ([t.clone() for t in ts] for ts in (leaves, ms_, vs_))
    table = adam.LeafTable(pk, mk, vk)
    adam.adam_kernel(table, grads, alpha, b1, 0.999)
    adam.adam_plain(pp, grads, mp, vp, alpha, b1, 0.999)
    worst = 0
    max_err = 0.0
    for a, b in zip(pk + mk + vk, pp + mp + vp):
        worst = max(worst, max_ulp_f32(a, b))
        max_err = max(max_err, (a - b).abs().max().item())
    require(worst == 0, f"adam kernel {worst} ulp from plain on {path} leaves (bound 0)")

    times = timing(lambda: adam.adam_kernel(table, grads, alpha, b1, 0.999),
                   lambda: adam.adam_plain(pk, grads, mk, vk, alpha, b1, 0.999), iters=10)
    host = adam_host_us(models, b1, dev)
    n = sum(p.numel() for p in leaves)
    log(f"adam on {path} ({len(leaves)} leaves, {n:,} elements, b1={b1}): one launch "
        f"({len(table.launches)} group, {adam.grid_ctas()} CTAs, chunk {adam.CHUNK}) "
        f"{times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms device time, max {worst} "
        f"ulp; host {host['host_us_per_apply']:.1f} us per apply of the step's "
        f"{len(models)} models ({card})")
    # read p, g, m, v and write p, m, v; ~12 float32 operations each
    return {"b1": b1, "leaves": len(leaves), "elements": n, "max_abs_err": max_err,
            "max_ulp": worst, "launches_per_apply_all_leaves": len(table.launches),
            "grid_ctas": adam.grid_ctas(), "chunk": adam.CHUNK, **times, **host,
            **bound(28 * n, 12 * n)}


def check_adam(dev: torch.device, card: str) -> dict:
    """Kernel vs plain on the leaves of both slices. The record's times and
    bound are one apply over the CycleGAN leaves, the path whose launches it
    reports; `by_path` holds each slice's own."""
    by_path = {p: check_adam_path(p, dev, card) for p in ("sndcgan", "cyclegan")}
    main = by_path["cyclegan"]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "leaves", "elements",
            "host_us_per_apply")
    return {
        "name": "adam", "route": "cuda", "source": "imagegeneration_tpu_torch/csrc/adam.cu",
        "replaces": "imagegeneration_tpu/ops/pallas/adam.py:69",
        "max_abs_err": max(r["max_abs_err"] for r in by_path.values()),
        "max_ulp": max(r["max_ulp"] for r in by_path.values()), "tolerance": "0 ulp",
        **{k: main[k] for k in keys}, "by_path": by_path,
        "ms_is_per": "one launch over every CycleGAN G and D leaf (b1 0.5)",
        "library_note": "torch.optim.Adam adds eps to sqrt(v_hat) after bias-"
                        "correcting m and v; Keras adds it to sqrt(v) and folds the "
                        "correction into the step size, a different update",
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


def in_inputs(dev: torch.device, shape, dtype) -> tuple[torch.Tensor, ...]:
    """x ~ N(2, 3), dy ~ N(0, 1) (channels_last), gamma ~ N(1, 0.1), beta ~
    N(0, 0.1), as the JAX package's kernel tests draw them."""
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    x = (2.0 + 3.0 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
    dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(shape[1], generator=gen, device=dev)
    beta = 0.1 * torch.randn(shape[1], generator=gen, device=dev)
    cl = torch.channels_last
    return x.contiguous(memory_format=cl), dy.contiguous(memory_format=cl), gamma, beta


def in_close(what: str, got: torch.Tensor, want: torch.Tensor, tol: float,
             terms: int = 128) -> float:
    """Require |got - want| <= tol * sqrt(terms / 128) + (tol + ulp) |want|:
    rtol/atol `tol` (tests/test_pallas_ops.py), the atol of a sum of `terms`
    float32 values scaled by sqrt(terms / 128) from those tests' 128, and one
    bf16 ulp (2^-7 |v|) for a bf16 output. Returns the max abs error."""
    ulp = BF16_ULP if got.dtype == torch.bfloat16 else 0.0
    got, want = got.float(), want.float()
    err = (got - want).abs()
    limit = tol * max(1.0, (terms / 128) ** 0.5) + (tol + ulp) * want.abs()
    require(bool((err <= limit).all()),
            f"{what}: beyond tolerance by {(err - limit).max().item():.3g}")
    return err.max().item()


def in_plans(shape, dtype=torch.float32) -> dict:
    """The forward's and the backward's launch plans at one shape, each with
    how many of its clusters the card holds at once."""
    b, c, h, w = shape
    out = {}
    for part, tensors in (("fwd", 1), ("bwd", 2)):
        plan = inorm.launch_plan(b, c, h, w, dtype, tensors)
        out[part] = {**vars(plan), "active_clusters": inorm.active_clusters(
            plan, c, h * w, dtype, backward=tensors == 2)}
    return out


def time_instance_norm(shape, flush: L2Flush) -> dict:
    """Kernel, plain and library device times (float32) at one shape, with
    the L2 flushed between calls and warm."""
    dev = torch.device("cuda", 0)
    x, dy, gamma, beta = in_inputs(dev, shape, torch.float32)
    b, c, h, w = shape
    n = x.numel()
    _, mean, rstd = inorm.in_fwd_plain(x, gamma, beta, EPS, False)
    library_bwd = in_plans_tool.library_bwd(x, dy, gamma, mean, rstd)
    dx_lib = library_bwd()[0].view(b, c, h, w)
    dx_plain = inorm.in_bwd_plain(x, dy, gamma, beta, mean, rstd, False)[0]
    require(torch.allclose(dx_lib, dx_plain, rtol=1e-4, atol=1e-4),
            f"native_batch_norm_backward is not the same function at {shape}")
    xg, gg, bg = (t.detach().clone().requires_grad_(True) for t in (x, gamma, beta))

    def fwd_bwd(norm):
        return lambda: torch.autograd.grad(norm(xg, gg, bg), (xg, gg, bg), dy)

    return {
        "fwd": {
            **timing(lambda: inorm.in_fwd_kernel(x, gamma, beta, EPS, False),
                     lambda: inorm.in_fwd_plain(x, gamma, beta, EPS, False),
                     in_plans_tool.library_fwd(x, gamma, beta), flush=flush),
            # read x, gamma, beta, write y, mean, rstd; ~10 operations per
            # element (3 passes)
            **bound(4 * (2 * n + 2 * b * c + 2 * c), 10 * n),
        },
        "bwd": {
            **timing(lambda: inorm.in_bwd_kernel(x, dy, gamma, beta, mean, rstd, False),
                     lambda: inorm.in_bwd_plain(x, dy, gamma, beta, mean, rstd, False),
                     library_bwd, flush=flush),
            # read x, dy, mean, rstd, gamma, beta; write dx, dgamma, dbeta;
            # ~14 operations per element
            **bound(4 * (3 * n + 2 * b * c + 4 * c), 14 * n),
        },
        "fwd_bwd_ms": device_ms(fwd_bwd(lambda x, g, b: inorm.instance_norm(x, g, b, EPS))),
        "library_fwd_bwd_ms": device_ms(
            fwd_bwd(lambda x, g, b: F.instance_norm(x, weight=g, bias=b, eps=EPS))),
    }


def check_instance_norm(card: str) -> list[dict]:
    """Kernel vs plain at every distinct norm shape of the headline CycleGAN
    step, float32 and bfloat16, with and without the fused ReLU. The
    backward takes the plain forward's mean and rstd, so both rebuild the
    same ReLU mask. Timed in float32 at the most frequent and the largest
    shape."""
    dev = torch.device("cuda", 0)
    names = ("instance_norm_fwd", "instance_norm_bwd")
    max_err = {(k, dt): 0.0 for k in names for dt in ("float32", "bfloat16")}
    for shape in IN_SHAPES:
        terms = shape[0] * shape[2] * shape[3]
        for dtype in (torch.float32, torch.bfloat16):
            x, dy, gamma, beta = in_inputs(dev, shape, dtype)
            dt = str(dtype).split(".")[1]
            for relu in (False, True):
                at = f"{shape} {dt} relu={relu}"
                y, mean, rstd = inorm.in_fwd_kernel(x, gamma, beta, EPS, relu)
                yp, meanp, rstdp = inorm.in_fwd_plain(x, gamma, beta, EPS, relu)
                errs = [in_close(f"fwd y {at}", y, yp, 2e-5),
                        in_close(f"fwd mean {at}", mean, meanp, 1e-5),
                        in_close(f"fwd rstd {at}", rstd, rstdp, 1e-5)]
                max_err[names[0], dt] = max(max_err[names[0], dt], *errs)
                if relu:
                    require(torch.equal(y == 0, yp == 0), f"fwd zero pattern {at}")
                dx, dg, db = inorm.in_bwd_kernel(x, dy, gamma, beta, meanp, rstdp, relu)
                dxp, dgp, dbp = inorm.in_bwd_plain(x, dy, gamma, beta, meanp, rstdp, relu)
                errs = [in_close(f"bwd dx {at}", dx, dxp, 2e-5),
                        in_close(f"bwd dgamma {at}", dg, dgp, 2e-5, terms),
                        in_close(f"bwd dbeta {at}", db, dbp, 2e-5, terms)]
                max_err[names[1], dt] = max(max_err[names[1], dt], *errs)
        log(f"instance norm kernels at {shape}: within tolerance, f32/bf16, relu off/on, "
            "ReLU zero pattern identical")
    torch.cuda.synchronize()

    flush = L2Flush(dev)
    timed = {"most_frequent": time_instance_norm(IN_FREQUENT, flush),
             "largest": time_instance_norm(IN_LARGEST, flush)}
    del flush  # 512 MiB the training slices can use
    plans = {str(tuple(s)): in_plans(s) for s in IN_SHAPES}
    out = []
    for name, part, line in ((names[0], "fwd", 66), (names[1], "bwd", 137)):
        rec = {
            "name": name, "route": "cuda",
            "source": "imagegeneration_tpu_torch/csrc/instance_norm.cu",
            "replaces": f"imagegeneration_tpu/ops/pallas/instance_norm.py:{line}",
            "max_abs_err": max_err[name, "float32"],
            "max_abs_err_bf16": max_err[name, "bfloat16"],
            "tolerance": "rtol/atol 2e-5 (mean, rstd 1e-5; dgamma/dbeta atol x "
                         "sqrt(B*H*W/128)); bf16 + 1 ulp",
            "checked_shapes_nchw": [list(s) for s in IN_SHAPES],
            **timed["most_frequent"][part],
            "timed_shape_nchw": list(IN_FREQUENT), "dtype": "float32",
            "library_call": "F.instance_norm" if part == "fwd"
                            else "aten.native_batch_norm_backward on the (1, B*C, H, W) view",
            "at_largest": {"shape_nchw": list(IN_LARGEST), **timed["largest"][part]},
            "plans_f32": {s: p[part] for s, p in plans.items()},
        }
        if part == "bwd":
            rec["fwd_bwd_ms"] = {k: timed[k]["fwd_bwd_ms"] for k in timed}
            rec["library_fwd_bwd_ms"] = {k: timed[k]["library_fwd_bwd_ms"] for k in timed}
        out.append(rec)
        for where, t in timed.items():
            shape = IN_FREQUENT if where == "most_frequent" else IN_LARGEST
            r, plan = t[part], plans[str(shape)][part]
            log(f"{name} at {where} {shape}"
                f" f32 device time, L2 flushed (warm): kernel {r['ms']:.4f} "
                f"({r['warm_ms']:.4f}) ms, plain {r['plain_ms']:.4f} ({r['plain_warm_ms']:.4f})"
                f" ms, library {r['library_ms']:.4f} ({r['library_warm_ms']:.4f}) ms, bound "
                f"{r['bound_ms']:.4f} ms; plan {plan['ctas']} CTAs, cluster "
                f"{plan['cluster']}, {plan['smem_bytes']} B shared ({card})")
    for where, t in timed.items():
        log(f"instance norm fwd+bwd through autograd at {where}, device time: kernels "
            f"{t['fwd_bwd_ms']:.4f} ms, F.instance_norm {t['library_fwd_bwd_ms']:.4f} ms "
            f"({card})")
    return out


def check_small_cyclegan_step_against_cpu(dev: torch.device) -> None:
    """Two float32 CycleGAN steps (96x96, base 8, 2 res blocks, batch 1) on
    the card and on the CPU, from the same weights and batches."""
    cfg = cyclegan_step.CycleGANTrainConfig(
        model=CycleGANConfig(image_size=(96, 96, 3), base_width=8, n_res_blocks=2))
    gen = torch.Generator().manual_seed(5)
    batches = torch.randint(0, 256, (2, 2, 1, 96, 96, 3), generator=gen, dtype=torch.uint8)
    probe = batches[0, 0].float() / 127.5 - 1.0
    translate_g, _ = cyclegan_step.make_translators()
    results = []
    for d in (torch.device("cpu"), dev):
        state = cyclegan_step.init_state(cfg, d)
        step = cyclegan_step.make_train_step(cfg)
        ms = []
        for bx, by in batches:
            state, m = step(state, bx.to(d), by.to(d))
            ms.append({k: float(v) for k, v in m.items()})
        results.append((ms, translate_g(state, probe.to(d)).cpu()))
    (m_cpu, img_cpu), (m_gpu, img_gpu) = results
    for i, (a, b) in enumerate(zip(m_gpu, m_cpu)):
        for k in b:
            require(math.isfinite(a[k]) and abs(a[k] - b[k]) <= 1e-3 * max(1.0, abs(b[k])),
                    f"small cyclegan step {i} {k}: cuda {a[k]} vs cpu {b[k]}")
    err = (img_gpu - img_cpu).abs().max().item()
    require(err <= 1e-3, f"small cyclegan step translations differ by {err}")
    log(f"small float32 CycleGAN step, card vs CPU: 9 metrics within 1e-3, "
        f"translation max abs err {err:.3g}")


def check_small_wgan_steps_against_cpu(dev: torch.device) -> None:
    """Four float32 WGAN steps (32x48, base 16, batch 4, n_critic 2) on the
    CPU; each step again on the card from the CPU's state before it, with
    the same batch and latents (and interpolation weights with the
    gradient penalty). Metrics within 1e-3, and the samples of the last
    step's generator."""
    gen = torch.Generator().manual_seed(6)
    batches = torch.randint(0, 256, (4, 4, 32, 48, 3), generator=gen, dtype=torch.uint8)
    z_fake = torch.randn((4, 4, 128), generator=gen)
    z_gan = torch.randn((4, 4, 128), generator=gen)
    gp_eps = torch.rand((4, 4, 1, 1, 1), generator=gen)
    cpu = torch.device("cpu")
    for gp_lambda in (0.0, 10.0):
        cfg = wgan_step.WGANTrainConfig(
            model=WGANConfig(image_size=(32, 48, 3), base_width=16), batch_size=4,
            n_critic=2, gp_lambda=gp_lambda)
        step = wgan_step.make_train_step(cfg)
        sample = wgan_step.make_sampler(cfg)
        cpu_state = wgan_step.init_state(cfg, cpu)
        card_state = wgan_step.init_state(cfg, dev)
        did, worst, at = [], 0.0, "all equal"
        for i in range(4):
            # load_state_dict copies every tensor before the CPU step moves it
            card_state.load_state_dict(
                {**cpu_state.state_dict(), "z_gen": card_state.z_gen.get_state()})
            results = []
            for state, d in ((cpu_state, cpu), (card_state, dev)):
                eps = gp_eps[i].to(d) if gp_lambda else None
                _, m = step(state, batches[i].to(d), z_fake[i].to(d), z_gan[i].to(d), eps)
                results.append({k: float(v) for k, v in m.items()})
            m_cpu, m_gpu = results
            for k, b in m_cpu.items():
                a = m_gpu[k]
                require(math.isfinite(a) and abs(a - b) <= 1e-3 * max(1.0, abs(b)),
                        f"small wgan step {i} (gp {gp_lambda}) {k}: cuda {a} vs cpu {b}")
                if abs(a - b) / max(1.0, abs(b)) > worst:
                    worst, at = abs(a - b) / max(1.0, abs(b)), f"{k} at step {i}"
            require(card_state.critic_count == cpu_state.critic_count, "critic_count")
            did.append(m_gpu["did_gan_update"])
        require(did == [0.0, 1.0, 0.0, 1.0], f"small wgan gan updates {did}")
        if not gp_lambda:
            k = max(w.abs().max().item() for w in critic_kernels(card_state.critic))
            require(k <= CLIP_VALUE, f"critic conv weights reach {k}")
        err = (sample(card_state, z_fake[0].to(dev)).cpu()
               - sample(cpu_state, z_fake[0])).abs().max().item()
        require(err <= 1e-3, f"small wgan step samples differ by {err}")
        log(f"small float32 WGAN steps (gp_lambda {gp_lambda}), card vs CPU from the same "
            f"state each step: metrics within {worst:.3g} ({at}; bound 1e-3), gan updates {did}, "
            f"samples max abs err {err:.3g}")


def check_small_wgan_bf16_steps(dev: torch.device) -> None:
    """Four bfloat16 WGAN steps (32x48, base 16, batch 4, n_critic 2) on the
    card, with the clip and with the gradient penalty: finite float32
    losses, gan updates at the second and fourth step, float32 parameters,
    statistics and optimizer state, conv weights within the clip."""
    gen = torch.Generator().manual_seed(7)
    batches = torch.randint(0, 256, (4, 4, 32, 48, 3), generator=gen, dtype=torch.uint8)
    for gp_lambda in (0.0, 10.0):
        cfg = wgan_step.WGANTrainConfig(
            model=WGANConfig(image_size=(32, 48, 3), base_width=16, dtype=torch.bfloat16),
            batch_size=4, n_critic=2, gp_lambda=gp_lambda)
        step = wgan_step.make_train_step(cfg)
        state = wgan_step.init_state(cfg, dev)
        did, losses = [], []
        for i in range(4):
            state, m = step(state, batches[i].to(dev))
            require(all(v.dtype == torch.float32 for v in m.values()), "bf16 wgan metric dtype")
            m = {k: float(v) for k, v in m.items()}
            require(all(math.isfinite(v) for v in m.values()), f"bf16 wgan step {i}: {m}")
            did.append(m["did_gan_update"])
            losses.append(m["c_loss_real"])
        require(did == [0.0, 1.0, 0.0, 1.0], f"bf16 wgan gan updates {did}")
        tensors = [*state.gen.parameters(), *state.critic.parameters(), *state.gen.buffers(),
                   *state.critic.buffers(), *state.c_opt.nu, *state.gan_opt.nu]
        require({t.dtype for t in tensors} == {torch.float32}, "bf16 wgan state dtype")
        if not gp_lambda:
            k = max(w.abs().max().item() for w in critic_kernels(state.critic))
            require(k <= CLIP_VALUE, f"bf16 critic conv weights reach {k}")
        log(f"small bfloat16 WGAN steps (gp_lambda {gp_lambda}) on the card: finite, gan "
            f"updates {did}, float32 state, c_loss_real {[round(v, 4) for v in losses]}")


def model_states(state) -> dict[str, dict[str, torch.Tensor]]:
    """CPU copies of the generator's and discriminator's tensors."""
    return {name: {k: v.detach().cpu().clone()
                   for k, v in getattr(state, name).state_dict().items()}
            for name in ("gen", "disc")}


def check_exports(out: str, cfg: SNDCGANConfig, states: dict) -> int:
    """Each epoch's exports, loaded into fresh models, bit-equal to the
    engine's state at that epoch; returns the tensors compared."""
    n = 0
    for epoch, want in states.items():
        for name, cls, path in (
                ("gen", Generator, f"{out}/models/generator/gen_model-{epoch}.msgpack"),
                ("disc", Discriminator,
                 f"{out}/models/discriminator/disc_model-{epoch}.msgpack")):
            fresh = cls(cfg)
            bridge.load_flax_variables(fresh, load_params(path))
            got = fresh.state_dict()
            require(sorted(got) == sorted(want[name]), f"{path}: tensors {sorted(got)}")
            for k, v in got.items():
                require(torch.equal(v, want[name][k]), f"{path}: {k} differs from the state")
            n += len(got)
    return n


def run_sndcgan_slice(card: str, work: str) -> dict:
    """The headline SNDCGAN configuration through SNDCGANEngine in
    `work`/sndcgan, which the sampling and FID phase reads afterwards."""
    dev = torch.device("cuda", 0)
    dataset = SyntheticImageDataset(EPOCH_BATCHES * BATCH, (HEIGHT, WIDTH))
    kwargs = dict(image_size=(HEIGHT, WIDTH, 3), device=dev, spectral_norm=True,
                  loss="hinge", dtype=torch.bfloat16, base_width=BASE,
                  live_output=f"{work}/live")
    out = f"{work}/sndcgan"
    engine = SNDCGANEngine(out, dataset, BATCH, **kwargs)
    zero_launches()
    engine.train(1, 1)  # epoch 0, checkpointed and exported
    states = {0: model_states(engine.state)}
    first = engine.last_epoch_metrics
    resumed = SNDCGANEngine(out, dataset, BATCH, continue_=True, **kwargs)
    require(resumed.start_epoch == 1, "resume did not start at epoch 1")
    require(int(resumed.state.step) == EPOCH_BATCHES, "resumed step counter")
    resumed.train(2, 1)  # epoch 1
    launches = read_launches()
    states[1] = model_states(resumed.state)
    copies = adam.GRAD_COPIES["adam"]
    second = resumed.last_epoch_metrics
    with open(f"{out}/perf.jsonl") as f:
        perf = [json.loads(line) for line in f]
    steps = int(resumed.state.step)
    n_exported = check_exports(out, engine.cfg.model, states)
    require(steps == 2 * EPOCH_BATCHES, f"step counter {steps}")
    for name, m in (("epoch 0", first), ("epoch 1", second)):
        require(all(math.isfinite(v) for v in m.values()), f"{name} losses {m}")
    want = {
        "leaky_relu_dropout_fwd": steplib.N_SITES * steps,
        "leaky_relu_dropout_bwd": steplib.N_SITES * steps,
        "adam": 3 * steps,  # G, then D twice (d_updates=2): one launch each
        "instance_norm_fwd": 0, "instance_norm_bwd": 0,
    }
    require(launches == want, f"launch counts {launches}, expected {want}")
    want_copies = GRAD_COPIES_PER_STEP["sndcgan"] * steps
    require(copies == want_copies, f"adam gradient copies {copies}, expected {want_copies}")
    log(f"sndcgan slice: {steps} steps over 2 epochs (one resumed), losses {second}")
    log(f"sndcgan slice: launches {launches}, adam gradient layout copies {copies}")
    log(f"sndcgan slice: exports gen_model-{{0,1}} and disc_model-{{0,1}} loaded into "
        f"fresh models: {n_exported} tensors bit-equal to the engine's state at each epoch")
    log(f"sndcgan slice: epoch 1 {perf[-1]['steps_per_sec']:.3f} steps/s, "
        f"{perf[-1]['images_per_sec']:.1f} images/s at {WIDTH}x{HEIGHT} bs{BATCH} "
        f"base {BASE} SN hinge bf16 ({card})")
    return {"launches": launches, "grad_copies": copies, "perf": perf,
            "config": f"{HEIGHT}x{WIDTH} bs{BATCH} base{BASE} SN hinge bf16 d_updates=2"}


def run_cyclegan_slice(card: str, work: str) -> dict:
    """The headline CycleGAN configuration through CycleGANEngine in
    `work`/cyclegan: one epoch, then a new engine that auto-resumes on the
    same directory; both generators exported every epoch, for the
    evaluation phase."""
    dev = torch.device("cuda", 0)
    datasets = [SyntheticImageDataset(EPOCH_BATCHES * CG_BATCH, (CG_SIZE, CG_SIZE), seed=s)
                for s in (1, 2)]
    kwargs = dict(device=dev, base_width=CG_BASE, n_res_blocks=CG_RES, dtype=torch.float32)
    size = (CG_SIZE, CG_SIZE)
    out = f"{work}/cyclegan"
    engine = CycleGANEngine(*datasets, out, CG_BATCH, size, **kwargs)
    require(engine.epoch == 0 and engine.resident, "fresh resident engine")
    zero_launches()
    engine.train(1, checkpoint_frequency=1)  # epoch 0, checkpoint 1
    first = engine.last_epoch_metrics
    resumed = CycleGANEngine(*datasets, out, CG_BATCH, size, **kwargs)
    require(resumed.epoch == 1, f"auto-resume gave epoch {resumed.epoch}")
    require(int(resumed.state.step) == EPOCH_BATCHES, "resumed step counter")
    resumed.train(1, checkpoint_frequency=1)  # epoch 1, checkpoint 2
    launches = read_launches()
    copies = adam.GRAD_COPIES["adam"]
    second = resumed.last_epoch_metrics
    with open(f"{out}/perf.jsonl") as f:
        perf = [json.loads(line) for line in f]
    with open(f"{out}/losses.pickle", "rb") as f:
        history = pickle.load(f)
    checkpoints = resumed.ckpt_manager.all_epochs()
    probe = torch.from_numpy(datasets[0].images[:1]).to(dev).float() / 127.5 - 1.0
    image = resumed.translate_g(resumed.state, probe)
    steps = int(resumed.state.step)
    require(steps == 2 * EPOCH_BATCHES, f"step counter {steps}")
    for name, m in (("epoch 0", first), ("epoch 1", second)):
        require(all(math.isfinite(v) for v in m.values()), f"{name} losses {m}")
    require(sorted(history) == sorted(CG_LOSS_KEYS)
            and all(len(v) == 2 for v in history.values()), f"losses.pickle {history}")
    require(checkpoints == [1, 2], f"checkpoints {checkpoints}")
    require(image.shape == (1, CG_SIZE, CG_SIZE, 3) and bool(torch.isfinite(image).all())
            and image.abs().max().item() <= 1.0, "translated image")
    # Per step: 6 generator passes of 6 + 2 * n_res norms, 4 discriminator
    # passes of 3; backward: pulls 1 and 2 each run one D pass and four G
    # passes, pull 3 the four D passes (PERF.md gives the derivation); one
    # Adam launch for each of G, F, D_X and D_Y.
    in_g, in_d = 6 + 2 * CG_RES, 3
    per_step = {"instance_norm_fwd": 6 * in_g + 4 * in_d,
                "instance_norm_bwd": 2 * (in_d + 4 * in_g) + 4 * in_d,
                "adam": 4}
    require(per_step == {"instance_norm_fwd": 156, "instance_norm_bwd": 210, "adam": 4},
            f"per-step structure {per_step}")
    want = {"leaky_relu_dropout_fwd": 0, "leaky_relu_dropout_bwd": 0,
            **{k: v * steps for k, v in per_step.items()}}
    require(launches == want, f"launch counts {launches}, expected {want}")
    want_copies = GRAD_COPIES_PER_STEP["cyclegan"] * steps
    require(copies == want_copies, f"adam gradient copies {copies}, expected {want_copies}")
    log(f"cyclegan slice: {steps} steps over 2 epochs (one auto-resumed), losses {second}")
    log(f"cyclegan slice: launches {launches}, adam gradient layout copies {copies}")
    log(f"cyclegan slice: epoch 1 {perf[-1]['steps_per_sec']:.3f} steps/s, "
        f"{perf[-1]['images_per_sec']:.2f} images/s at {CG_SIZE}x{CG_SIZE} bs{CG_BATCH} "
        f"base {CG_BASE} {CG_RES} res blocks f32 ({card})")
    return {"launches": launches, "grad_copies": copies, "perf": perf,
            "config": f"{CG_SIZE}x{CG_SIZE} bs{CG_BATCH} base{CG_BASE} res{CG_RES} f32"}


def run_wgan_slice(card: str) -> dict:
    """The reference WGAN configuration through WGANEngine: one epoch, then a
    new engine that resumes from its checkpoint for a second."""
    dev = torch.device("cuda", 0)
    dataset = SyntheticImageDataset(EPOCH_BATCHES * BATCH, (HEIGHT, WIDTH), seed=3)
    args = (dataset, (HEIGHT, WIDTH, 3), BATCH, WGAN_N_CRITIC)
    kwargs = dict(device=dev, base_width=BASE, dtype=torch.float32)
    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/wgan"
        engine = WGANEngine(*args, path_like=out, **kwargs)
        require(engine.epoch == 0 and engine.resident, "fresh resident engine")
        zero_launches()
        engine.train(1)  # epoch 1, checkpoint 1
        first = engine.last_epoch_metrics
        resumed = WGANEngine(*args, path_like=out, load=True, **kwargs)
        require(resumed.epoch == 1, f"resume gave epoch {resumed.epoch}")
        require(int(resumed.state.step) == EPOCH_BATCHES, "resumed step counter")
        require(resumed.state.critic_count == EPOCH_BATCHES % WGAN_N_CRITIC,
                f"resumed critic_count {resumed.state.critic_count}")
        resumed.train(2)  # epoch 2, checkpoint 2
        launches = read_launches()
        copies = adam.GRAD_COPIES["adam"]
        second = resumed.last_epoch_metrics
        with open(f"{out}/perf.jsonl") as f:
            perf = [json.loads(line) for line in f]
        with open(f"{out}/stats.pickle", "rb") as f:
            history = pickle.load(f)
        checkpoints = resumed.ckpt_manager.all_epochs()
        samples = resumed.generate_fake_samples(4)
        steps = int(resumed.state.step)
        critic_count = resumed.state.critic_count
        kernel_max = max(w.abs().max().item() for w in critic_kernels(resumed.state.critic))
    require(steps == 2 * EPOCH_BATCHES, f"step counter {steps}")
    gan_steps = first["gan_update_steps"] + second["gan_update_steps"]
    require(first["gan_updates"] + second["gan_updates"] == 3 and gan_steps == [5, 10, 15],
            f"gan updates at steps {gan_steps}, expected [5, 10, 15]")
    require(critic_count == 1, f"critic_count {critic_count} after 16 steps")
    for name, m in (("epoch 1", first), ("epoch 2", second)):
        require(all(math.isfinite(v) for v in m.values() if isinstance(v, float)),
                f"{name} losses {m}")
    require(kernel_max <= CLIP_VALUE, f"critic conv weights reach {kernel_max}")
    require(checkpoints == [1, 2], f"checkpoints {checkpoints}")
    require(sorted(history) == ["c1_hist", "c2_hist", "g_hist"]
            and all(len(v) == 3 and all(map(math.isfinite, v)) for v in history.values()),
            f"stats.pickle {history}")
    require(samples.shape == (4, HEIGHT, WIDTH, 3) and samples.min() >= 0.0
            and samples.max() <= 1.0, "preview samples")
    want = dict.fromkeys(launches, 0)
    require(launches == want, f"launch counts {launches}, expected none")
    require(copies == 0, f"adam gradient copies {copies} on a path without Adam")
    log(f"wgan slice: {steps} steps over 2 epochs (one resumed), gan updates at steps "
        f"{gan_steps}, critic_count {critic_count}, critic conv weights within "
        f"{kernel_max:.4g}, losses {second}")
    log(f"wgan slice: launches {launches}")
    log(f"wgan slice: epoch 2 {perf[-1]['steps_per_sec']:.3f} steps/s, "
        f"{perf[-1]['images_per_sec']:.1f} images/s at {WIDTH}x{HEIGHT} bs{BATCH} base "
        f"{BASE} f32 n_critic {WGAN_N_CRITIC} clip ({card})")
    return {"launches": launches, "grad_copies": copies, "perf": perf,
            "config": f"{HEIGHT}x{WIDTH} bs{BATCH} base{BASE} f32 n_critic{WGAN_N_CRITIC} clip"}


def trace_terms(feats: np.ndarray) -> float:
    """tr(cov) of a feature matrix, in float64."""
    f = feats.astype(np.float64)
    return float(np.sum((f - f.mean(axis=0)) ** 2) / max(f.shape[0] - 1, 1))


def scipy_rounding_bound(feats_fake: np.ndarray, feats_real: np.ndarray) -> float:
    """How far the `scipy` FID (the reference formula: float32 covariances,
    scipy's d x d sqrtm of their product) may sit from the exact lowrank one.
    The product has rank n - 1; each of its d - n + 1 null directions can
    take a float32 rounding eigenvalue of up to EPS32 |C_f| |C_r|, which
    sqrtm lifts to its square root, and the FID counts the trace twice."""
    def top_eigenvalue(f):
        x = f.astype(np.float64)
        x = (x - x.mean(axis=0)) / np.sqrt(x.shape[0] - 1)
        return float(np.linalg.svd(x, compute_uv=False)[0] ** 2)

    n, d = feats_fake.shape
    return 2.0 * (d - n + 1) * math.sqrt(
        EPS32 * top_eigenvalue(feats_fake) * top_eigenvalue(feats_real))


def check_sampling(run: str, dev: torch.device, card: str) -> dict:
    """Both variants of the sampling CLI over the slice's two epochs."""
    args = (3, run, 1, "grid", 0, (HEIGHT, WIDTH, 3), 128, 62)
    kw = dict(device=dev, return_samples=True)
    out = {}
    for name, fn in (("models", generator_output.output_results_models),
                     ("checkpoints", generator_output.output_results_ckpts)):
        t0 = time.perf_counter()
        epochs, samples = fn(*args, **kw)
        out[name] = (epochs, samples, (time.perf_counter() - t0) / len(epochs))
    (epochs_m, from_models, s_m), (epochs_c, from_ckpts, s_c) = out.values()
    require(epochs_m == epochs_c == [0, 1], f"sampled epochs {epochs_m} / {epochs_c}")
    for e, a, b in zip(epochs_m, from_models, from_ckpts):
        require(a.shape == (3, HEIGHT, WIDTH, 3) and bool(np.isfinite(a).all())
                and a.min() >= 0.0 and a.max() <= 1.0, f"samples of epoch {e}")
        require(np.array_equal(a, b), f"epoch {e}: samples from the export and the "
                f"checkpoint differ by {np.abs(a - b).max()}")
    require(not np.array_equal(from_models[0], from_models[1]), "epochs 0 and 1 sample alike")
    log(f"sampling: epochs {epochs_m} from exports and from checkpoints, 3 samples each, "
        f"bit-equal, in [{min(a.min() for a in from_models):.4f}, "
        f"{max(a.max() for a in from_models):.4f}]; {s_m:.3f} s per epoch from exports, "
        f"{s_c:.3f} s from checkpoints (model load included) ({card})")
    return {"epochs": epochs_m, "seconds_per_epoch_exports": s_m,
            "seconds_per_epoch_checkpoints": s_c}


def check_fid(run: str, work: str, dev: torch.device, card: str) -> dict:
    """FIDEvaluator over 16 pinned batches of 32 at 144x256; resume; the
    FIDs again from features taken anew; scipy against lowrank."""
    ds = SyntheticImageDataset(FID_IMAGES, (HEIGHT, WIDTH), seed=4)
    ev = FIDEvaluator(run, f"{work}/fid", (HEIGHT, WIDTH, 3), spectral_norm=True,
                      device=dev)
    t0 = time.perf_counter()
    results = ev.evaluate(dataset=ds, batch_size=BATCH, start_epoch=0)
    total = time.perf_counter() - t0
    pin_s, epoch_s = ev.pin_seconds, dict(ev.epoch_seconds)
    init = ev.load_init()
    require(init["batches_used"] == MAX_BATCHES and init["disc_epoch"] == 1
            and all(x.shape == (BATCH, HEIGHT, WIDTH, 3) for x in init["img_real_used"]),
            f"pinned {init['batches_used']} batches, disc epoch {init['disc_epoch']}")
    require(sorted(results) == [0, 1] and all(len(v) == MAX_BATCHES for v in results.values()),
            f"fids {results}")

    real = [ev.features(x) for x in init["img_real_used"]]
    th, tw = trunk_hw((HEIGHT, WIDTH))
    n_feats = DISC_TRUNK[-1][0] * (th // 8) * (tw // 8)  # 4096 at 144x256
    require(real[0].shape == (BATCH, n_feats), f"feature shape {real[0].shape}")
    worst_floor, worst_again, fake = 0.0, 0.0, {}
    for e in results:
        ev.load_gen(e)
        fake[e] = [ev.fake_features(torch.from_numpy(z).to(dev)).cpu().numpy()
                   for z in init["random_z_used"]]
        for b, (ff, rf) in enumerate(zip(fake[e], real)):
            fid, scale = results[e][b], trace_terms(ff) + trace_terms(rf)
            require(math.isfinite(fid) and fid >= -FID_FLOOR * scale,
                    f"epoch {e} batch {b}: FID {fid} (trace terms {scale})")
            worst_floor = min(worst_floor, fid / scale)
            again = calculate_fid_from_features(ff, rf)
            worst_again = max(worst_again, abs(again - fid) / scale)
            require(abs(again - fid) <= FID_FLOOR * scale,
                    f"epoch {e} batch {b}: FID {fid}, from features taken anew {again}")

    results_file = f"{work}/fid/fids.pickle"
    require(ev.evaluate(continue_=True) == results and ev.epoch_seconds == {},
            "a resumed evaluation computed again")
    with open(results_file, "rb") as f:
        kept = pickle.load(f)
    del kept[0]
    with open(results_file, "wb") as f:
        pickle.dump(kept, f)
    resumed = ev.evaluate(continue_=True)
    require(sorted(ev.epoch_seconds) == [0], f"resume recomputed {sorted(ev.epoch_seconds)}")
    diff = max(abs(a - b) for a, b in zip(resumed[0], results[0]))
    require(diff <= FID_FLOOR * max(trace_terms(rf) for rf in real),
            f"epoch 0 again differs by {diff}")
    log(f"fid: {MAX_BATCHES} pinned batches of {BATCH} at {WIDTH}x{HEIGHT}, {n_feats} features, "
        f"epochs {sorted(results)}, disc epoch 1: means "
        f"{[round(float(np.mean(results[e])), 4) for e in sorted(results)]}, "
        f"min FID / trace terms {worst_floor:.3g} (floor {-FID_FLOOR}), features anew within "
        f"{worst_again:.3g} of the trace terms; resume computed nothing, a dropped epoch "
        f"came back {'bit-equal' if diff == 0 else f'within {diff:.3g}'}")
    log(f"fid timing: pinning {pin_s:.3f} s; per epoch export load "
        + ", ".join(f"{t['load']:.3f}" for t in epoch_s.values())
        + " s, features (synthesis included) "
        + ", ".join(f"{t['features']:.3f}" for t in epoch_s.values())
        + " s, FID math " + ", ".join(f"{t['fid']:.3f}" for t in epoch_s.values())
        + f" s; evaluate() {total:.3f} s in all ({card})")

    # scipy's d x d sqrtm on the first two pinned batches of the last epoch
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        sp = list(pool.map(
            lambda b: calculate_fid_from_features(fake[1][b], real[b], "scipy"), range(2)))
    scipy_s = time.perf_counter() - t0
    gaps = []
    for b in range(2):
        gap, tol = abs(sp[b] - results[1][b]), scipy_rounding_bound(fake[1][b], real[b])
        scale = trace_terms(fake[1][b]) + trace_terms(real[b])
        gaps.append({"gap": gap, "bound": tol, "trace_terms": scale})
        require(gap <= tol, f"batch {b}: scipy {sp[b]} vs lowrank {results[1][b]}: "
                f"{gap} beyond the float32 rounding bound {tol}")
    log(f"fid: scipy vs lowrank on pinned batches 0-1 of epoch 1: {sp} vs {results[1][:2]}; "
        + "; ".join(f"gap {g['gap']:.4g} (bound {g['bound']:.4g}, "
                    f"{g['gap'] / g['trace_terms']:.3g} of the trace terms)" for g in gaps)
        + f"; {scipy_s:.1f} s on the host")
    return {"batches": MAX_BATCHES, "batch": BATCH, "features": n_feats,
            "fid_means": {e: float(np.mean(v)) for e, v in results.items()},
            "pin_seconds": pin_s, "epoch_seconds": epoch_s, "evaluate_seconds": total,
            "scipy_vs_lowrank": gaps, "scipy_seconds": scipy_s}


def check_newton_schulz(dev: torch.device) -> float:
    from scipy.linalg import sqrtm

    r = np.random.default_rng(8).standard_normal((512, 512))
    a = r @ r.T / 512 + np.eye(512)  # SPD, eigenvalues in [1, 5]
    want = sqrtm(a).real
    got = sqrtm_newton_schulz(torch.from_numpy(a.astype(np.float32)).to(dev)).double().cpu()
    err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    require(err <= NS_TOL, f"Newton–Schulz vs scipy sqrtm: {err}")
    log(f"Newton–Schulz on the card (n 512, SPD, float32, TF32 off) vs scipy.linalg.sqrtm: "
        f"max abs err {err:.3g} of the largest entry (bound {NS_TOL})")
    return err


def check_image_folder(run: str, work: str, dev: torch.device, card: str) -> dict:
    """A folder of JPEG and PNG files written here with cv2, read through
    ImageFolderDataset, then through the FID CLI's evaluate_fid."""
    import cv2

    folder = f"{work}/images"
    os.makedirs(f"{folder}/landscape")
    rng = np.random.default_rng(11)
    smooth = cv2.resize(rng.integers(0, 256, (3, 4, 3), dtype=np.uint8), (WIDTH, HEIGHT),
                        interpolation=cv2.INTER_LINEAR)  # JPEG keeps smooth images close
    exact = {}
    for i, (h, w) in enumerate(((HEIGHT, WIDTH), (200, 300), (300, 200))):
        img = smooth if i == 0 else rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for ext in ("png", "jpg"):
            require(cv2.imwrite(f"{folder}/landscape/i{i}.{ext}",
                                np.ascontiguousarray(img[..., ::-1])),
                    f"cv2.imwrite i{i}.{ext}")
        exact[i] = img
    t0 = time.perf_counter()
    ds = ImageFolderDataset(folder, (HEIGHT, WIDTH))
    read_s = time.perf_counter() - t0
    require(ds.decoders == {"cv2": 6}, f"decoders {ds.decoders}")
    names = [p.name for p in ds.files]
    png, jpg = ds.images[names.index("i0.png")], ds.images[names.index("i0.jpg")]
    require(np.array_equal(png, exact[0]), "the PNG at the target size did not decode exactly")
    jpg_err = float(np.abs(jpg.astype(np.int32) - exact[0]).mean())
    require(jpg_err <= 4.0, f"the JPEG decodes {jpg_err} grey levels off on average")
    log(f"image folder: 3 PNG + 3 JPEG written with cv2 {cv2.__version__}, read through "
        f"ImageFolderDataset into {ds.images.shape} uint8 in {read_s:.3f} s, decoders "
        f"{ds.decoders}; PNG exact, JPEG mean abs err {jpg_err:.3f} ({card})")
    results = generator_evaluation.evaluate_fid(
        run, folder, 2, f"{work}/xfid", 1, 0, 1, False, (HEIGHT, WIDTH, 3),
        spectral_norm=True, device=dev)
    require(sorted(results) == [0, 1] and all(
        len(v) == 3 and all(map(math.isfinite, v)) for v in results.values()),
        f"evaluate_fid over the folder: {results}")
    log(f"image folder through generator_evaluation.evaluate_fid at batch 2: 3 pinned "
        f"batches, FIDs {results}")
    return {"decoders": ds.decoders, "cv2": cv2.__version__, "jpeg_mean_abs_err": jpg_err,
            "read_seconds": read_s}


def run_sampling_and_fid(card: str, work: str, dev: torch.device) -> dict:
    """Phase 6 on the SNDCGAN slice's directory: no hand kernel may run."""
    run = f"{work}/sndcgan"
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"sampling": check_sampling(run, dev, card), "fid": check_fid(run, work, dev, card),
           "newton_schulz_err": check_newton_schulz(dev),
           "image_folder": check_image_folder(run, work, dev, card)}
    launches = read_launches()
    out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    require(set(launches.values()) == {0}, f"hand kernels launched in sampling/FID: {launches}")
    log(f"sampling and FID: launches {launches}; peak allocated "
        f"{out['peak_allocated_bytes'] / 2**30:.2f} GiB ({card})")
    out["launches"] = launches
    return out


def check_instance_norm_eval_batch(card: str) -> dict:
    """The InstanceNorm forward kernel against its plain version at the
    CycleGAN norm shapes at the PD batch (128), float32, ReLU off and on
    (the tolerance of check_instance_norm); timed at the largest with the
    L2 flushed against the plain version and F.instance_norm."""
    dev = torch.device("cuda", 0)
    max_err, flips, flip_max = 0.0, 0, 0.0
    for shape in IN_EVAL_SHAPES:
        x, _, gamma, beta = in_inputs(dev, shape, torch.float32)
        for relu in (False, True):
            at = f"{shape} f32 relu={relu}"
            y, mean, rstd = inorm.in_fwd_kernel(x, gamma, beta, EPS, relu)
            yp, meanp, rstdp = inorm.in_fwd_plain(x, gamma, beta, EPS, relu)
            max_err = max(max_err, in_close(f"fwd y {at}", y, yp, 2e-5),
                          in_close(f"fwd mean {at}", mean, meanp, 1e-5),
                          in_close(f"fwd rstd {at}", rstd, rstdp, 1e-5))
            if relu:
                # Over 2**27 elements a few pre-ReLU values round to either
                # side of 0: the pattern may differ only within the atol.
                differ = (y == 0) != (yp == 0)
                flips += int(differ.sum())
                flip_max = max(flip_max, float(torch.where(differ, y + yp, 0).max()))
                require(flip_max <= 2e-5, f"fwd zero pattern {at}: a flip at {flip_max}")
            del y, yp
        del x
    torch.cuda.synchronize()
    log(f"instance norm forward kernel at the {len(IN_EVAL_SHAPES)} norm shapes at batch "
        f"{PD_IMAGES}: within tolerance, f32, relu off/on, max abs err {max_err:.3g}; ReLU "
        f"zero pattern: {flips} elements differ, each within {flip_max:.3g} of 0")
    x, _, gamma, beta = in_inputs(dev, IN_EVAL_TIMED, torch.float32)
    n = x.numel()
    flush = L2Flush(dev)
    times = timing(lambda: inorm.in_fwd_kernel(x, gamma, beta, EPS, False),
                   lambda: inorm.in_fwd_plain(x, gamma, beta, EPS, False),
                   in_plans_tool.library_fwd(x, gamma, beta), flush=flush)
    del flush, x
    b, c, h, w = IN_EVAL_TIMED
    rec = {"shape_nchw": list(IN_EVAL_TIMED), "dtype": "float32", **times,
           "checked_shapes_nchw": [list(s) for s in IN_EVAL_SHAPES], "max_abs_err": max_err,
           "relu_zero_pattern_flips": flips, "relu_flip_max_value": flip_max,
           # read x, gamma, beta, write y, mean, rstd; ~10 operations per element
           **bound(4 * (2 * n + 2 * b * c + 2 * c), 10 * n),
           "plans_f32": {str(s): in_plans(s)["fwd"] for s in IN_EVAL_SHAPES}}
    plan = rec["plans_f32"][str(IN_EVAL_TIMED)]
    log(f"instance_norm_fwd at {IN_EVAL_TIMED} f32 device time, L2 flushed (warm): kernel "
        f"{times['ms']:.4f} ({times['warm_ms']:.4f}) ms, plain {times['plain_ms']:.4f} "
        f"({times['plain_warm_ms']:.4f}) ms, F.instance_norm {times['library_ms']:.4f} "
        f"({times['library_warm_ms']:.4f}) ms, bound {rec['bound_ms']:.4f} ms; plan "
        f"{plan['ctas']} CTAs, cluster {plan['cluster']}, held {plan['held']} "
        f"({plan['smem_bytes']} B shared) ({card})")
    return rec


def write_pd_samples(folder: str) -> None:
    """PD_IMAGES synthetic 128x128 uint8 images as PNG files, with cv2."""
    import cv2

    os.makedirs(folder)
    images = SyntheticImageDataset(PD_IMAGES, (CG_SIZE, CG_SIZE), seed=12).images
    for i, img in enumerate(images):
        require(cv2.imwrite(f"{folder}/s{i:03d}.png", np.ascontiguousarray(img[..., ::-1])),
                f"cv2.imwrite s{i:03d}.png")


def pd_on_cpu(export: str, samples: str, n: int) -> np.ndarray:
    """The PDs of the first `n` pairs of the CLI's batch, on the CPU, with
    the CLI's models (the random-init VGG16)."""
    cpu = torch.device("cpu")
    ds = ImageFolderDataset(samples, (CG_SIZE, CG_SIZE), labeled=False)
    x = torch.from_numpy(ds.images[ds.permutation(0)[:n]]).float() / 127.5 - 1.0
    gen = CycleGANGenerator(CycleGANConfig(), torch.Generator()).eval()
    bridge.load_flax_variables(gen, load_params(export))
    with torch.no_grad():
        out = gen(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return pdlib.make_pd_fn(pdlib.load_vgg16_params(device=cpu))(x, out).numpy()


def check_pd_cli(work: str, dev: torch.device, card: str) -> dict:
    """The PD CLI on each generator directory of the CycleGAN run: 2
    epochs of PD_IMAGES PDs, exact launch counts; PD(x, x) = 0; two pairs
    again on the CPU."""
    samples = f"{work}/pd_samples"
    write_pd_samples(samples)
    out = {"launches": dict.fromkeys(read_launches(), 0), "by_generator": {}}
    for name in ("g", "f"):
        gens = f"{work}/cyclegan/models/generator_{name}"
        zero_launches()
        t0 = time.perf_counter()
        epochs, pds, seconds = cyclegan_evaluation.main(
            [gens, samples, "-s", str(PD_IMAGES), "-o", f"{work}/pd_{name}"])
        total = time.perf_counter() - t0
        launches = read_launches()
        for k, v in launches.items():
            out["launches"][k] += v
        require(epochs == [0, 1], f"generator_{name}: epochs {epochs}")
        for e, p in zip(epochs, pds):
            require(len(p) == PD_IMAGES and all(math.isfinite(v) and v > 0 for v in p),
                    f"generator_{name} epoch {e}: {len(p)} PDs, finite and > 0: "
                    f"{all(map(math.isfinite, p))}")
        want = dict.fromkeys(launches, 0)
        want["instance_norm_fwd"] = IN_PER_TRANSLATION * len(epochs)
        require(launches == want, f"generator_{name}: launches {launches}, expected {want}")
        cpu = pd_on_cpu(f"{gens}/gen_weights_{name}-1.msgpack", samples, 2)
        gap = float(np.max(np.abs(cpu - np.asarray(pds[1][:2])) / np.abs(cpu)))
        require(gap <= EVAL_RTOL, f"generator_{name} epoch 1: card PDs {pds[1][:2]} vs CPU "
                f"{cpu.tolist()} ({gap:.3g} relative, bound {EVAL_RTOL})")
        out["by_generator"][name] = {
            "epochs": epochs, "pd_means": [float(np.mean(p)) for p in pds],
            "epoch_seconds": seconds, "main_seconds": total, "card_vs_cpu_rel": gap}
        log(f"pd cli on generator_{name}: epochs {epochs}, {PD_IMAGES} PDs each, means "
            f"{[round(float(np.mean(p)), 6) for p in pds]}; launches {launches}; pairs 0-1 "
            f"of epoch 1 on the CPU within {gap:.3g} relative (bound {EVAL_RTOL})")
        log(f"pd timing, generator_{name}: per epoch export load "
            + ", ".join(f"{t['load']:.4f}" for t in seconds)
            + f" s, features (translation, 2 x {PD_IMAGES} VGG16 at 224) "
            + ", ".join(f"{t['features']:.3f}" for t in seconds)
            + " s, math " + ", ".join(f"{t['math']:.4f}" for t in seconds)
            + f" s; main() {total:.3f} s in all ({card})")

    ds = ImageFolderDataset(samples, (CG_SIZE, CG_SIZE), labeled=False)
    x = torch.from_numpy(ds.images[ds.permutation(0)]).to(dev).float() / 127.5 - 1.0
    same = pdlib.make_pd_fn(pdlib.load_vgg16_params(device=dev))(x, x)
    require(bool((same == 0).all()), f"PD(x, x) up to {same.abs().max().item()}")
    log(f"pd: PD(x, x) exactly 0 over the {PD_IMAGES} images on the card (deterministic cuDNN)")
    return out


def check_inception_fid(run: str, work: str, dev: torch.device, card: str) -> dict:
    """FIDEvaluator with the Inception features over the SNDCGAN run, 16
    pinned batches of 32 at 144x256; resume; card against CPU features."""
    ds = SyntheticImageDataset(FID_IMAGES, (HEIGHT, WIDTH), seed=4)
    out_dir = f"{work}/inception_fid"
    zero_launches()
    ev = FIDEvaluator(run, out_dir, (HEIGHT, WIDTH, 3), spectral_norm=True,
                      feature_source="inception", device=dev)
    t0 = time.perf_counter()
    results = ev.evaluate(dataset=ds, batch_size=BATCH, start_epoch=0)
    total = time.perf_counter() - t0
    pin_s, epoch_s = ev.pin_seconds, dict(ev.epoch_seconds)
    require(sorted(results) == [0, 1] and all(len(v) == MAX_BATCHES for v in results.values()),
            f"inception fids {results}")
    for e, fids in results.items():
        require(all(math.isfinite(v) and v >= 0 for v in fids), f"epoch {e}: FIDs {fids}")
    require(ev.evaluate(continue_=True) == results and ev.epoch_seconds == {},
            "a resumed inception evaluation computed again")
    results_file = f"{out_dir}/fids.pickle"
    with open(results_file, "rb") as f:
        kept = pickle.load(f)
    del kept[0]
    with open(results_file, "wb") as f:
        pickle.dump(kept, f)
    again = ev.evaluate(continue_=True)
    launches = read_launches()
    require(sorted(ev.epoch_seconds) == [0], f"resume recomputed {sorted(ev.epoch_seconds)}")
    diff = max(abs(a - b) for a, b in zip(again[0], results[0]))
    require(diff <= 1e-6 * max(map(abs, results[0])),
            f"epoch 0 again: {again[0]} vs {results[0]}")
    require(set(launches.values()) == {0}, f"hand kernels launched in the inception FID: "
            f"{launches}")

    images = ev.load_init()["img_real_used"][0][:2]
    card_feats = ev.features(images)
    cpu_model = inception.load_inception_params(device="cpu")
    cpu_feats = inception.make_feature_fn(cpu_model)(torch.from_numpy(images)).numpy()
    err = float(np.abs(card_feats - cpu_feats).max() / np.abs(cpu_feats).max())
    require(card_feats.shape == (2, 2048) and err <= EVAL_RTOL,
            f"inception features card vs CPU: {err:.3g} of the largest (bound {EVAL_RTOL})")
    log(f"inception fid: {MAX_BATCHES} pinned batches of {BATCH} at {WIDTH}x{HEIGHT}, 2048 "
        f"features, epochs {sorted(results)}: means "
        f"{[round(float(np.mean(results[e])), 4) for e in sorted(results)]}, min "
        f"{min(min(v) for v in results.values()):.4g}; resume computed nothing, a dropped "
        f"epoch came back {'bit-equal' if diff == 0 else f'within {diff:.3g}'}; launches {launches}; 2 images' features on the CPU "
        f"within {err:.3g} of the largest (bound {EVAL_RTOL})")
    log(f"inception fid timing: pinning {pin_s:.3f} s; per epoch export load "
        + ", ".join(f"{t['load']:.3f}" for t in epoch_s.values())
        + " s, features (synthesis and Inception at 299) "
        + ", ".join(f"{t['features']:.3f}" for t in epoch_s.values())
        + " s, FID math " + ", ".join(f"{t['fid']:.3f}" for t in epoch_s.values())
        + f" s; evaluate() {total:.3f} s in all ({card})")
    return {"launches": launches, "fid_means": {e: float(np.mean(v)) for e, v in results.items()},
            "pin_seconds": pin_s, "epoch_seconds": epoch_s, "evaluate_seconds": total,
            "card_vs_cpu_features_err": err}


def run_evaluation(card: str, work: str, dev: torch.device, kernels: list[dict]) -> dict:
    """Phase 7: the InstanceNorm forward at batch 128, then the PD CLI and
    the Inception FID; their launches summed as the evaluation path's."""
    at_batch = check_instance_norm_eval_batch(card)
    next(k for k in kernels if k["name"] == "instance_norm_fwd")["at_pd_batch"] = at_batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pd_rec = check_pd_cli(work, dev, card)
    fid_rec = check_inception_fid(f"{work}/sndcgan", work, dev, card)
    seconds = time.perf_counter() - t0
    launches = {k: pd_rec["launches"][k] + fid_rec["launches"][k] for k in pd_rec["launches"]}
    peak = torch.cuda.max_memory_allocated()
    log(f"evaluation: launches {launches}; peak allocated {peak / 2**30:.2f} GiB; "
        f"{seconds:.1f} s ({card})")
    return {"pd": pd_rec, "inception_fid": fid_rec, "launches": launches,
            "peak_allocated_bytes": peak, "seconds": seconds,
            "instance_norm_fwd_at_pd_batch": {k: at_batch[k] for k in (
                "ms", "warm_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}


def main() -> int:
    dev = platform.require_cuda()
    numerics = platform.configure_numerics()
    card = platform.card_description()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {numerics}")
    log(f"card: {card}")

    t0 = time.perf_counter()
    native.build_all(list(KERNELS))
    for name in KERNELS:
        native.load(name)
        info = native.BUILD_LOG[name]
        regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
        log(f"built {name}.cu in {info['seconds']:.2f} s: {regs}")
    log(f"kernel build total {time.perf_counter() - t0:.2f} s (parallel)")

    kernels = check_dropout(dev, card)
    kernels.append(check_adam(dev, card))
    kernels += check_instance_norm(card)
    check_small_step_against_cpu(dev)
    check_small_cyclegan_step_against_cpu(dev)
    check_small_wgan_steps_against_cpu(dev)
    check_small_wgan_bf16_steps(dev)
    with tempfile.TemporaryDirectory() as work:
        slices = {"sndcgan": run_sndcgan_slice(card, work),
                  "cyclegan": run_cyclegan_slice(card, work), "wgan": run_wgan_slice(card)}
        offline = run_sampling_and_fid(card, work, dev)
        evaluation = run_evaluation(card, work, dev, kernels)
    names = {k["name"] for k in kernels}
    for p, r in slices.items():
        require(set(r["launches"]) == names, f"{p}: counters {sorted(r['launches'])} "
                f"are not the kernels {sorted(names)}")
    require(set(evaluation["launches"]) == names,
            f"evaluation: counters {sorted(evaluation['launches'])}")
    for k in kernels:
        k["launches_by_path"] = {p: r["launches"][k["name"]] for p, r in slices.items()}
        k["launches_by_path"]["evaluation"] = evaluation["launches"][k["name"]]
        # The path that runs it; Adam runs on both, and its record's times
        # are the CycleGAN apply's, as are its launches.
        k["launches"] = k["launches_by_path"][
            "sndcgan" if k["name"].startswith("leaky") else "cyclegan"]
        for p, r in k.get("by_path", {}).items():
            r["launches"] = k["launches_by_path"][p]
    print(json.dumps({"kernels": kernels, "slices": {
        p: {"steps_per_sec": r["perf"][-1]["steps_per_sec"],
            "images_per_sec": r["perf"][-1]["images_per_sec"], "config": r["config"],
            "adam_grad_copies": r["grad_copies"]}
        for p, r in slices.items()}, "sampling_and_fid": offline, "evaluation": evaluation,
        "card": card,
        "seconds": time.perf_counter() - t0}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
