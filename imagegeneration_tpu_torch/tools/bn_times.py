#!/usr/bin/env python3
"""Device time of the BatchNorm + activation kernels (ops/batch_norm.py) at
the SNDCGAN generator's four sites, on one CUDA card.

    python -m imagegeneration_tpu_torch.tools.bn_times [--out FILE] [--sweep]

The sites (`SITES`) are the headline generator's at batch 128 (256x144,
base 512, bf16, ReLU): the stem's (128, 294,912) input and the three maps
after the transposed convs, channels_last. At each site every kernel is
timed alone with tools/devtime.py, with the L2 flushed before every call
(`ms`) and back to back (`warm_ms`), beside:

- its bound: the bytes it has to move (the statistics pass reads x; the
  apply reads x and writes y; the reduce reads x and dy; the apply back
  reads x and dy and writes dx) at 3.35 TB/s; and, per direction, the
  work's bound (forward: read x, write y; backward: read x and dy, write
  dx), which a two-pass design reaches at 62% at most;
- the plain version (`bn_plain`: its forward, and autograd's backward
  through its graph), which repeats the arithmetic and is no yardstick of
  speed;
- the library calls for the same function (the port never calls them):
  forward `torch.batch_norm_stats` (Welford statistics) +
  `torch.batch_norm_elemt` + `relu_`; backward `threshold_backward` +
  `torch.batch_norm_backward_reduce` + `torch.batch_norm_backward_elemt`.

Each site's kernels are first held to the plain version on the same
inputs (`differences`: each output's largest difference over its bound).
`--sweep` also times the four kernels at other launch plans (lanes and
chunks: `plan_variant`).

Prints one line per site and kernel, the card's name and power limit, and
as the last line the results as one JSON object (also written to --out).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import sys
from pathlib import Path

import torch

from imagegeneration_tpu_torch.core import platform
from imagegeneration_tpu_torch.ops import batch_norm as bn
from imagegeneration_tpu_torch.ops import native
from imagegeneration_tpu_torch.tools.devtime import L2Flush, device_ms

# (name, shape) of the SNDCGAN headline generator's BatchNorm inputs.
SITES = [("stem", (128, 294912)), ("up0", (128, 256, 36, 64)), ("up1", (128, 128, 72, 128)),
         ("up2", (128, 64, 144, 256))]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
EPS, MOMENTUM, SLOPE = 1e-3, 0.99, 0.0
ITERS = 20
# Tensors of the matrix each kernel reads or writes once.
TENSORS = {"batch_norm_fwd_stats": 1, "batch_norm_fwd_apply": 2, "batch_norm_bwd_reduce": 2,
           "batch_norm_bwd_apply": 3}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(tensors: int, numel: int, element_size: int) -> float:
    return tensors * numel * element_size / HBM_BYTES_PER_S * 1e3


def inputs(shape, dtype, dev, seed: int) -> dict:
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = shape[1]

    def draw(*s):
        return torch.randn(s, generator=gen, device=dev)

    x, dy = (0.7 + 1.3 * draw(*shape)).to(dtype), draw(*shape).to(dtype)
    if len(shape) == 4:
        x = x.contiguous(memory_format=torch.channels_last)
        dy = dy.contiguous(memory_format=torch.channels_last)
    return {"x": x, "dy": dy, "scale": 1.0 + 0.25 * draw(c), "bias": 0.25 * draw(c),
            "mean": torch.zeros(c, device=dev), "var": torch.ones(c, device=dev)}


def plan_variant(rows: int, c: int, dtype: torch.dtype, lanes: int | None = None,
                 chunks: int | None = None) -> bn.LaunchPlan:
    """`bn.launch_plan`'s plan with other lanes or another chunk count (the
    sweep's and the tests' variants), its derived fields filled in as the
    kernels check them. Refused: lanes that are not a power of two up to
    THREADS or leave half a block idle, fewer than one chunk, more than
    MAX_BLOCKS channel blocks."""
    base = bn.launch_plan(rows, c, dtype)
    lanes = base.lanes if lanes is None else lanes
    chunks = base.chunks if chunks is None else chunks
    width = c // base.vec
    if lanes < 1 or lanes > bn.THREADS or lanes & (lanes - 1):
        raise ValueError(f"lanes must be a power of two in [1, {bn.THREADS}], got {lanes}")
    if lanes >= 2 * width and lanes > 1:
        raise ValueError(f"{lanes} lanes leave half a block idle at {width} vectors a row")
    if chunks < 1:
        raise ValueError(f"chunks must be >= 1, got {chunks}")
    slots, blocks = bn.THREADS // lanes, -(-width // lanes)
    if blocks > bn.MAX_BLOCKS:
        raise ValueError(f"{blocks} channel blocks exceed a grid's {bn.MAX_BLOCKS}")
    chunk_rows = -(-rows // (slots * chunks)) * slots
    return dataclasses.replace(base, lanes=lanes, slots=slots, cb=lanes * base.vec,
                               blocks=blocks, chunks=-(-rows // chunk_rows),
                               chunk_rows=chunk_rows)


def kernel_calls(t: dict, plan: bn.LaunchPlan, saved: tuple | None = None,
                 slope: float | None = SLOPE, train: bool = True) -> tuple[dict, dict]:
    """The kernels as calls on `t` (each on the outputs of the ones before
    it, computed once; in inference mode no statistics pass), and those
    outputs. The backward takes the forward's mean and rstd, or `saved`
    (the plain forward's: the same activation mask as the plain
    backward's)."""
    x, dy, scale, bias = t["x"], t["dy"], t["scale"], t["bias"]
    rm, rv = t["mean"].clone(), t["var"].clone()
    sums = bn.fwd_stats_kernel(x, plan) if train else None
    y, mean, rstd = bn.fwd_apply_kernel(x, sums, plan.rows, scale, bias, rm, rv, MOMENTUM,
                                        EPS, slope, plan)
    if saved is not None:
        mean, rstd = saved
    gsums = bn.bwd_reduce_kernel(x, dy, scale, bias, mean, rstd, slope, plan)
    total = gsums if train else None
    dx = bn.bwd_apply_kernel(x, dy, total, plan.rows, scale, bias, mean, rstd, slope, plan)
    calls = {
        "batch_norm_fwd_stats": lambda: bn.fwd_stats_kernel(x, plan),
        "batch_norm_fwd_apply": lambda: bn.fwd_apply_kernel(
            x, sums, plan.rows, scale, bias, rm, rv, MOMENTUM, EPS, slope, plan),
        "batch_norm_bwd_reduce": lambda: bn.bwd_reduce_kernel(
            x, dy, scale, bias, mean, rstd, slope, plan),
        "batch_norm_bwd_apply": lambda: bn.bwd_apply_kernel(
            x, dy, total, plan.rows, scale, bias, mean, rstd, slope, plan),
    }
    return calls, {"y": y, "dx": dx, "dscale": gsums[1], "dbias": gsums[0], "mean": rm,
                   "var": rv}


def plain(t: dict, slope: float | None = SLOPE, train: bool = True
          ) -> tuple[dict, object, object]:
    """The plain version's outputs (with the mean and rstd its forward
    normalised with, and the per-channel absolute sums of its dbias and
    dscale terms), and its forward and backward as calls."""
    x = t["x"].detach().clone().requires_grad_(True)
    scale = t["scale"].clone().requires_grad_(True)
    bias = t["bias"].clone().requires_grad_(True)
    rm, rv = t["mean"].clone(), t["var"].clone()

    def forward():
        return bn.bn_plain(x, scale, bias, rm, rv, not train, MOMENTUM, EPS, x.dtype, slope)

    if train:
        mean, mean2 = bn.moments_plain(t["x"].float())
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        cancel = (mean2 / (var + EPS)).clamp_min(1.0)
    else:
        mean, var = t["mean"], t["var"]
        cancel = torch.ones_like(mean)
    rstd = torch.rsqrt(var + EPS)
    y = forward()
    dx, dscale, dbias = torch.autograd.grad(y, (x, scale, bias), t["dy"], retain_graph=True)
    rows = t["x"].float().permute(0, 2, 3, 1) if t["x"].dim() == 4 else t["x"].float()
    g = t["dy"].float().permute(0, 2, 3, 1) if t["dy"].dim() == 4 else t["dy"].float()
    rows, g = rows.reshape(-1, rows.shape[-1]), g.reshape(-1, g.shape[-1])
    out = {"y": y.detach(), "dx": dx, "dscale": dscale, "dbias": dbias, "mean": rm, "var": rv,
           "saved": (mean, rstd), "abs_dbias": g.abs().sum(0),
           "abs_dscale": (g * (rows - mean) * rstd).abs().sum(0),
           "scale_y": y.detach().float().abs().max(),
           "scale_dx": (rstd * t["scale"]).abs().max() * g.abs().max(), "cancel": cancel}

    def backward():
        return torch.autograd.grad(y, (x, scale, bias), t["dy"], retain_graph=True)

    return out, forward, backward


def library(t: dict) -> tuple[object, object]:
    """The library calls of the same forward and backward (module note)."""
    x, dy, scale, bias = t["x"], t["dy"], t["scale"], t["bias"]
    mean, invstd = torch.batch_norm_stats(x, EPS)
    y = torch.relu_(torch.batch_norm_elemt(x, scale, bias, mean, invstd, EPS))
    count = torch.tensor([bn.matrix_shape(x)[0]], dtype=torch.int32, device=x.device)

    def forward():
        m, s = torch.batch_norm_stats(x, EPS)
        return torch.relu_(torch.batch_norm_elemt(x, scale, bias, m, s, EPS))

    def backward():
        g = torch.ops.aten.threshold_backward(dy, y, 0)
        sum_dy, sum_dy_xmu, dw, db = torch.batch_norm_backward_reduce(
            g, x, mean, invstd, scale, True, True, True)
        return torch.batch_norm_backward_elemt(g, x, mean, invstd, scale, sum_dy, sum_dy_xmu,
                                               count), dw, db

    return forward, backward


# The kernels against the plain version (`differences`). y and dx: one
# rounding of the output (ULP of |v| in the compute dtype) plus the float32
# rounding of statistics summed in another order and of the backward's
# formula against autograd's chain, at the scale of the terms (ABS_SHARE of
# the largest |y|; of the largest |rstd * scale| times the largest |dy|,
# the size of dx's terms). Where a channel's fast variance E[x^2] - E[x]^2
# cancels (few rows, or a mean far from 0), its rounding grows with the
# channel's cancellation factor E[x^2] / (var + eps), and so do its y and dx
# (through rstd, and autograd's chain through the variance): the scale term
# is then CANCEL_SHARE of that factor (16 float32 roundings of the sums,
# relative to the variance), where that is larger than ABS_SHARE. dbias and
# dscale: float32 sums of the same terms in another order, within SUM_SHARE
# of the absolute sum of the unmasked terms (|dy|, |dy xhat|) per channel,
# which bounds the masked terms'. The running statistics: within STAT_SHARE
# of their largest.
ULP = {torch.bfloat16: 2.0**-7, torch.float32: 2.0**-23}
ABS_SHARE, CANCEL_SHARE, SUM_SHARE, STAT_SHARE = 2.0**-14, 2.0**-20, 2.0**-16, 2.0**-16


def differences(got: dict, want: dict) -> dict:
    """Each output's largest difference from the plain version over its
    bound (module note: ok where every reading is <= 1)."""
    out = {}
    for k in ("y", "dx"):
        a, b = got[k].float(), want[k].float()
        share = torch.maximum(torch.full_like(want["cancel"], ABS_SHARE),
                              CANCEL_SHARE * want["cancel"])
        share = share.view([1, -1] + [1] * (b.dim() - 2))
        tol = ULP[got[k].dtype] * b.abs() + share * want[f"scale_{k}"]
        out[k] = float(((a - b).abs() / tol.clamp_min(1e-30)).max())
    for k in ("dbias", "dscale"):
        a, b = got[k].float(), want[k].float()
        out[k] = float(((a - b).abs() / (SUM_SHARE * want[f"abs_{k}"]).clamp_min(1e-30)).max())
    for k in ("mean", "var"):
        a, b = got[k].float(), want[k].float()
        out[k] = float((a - b).abs().max() / (STAT_SHARE * b.abs().max()).clamp_min(1e-30))
    out["ok"] = all(v <= 1.0 for v in out.values())
    return out


def time_site(name: str, shape, dtype, dev, flush: L2Flush, card: str) -> dict:
    t = inputs(shape, dtype, dev, sum(shape))
    plan = bn.plan_for(t["x"])
    want, plain_fwd, plain_bwd = plain(t)
    calls, got = kernel_calls(t, plan, want["saved"])
    record = {"shape": list(shape), "dtype": str(dtype), "plan": vars(plan),
              "vs_plain": differences(got, want), "kernels": {}}
    numel, esize = t["x"].numel(), t["x"].element_size()
    for kname, fn in calls.items():
        ms, warm = device_ms(fn, ITERS, flush=flush), device_ms(fn, ITERS)
        b = bound_ms(TENSORS[kname], numel, esize)
        record["kernels"][kname] = {"ms": ms, "warm_ms": warm, "bound_ms": b, "share": b / ms}
        log(f"{name} {tuple(shape)} {kname}: {ms:.4f} ms flushed, {warm:.4f} warm; bound "
            f"{b:.4f} ({100 * b / ms:.0f}%) ({card})")
    k = record["kernels"]
    for direction, parts, tensors, pl in (
            ("forward", ("batch_norm_fwd_stats", "batch_norm_fwd_apply"), 2, plain_fwd),
            ("backward", ("batch_norm_bwd_reduce", "batch_norm_bwd_apply"), 3, plain_bwd)):
        ms = sum(k[p]["ms"] for p in parts)
        work = bound_ms(tensors, numel, esize)
        record[direction] = {"kernels_ms": ms, "work_bound_ms": work, "share": work / ms,
                             "plain_ms": device_ms(pl, ITERS, flush=flush)}
    try:  # a library call that refuses these inputs is reported, not fatal
        lib_fwd, lib_bwd = library(t)
        record["forward"]["library_ms"] = device_ms(lib_fwd, ITERS, flush=flush)
        record["backward"]["library_ms"] = device_ms(lib_bwd, ITERS, flush=flush)
    except RuntimeError as e:
        record["library_error"] = str(e).splitlines()[0]
    for direction in ("forward", "backward"):
        r = record[direction]
        log(f"{name} {direction}: kernels {r['kernels_ms']:.4f} ms, work bound "
            f"{r['work_bound_ms']:.4f} ({100 * r['share']:.0f}%), plain {r['plain_ms']:.4f}, "
            f"library {r.get('library_ms', record.get('library_error'))} ({card})")
    log(f"{name} against the plain version: {record['vs_plain']}")
    return record


def sweep(name: str, shape, dtype, dev, flush: L2Flush) -> list[dict]:
    """The four kernels at other plans (lanes, chunks)."""
    t = inputs(shape, dtype, dev, sum(shape))
    rows, c = bn.matrix_shape(t["x"])
    base = bn.plan_for(t["x"])
    lanes = [1 << i for i in range(9) if base.lanes <= 1 << i <= min(256, c // base.vec)]
    chunk_counts = sorted(({base.chunks // 2, base.chunks, 2 * base.chunks}
                           | ({1, 2, 4, 8} if base.chunks <= 8 else set())) - {0})
    out = []
    for ln, chunks in itertools.product(lanes, chunk_counts):
        variant = plan_variant(rows, c, dtype, ln, chunks)
        calls, _ = kernel_calls(t, variant)
        r = {"lanes": ln, "chunks": variant.chunks, "ctas": variant.ctas}
        for k, fn in calls.items():
            r[k] = device_ms(fn, ITERS, flush=flush)
        out.append(r)
        log(f"sweep {name} lanes {ln} chunks {variant.chunks} ({variant.ctas} CTAs): "
            + ", ".join(f"{k[11:]} {r[k]:.4f}" for k in calls) + " ms")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="JSON file for the results")
    ap.add_argument("--sweep", action="store_true", help="also time other launch plans")
    args = ap.parse_args(argv)
    dev = platform.require_cuda()
    platform.configure_numerics()
    card = platform.card_description()
    native.load("batch_norm")
    log(f"built batch_norm.cu: {native.BUILD_LOG['batch_norm']}")
    flush = L2Flush(dev)
    results = {"card": card, "sites": {}}
    for name, shape in SITES:
        results["sites"][name] = time_site(name, shape, torch.bfloat16, dev, flush, card)
        if args.sweep:
            results["sites"][name]["sweep"] = sweep(name, shape, torch.bfloat16, dev, flush)
        torch.cuda.empty_cache()
    line = json.dumps(results)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(card)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
