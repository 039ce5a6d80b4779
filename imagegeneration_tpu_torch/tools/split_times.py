#!/usr/bin/env python3
"""Device time of the split InstanceNorm kernels, on one CUDA card, for the
checkout it is pointed at.

    python imagegeneration_tpu_torch/tools/split_times.py [--tree DIR] [--out FILE]

`--tree` (default: the checkout holding this file) goes first on the import
path, so that one command can time two checkouts in turns (a parent
unpacked beside the change). The shapes are the CycleGAN generator's norm
maps at 128x128, batch 4, base 64, as half-height shards of 2 spatial
ranks (chip_smoke.IN_SPLIT_SHAPES), float32. At each, through the tree's
own wrappers (`split_calls`, which chip_smoke.py's phase 3 times too): the
forward partial, the forward apply (from two shards' partials as the
tree's partial writes them), the backward partial, the backward apply;
beside the forward partial torch.var_mean(x, dim=(2, 3)), beside the
backward partial aten.native_batch_norm_backward with output_mask (False,
True, True) on the (1, B*C, h, W) view (`library_bwd_partial`: sum dy and
sum dy * xhat per (b, c), the partial's sums before the x gamma); and an
empty kernel (torch.cuda._sleep(0), one thread that returns at once), the
floor of a launch in this harness. Each is timed with tools/devtime.py:
`ms` with the L2 flushed before every call, `warm_ms` back to back.

Prints one line per call and shape, the card's name and power limit, and
as the last line the results as one JSON object (also written to --out).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

SHAPES = [(4, 64, 64, 128), (4, 128, 32, 64), (4, 256, 16, 32), (4, 3, 64, 128)]
NAMES = ("instance_norm_fwd_partial", "instance_norm_fwd_apply",
         "instance_norm_bwd_partial", "instance_norm_bwd_apply")
LIBRARY = {"instance_norm_fwd_partial": "torch.var_mean(x, dim=(2, 3))",
           "instance_norm_bwd_partial": "aten.native_batch_norm_backward(output_mask=(False, "
                                        "True, True)) on the (1, B*C, h, W) view"}
SHARDS = 2
EPS = 1e-3
ITERS = 50


def log(msg: str) -> None:
    print(msg, flush=True)


def library_bwd_partial(x, dy, gamma, mean, rstd):
    """One PyTorch call for the backward partial without ReLU (never used by
    the port): batch norm's backward over the (1, B*C, h, W) view of the
    NCHW-contiguous shard, from the merged mean and rstd, returns (None,
    sum dy * xhat, sum dy) per (b, c) over the shard's rows. The weight
    (gamma per sample; the CUDA call refuses none) does not enter them."""
    import torch

    b, c, h, w = x.shape
    x_r, dy_r = (t.contiguous().view(1, b * c, h, w) for t in (x, dy))
    g_r, mean_r, rstd_r = gamma.repeat(b), mean.reshape(-1), rstd.reshape(-1)
    return lambda: torch.ops.aten.native_batch_norm_backward(
        dy_r, x_r, g_r, None, None, mean_r, rstd_r, True, EPS, [False, True, True])


def library_partial_sums(out, gamma):
    """`library_bwd_partial`'s result as the partial's (B, C, 2) sums:
    gamma * (sum dy, sum dy * xhat)."""
    import torch

    _, sum_gx, sum_g = out
    c = gamma.numel()
    return torch.stack([sum_g.view(-1, c), sum_gx.view(-1, c)], -1) * gamma.view(1, c, 1)


def split_calls(inorm, x, dy, gamma, beta, shards: int = SHARDS, plain: bool = False) -> dict:
    """name -> (kernel, plain version or None, library call or None), each a
    call of no arguments at the shard `x` of a map cut into `shards` row
    blocks; the applies take `shards` copies of the shard's partials, and
    the backward takes the merged mean and rstd. `inorm` is the timed
    tree's ops/instance_norm; `plain` needs this tree's plain versions."""
    import torch

    h, w = x.shape[2:]
    parts = torch.stack([inorm.in_fwd_partial_kernel(x)] * shards)
    _, mean, rstd = inorm.in_fwd_apply_kernel(x, parts, gamma, beta, EPS, False)
    sums = inorm.in_bwd_partial_kernel(x, dy, gamma, beta, mean, rstd, False)[0] * shards
    total = shards * h * w
    chunks = parts.shape[1]
    calls = {
        NAMES[0]: (lambda: inorm.in_fwd_partial_kernel(x),
                   lambda: inorm.in_fwd_partial_plain(x, chunks),
                   lambda: torch.var_mean(x, dim=(2, 3))),
        NAMES[1]: (lambda: inorm.in_fwd_apply_kernel(x, parts, gamma, beta, EPS, False),
                   lambda: inorm.in_fwd_apply_plain(x, parts, gamma, beta, EPS, False), None),
        NAMES[2]: (lambda: inorm.in_bwd_partial_kernel(x, dy, gamma, beta, mean, rstd, False),
                   lambda: inorm.in_bwd_partial_plain(x, dy, gamma, beta, mean, rstd, False),
                   library_bwd_partial(x, dy, gamma, mean, rstd)),
        NAMES[3]: (lambda: inorm.in_bwd_apply_kernel(x, dy, sums, gamma, beta, mean, rstd,
                                                     False, total),
                   lambda: inorm.in_bwd_apply_plain(x, dy, sums, gamma, beta, mean, rstd,
                                                    False, total), None),
    }
    return {k: (kern, pl if plain else None, lib) for k, (kern, pl, lib) in calls.items()}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose imagegeneration_tpu_torch is timed")
    ap.add_argument("--out", help="JSON file for the results")
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    import imagegeneration_tpu_torch
    from imagegeneration_tpu_torch.core import platform
    from imagegeneration_tpu_torch.ops import instance_norm as inorm
    from imagegeneration_tpu_torch.tools.devtime import L2Flush, device_ms

    if Path(imagegeneration_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {imagegeneration_tpu_torch.__file__}, not from {tree}")
    dev = platform.require_cuda()
    card = platform.card_description()
    flush = L2Flush(dev)

    def times(fn) -> dict:
        return {"ms": device_ms(fn, ITERS, flush=flush), "warm_ms": device_ms(fn, ITERS)}

    out: dict = {"card": card, "tree": str(tree), "torch": torch.__version__,
                 "empty_kernel": times(lambda: torch.cuda._sleep(0)), "library": LIBRARY,
                 "shapes": {}}
    log(f"empty kernel: {out['empty_kernel']} ({card})")
    for shape in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(sum(shape))
        cl = torch.channels_last
        x = (2.0 + 3.0 * torch.randn(shape, generator=gen, device=dev)).contiguous(
            memory_format=cl)
        dy = torch.randn(shape, generator=gen, device=dev).contiguous(memory_format=cl)
        gamma = 1.0 + 0.1 * torch.randn(shape[1], generator=gen, device=dev)
        beta = 0.1 * torch.randn(shape[1], generator=gen, device=dev)
        rec = {}
        for name, (kernel, _, library) in split_calls(inorm, x, dy, gamma, beta).items():
            rec[name] = times(kernel)
            if library is not None:
                rec[name]["library"] = times(library)
        out["shapes"][str(shape)] = rec
        for name, t in rec.items():
            lib = t.get("library")
            log(f"{shape} {name}: {t['ms']:.4f} ms flushed, {t['warm_ms']:.4f} ms warm"
                + (f"; library {lib['ms']:.4f} flushed, {lib['warm_ms']:.4f} warm"
                   if lib else "") + f" ({card})")
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
