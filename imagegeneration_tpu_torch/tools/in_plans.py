#!/usr/bin/env python3
"""The InstanceNorm kernels under several launch plans, on one CUDA card.

    python -m imagegeneration_tpu_torch.tools.in_plans --out DIR

At the largest norm shapes of the headline CycleGAN step, for the forward
and the backward, the default plan of ops/instance_norm.launch_plan and the
alternatives below (channel block, cluster size, shared-memory slice on or
off). Each plan is run once against the plain version (max abs error),
then timed as device time with the L2 flushed between calls and warm;
beside it, how many of its clusters the card holds at once. The library
call that computes the same function (`F.instance_norm`; the backward of
batch norm over the (1, B*C, H, W) view) is timed the same way. Writes
in_plans.json under DIR; prints one line per plan, the card's name and
power limit, and as the last line the results as one JSON object.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch
import torch.nn.functional as F

from imagegeneration_tpu_torch.core import platform
from imagegeneration_tpu_torch.ops import instance_norm as inorm
from imagegeneration_tpu_torch.tools.devtime import L2Flush, device_ms

# (shape, dtype, whether to try the alternatives or only the default plan)
SHAPES = [((4, 64, 128, 128), torch.float32, True), ((4, 64, 128, 128), torch.bfloat16, True),
          ((4, 128, 64, 64), torch.float32, True), ((4, 256, 32, 32), torch.float32, True),
          ((4, 3, 128, 128), torch.float32, False), ((4, 128, 30, 30), torch.float32, False),
          ((4, 256, 14, 14), torch.float32, False), ((4, 512, 6, 6), torch.float32, False)]
ALTERNATIVES = [
    {}, {"held": 0}, {"held": 1}, {"held": 2}, {"channel_block": 32},
    {"channel_block": 8, "cluster": 1}, {"channel_block": 16, "cluster": 1},
    {"channel_block": 8, "cluster": 2}, {"channel_block": 16, "cluster": 2},
    {"channel_block": 16, "cluster": 4}, {"cluster": 2}, {"cluster": 4}, {"cluster": 8},
    {"cluster": 16},
]
EPS = 1e-3


def inputs(shape, dtype, dev):
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    x = (2.0 + 3.0 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
    dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(shape[1], generator=gen, device=dev)
    beta = 0.1 * torch.randn(shape[1], generator=gen, device=dev)
    cl = torch.channels_last
    return x.contiguous(memory_format=cl), dy.contiguous(memory_format=cl), gamma, beta


def library_fwd(x, gamma, beta):
    """One PyTorch call for the forward (never used by the port)."""
    return lambda: F.instance_norm(x, weight=gamma, bias=beta, eps=EPS)


def library_bwd(x, dy, gamma, mean, rstd):
    """One PyTorch call for the backward without ReLU: F.instance_norm runs
    batch norm over the (1, B*C, H, W) view of the NCHW-contiguous input,
    and its backward is this aten call on that view, gamma repeated per
    sample (never used by the port)."""
    b, c, h, w = x.shape
    x_r, dy_r = (t.contiguous().view(1, b * c, h, w) for t in (x, dy))
    g_r = gamma.repeat(b)
    return lambda: torch.ops.aten.native_batch_norm_backward(
        dy_r, x_r, g_r, None, None, mean.view(-1), rstd.view(-1), True, EPS,
        [True, True, True])


def sweep(shape, dtype, alternatives, dev, flush) -> list[dict]:
    b, c, h, w = shape
    x, dy, gamma, beta = inputs(shape, dtype, dev)
    yp, mean, rstd = inorm.in_fwd_plain(x, gamma, beta, EPS, True)
    dxp = inorm.in_bwd_plain(x, dy, gamma, beta, mean, rstd, True)[0]
    out = []
    if dtype == torch.float32:
        for direction, fn in (("fwd", library_fwd(x, gamma, beta)),
                              ("bwd", library_bwd(x, dy, gamma, mean, rstd))):
            rec = {"ms": device_ms(fn, flush=flush), "warm_ms": device_ms(fn),
                   "shape": list(shape), "dtype": "float32", "direction": direction,
                   "library": True}
            print(json.dumps(rec), flush=True)
            out.append(rec)
    for backward in (False, True):
        seen = set()
        for alt in ALTERNATIVES if alternatives else [{}]:
            plan = inorm.launch_plan(b, c, h, w, dtype, 1 + backward, **alt)
            if plan in seen or plan.smem_bytes > inorm.SMEM_LIMIT:
                continue
            seen.add(plan)
            if backward:
                def fn(plan=plan):
                    return inorm.in_bwd_kernel(x, dy, gamma, beta, mean, rstd, True, plan)
                want = dxp
            else:
                def fn(plan=plan):
                    return inorm.in_fwd_kernel(x, gamma, beta, EPS, True, plan)
                want = yp
            try:
                err = (fn()[0].float() - want.float()).abs().max().item()
                rec = {"ms": device_ms(fn, flush=flush), "warm_ms": device_ms(fn),
                       "max_abs_err": err}
            except RuntimeError as e:  # a plan the card refuses is a finding too
                rec = {"error": str(e)}
            rec.update(shape=list(shape), dtype=str(dtype).split(".")[1],
                       direction="bwd" if backward else "fwd", default=not alt,
                       plan=dict(vars(plan)), active_clusters=inorm.active_clusters(
                           plan, c, h * w, dtype, backward))
            print(json.dumps(rec), flush=True)
            out.append(rec)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory for in_plans.json")
    args = ap.parse_args(argv)
    dev = platform.require_cuda()
    platform.configure_numerics()
    card = platform.card_description()
    flush = L2Flush(dev)
    results = [r for shape, dtype, alts in SHAPES for r in sweep(shape, dtype, alts, dev, flush)]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    summary = {"card": card, "torch": torch.__version__, "plans": results}
    (out / "in_plans.json").write_text(json.dumps(summary, indent=1))
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
