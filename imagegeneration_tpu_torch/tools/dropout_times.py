#!/usr/bin/env python3
"""Device time of the LeakyReLU + hash-dropout kernels, on one CUDA card, for
the checkout it is pointed at.

    python imagegeneration_tpu_torch/tools/dropout_times.py [--tree DIR] [--out FILE]
        [--sweep] [--sass FILE]

`--tree` (default: the checkout holding this file) goes first on the import
path, so that one command can time two checkouts in turns (a parent
unpacked beside the change: parent, change, change, parent). The shapes
(`SHAPES`, bfloat16, channels_last, rate 0.5) are the SNDCGAN headline's
four dropout sites whole (bench.py:241-248) and config 5's four sites as
the image rows [H/2, H) of 2 spatial ranks (bench.py:360-411), through the
tree's own wrappers (`ops/dropout.fwd_kernel`, `bwd_kernel`). Beside each
kernel, a PyTorch call that moves the same bytes: the forward's
`out.copy_(x)` (read x, write y), the backward's `torch.add(x, g, out=dx)`
(read x and g, write dx), the card's practical ceiling for the pass; and
the least time (`bound`): the bytes at 3.35 TB/s, the mask's integer
operations at the int32 rate, the float32 ones at 67 TFLOP/s, the largest
of the three. Each is timed with tools/devtime.py: `ms` with the L2 flushed
before every call (and `median_ms`, the median of those calls, which a
few slow calls do not move), `warm_ms` back to back. Both kernels are also
checked bit-equal to their plain versions once per shape.

`--sweep` also times each pass at other launch plans of this tree
(`launch_plan`'s unroll and CTA overrides; the backward only where its
wrapper takes a plan). `--sass FILE` writes the
kernels' SASS (`cuobjdump -sass` of the tree's built library) to FILE and
counts the instructions (and the integer ones) in each kernel's loop per
element it handles (`loop_counts`, `per_element`).

Prints one line per call and shape, the card's name and power limit, and
as the last line the results as one JSON object (also written to --out).
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

# (label, (B, C, H, W) of the whole map, image rows [H/2, H) or the whole map)
SHAPES = [("headline", (32, 64, 144, 256), False), ("headline", (32, 128, 72, 128), False),
          ("headline", (32, 256, 36, 64), False), ("headline", (32, 512, 18, 32), False),
          ("config5_shard", (16, 64, 288, 512), True),
          ("config5_shard", (16, 128, 144, 256), True),
          ("config5_shard", (16, 256, 72, 128), True),
          ("config5_shard", (16, 512, 36, 64), True)]
ITERS = 50
KW = (0x9E3779B9, 0x7F4A7C15)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_PER_S = 67e12  # H100 SXM float32, outside the tensor cores
INT32_OPS_PER_S = 132 * 64 * 1.98e9  # H100 SXM: 64 int32 lanes an SM at 1.98 GHz
# The mask's integer operations per element as the redesigned forward
# computes it (csrc/leaky_relu_dropout.cu: fmix32's first step folded into
# the vector's index, then one xor for the element's place, two multiplies,
# two shift-xor pairs, the keep test as one multiply-add and one compare),
# and the float32 ones (the LeakyReLU's compare and multiply, the scale,
# the select).
MASK_INT_OPS, F32_OPS = 9, 4


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(passes: int, numel: int, element_size: int) -> dict:
    """The least time of a dropout pass over `numel` elements: `passes`
    tensors of them read or written once over the HBM rate, the mask's
    integer operations over the int32 rate, the float32 ones over the
    float32 rate; the largest is the bound."""
    times = {"bytes_ms": passes * numel * element_size / HBM_BYTES_PER_S * 1e3,
             "int_ms": MASK_INT_OPS * numel / INT32_OPS_PER_S * 1e3,
             "f32_ms": F32_OPS * numel / F32_FLOP_PER_S * 1e3}
    worst = max(times, key=times.get)
    return {**times, "bound_ms": times[worst],
            "bound_by": "bytes" if worst == "bytes_ms" else "operations"}


# SASS opcodes issued to the integer pipe (and the uniform datapath's).
INT_OPCODES = frozenset({"IMAD", "IADD3", "LOP3", "SHF", "ISETP", "LEA", "VIADD", "SEL",
                         "PRMT", "IMNMX", "UIMAD", "UIADD3", "ULOP3", "USHF", "ULEA"})
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)(.*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def loop_counts(sass: str) -> dict:
    """Per kernel of a `cuobjdump -sass` listing: its instructions, and the
    instructions (NOPs left out) of each loop, a range from a backward
    branch's target to the branch, with their opcodes counted."""
    out, name, body = {}, None, []

    def close():
        if name is None:
            return
        loops = []
        for addr, op, rest in body:
            if op.startswith("BRA") and (m := _TARGET.search(rest)):
                target = int(m.group(1), 16)
                if target < addr:
                    ops = [o for a, o, _ in body if target <= a <= addr and o != "NOP"]
                    by_op: dict[str, int] = {}
                    for o in ops:
                        by_op[o.split(".")[0]] = by_op.get(o.split(".")[0], 0) + 1
                    loops.append({"from": target, "to": addr, "instructions": len(ops),
                                  "by_opcode": dict(sorted(by_op.items()))})
        out[name] = {"instructions": sum(o != "NOP" for _, o, _ in body), "loops": loops}

    for line in sass.splitlines():
        if "Function :" in line:
            close()
            name, body = line.split("Function :")[1].strip(), []
        elif name is not None and (m := _INSTR.search(line)):
            body.append((int(m.group(1), 16), m.group(2), m.group(3)))
    close()
    return out


def elements_per_store(kernel: str) -> int | None:
    """Elements of one store instruction of a dropout kernel, from its
    mangled name: a vector (8 bf16 or 4 float32) for the vector kernel, 1
    for the others; None for any other kernel."""
    if "lrd_" not in kernel:
        return None
    if "vector_kernel" in kernel:
        return 8 if "bfloat16" in kernel else 4
    return 1


def sass_report(library: Path, path: Path) -> dict:
    """cuobjdump's SASS of `library` written to `path`, and each dropout
    kernel's loop instructions per element."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    path.write_text(text)
    report = {}
    for kernel, info in loop_counts(text).items():
        per_store = elements_per_store(kernel)
        if per_store is None:
            continue
        report[kernel] = {**info, **per_element(info, per_store)}
    return report


def per_element(info: dict, per_store: int) -> dict:
    """The largest loop's instructions per element: a trip handles as many
    elements as its stores write (the compiler may unroll a one-element
    loop), and of them the integer ones (INT_OPCODES)."""
    main = max(info["loops"], key=lambda lp: lp["instructions"], default=None)
    if main is None or not main["by_opcode"].get("STG"):
        return {"elements_per_trip": None, "loop_instructions_per_element": None}
    per_trip = main["by_opcode"]["STG"] * per_store
    ints = sum(n for op, n in main["by_opcode"].items() if op in INT_OPCODES)
    return {"elements_per_trip": per_trip,
            "loop_instructions_per_element": main["instructions"] / per_trip,
            "loop_integer_instructions_per_element": ints / per_trip}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose imagegeneration_tpu_torch is timed")
    ap.add_argument("--out", help="JSON file for the results")
    ap.add_argument("--sweep", action="store_true",
                    help="also time each pass at other launch plans of this tree")
    ap.add_argument("--sass", help="file for the kernels' SASS; counts their loops")
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    import imagegeneration_tpu_torch
    from imagegeneration_tpu_torch.core import platform
    from imagegeneration_tpu_torch.ops import dropout, native
    from imagegeneration_tpu_torch.tools.devtime import L2Flush, device_ms

    if Path(imagegeneration_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {imagegeneration_tpu_torch.__file__}, not from {tree}")
    dev = platform.require_cuda()
    card = platform.card_description()
    native.load("leaky_relu_dropout")
    flush = L2Flush(dev)

    def flushed_median(fn) -> float:
        """The median device ms of ITERS calls, each after an L2 flush and
        between two events (devtime's flushed timing, median for mean)."""
        marks = []
        for _ in range(ITERS):
            flush()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            marks.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in marks)

    def times(fn) -> dict:
        return {"ms": device_ms(fn, ITERS, flush=flush), "median_ms": flushed_median(fn),
                "warm_ms": device_ms(fn, ITERS)}

    kw = torch.tensor(KW, device=dev)
    cut = dropout.dropout_cut(0.5)
    out: dict = {"card": card, "tree": str(tree), "torch": torch.__version__, "shapes": []}
    if args.sass:
        out["sass"] = sass_report(native.library_path("leaky_relu_dropout"), Path(args.sass))
        for kernel, rep in out["sass"].items():
            log(f"{kernel}: {rep['loop_instructions_per_element']} loop instructions an "
                f"element ({rep['loop_integer_instructions_per_element']} integer; "
                f"{rep['elements_per_trip']} a trip), {rep['instructions']} in all")
    for label, shape, shard in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(sum(shape))
        cl = torch.channels_last
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16).contiguous(
            memory_format=cl)
        g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16).contiguous(
            memory_format=cl)
        b, c, h, w = shape
        total, hblock = x.numel(), None
        if shard:
            hblock = (h // 2, h)
            x, g = (t[:, :, h // 2:].contiguous(memory_format=cl) for t in (x, g))
        y = torch.empty_like(x)
        equal = torch.equal(dropout.fwd_kernel(x, kw, cut, 0, total, hblock),
                            dropout.fwd_plain(x, kw, cut, 0, hblock))
        bwd_equal = torch.equal(dropout.bwd_kernel(x, g, kw, cut, 0, total, hblock),
                                dropout.bwd_plain(x, g, kw, cut, 0, hblock))
        rec = {"label": label, "shape_nchw": list(x.shape), "hblock": hblock,
               "fwd_equals_plain": equal, "bwd_equals_plain": bwd_equal,
               "fwd": times(lambda: dropout.fwd_kernel(x, kw, cut, 0, total, hblock)),
               "bwd": times(lambda: dropout.bwd_kernel(x, g, kw, cut, 0, total, hblock)),
               "copy": times(lambda: y.copy_(x)),
               "add": times(lambda: torch.add(x, g, out=y)),
               "fwd_bound": bound(2, x.numel(), x.element_size()),
               "bwd_bound": bound(3, x.numel(), x.element_size())}
        parts = {"fwd": lambda p: dropout.fwd_kernel(x, kw, cut, 0, total, hblock, p)}
        if "plan" in inspect.signature(dropout.bwd_kernel).parameters:
            parts["bwd"] = lambda p: dropout.bwd_kernel(x, g, kw, cut, 0, total, hblock, p)
        if args.sweep and hasattr(dropout, "launch_plan"):
            rowmap = dropout.row_map(x, hblock)
            auto = dropout.launch_plan(x.numel(), x.dtype, rowmap)
            rec["plan"] = {"path": auto.path, "unroll": auto.unroll, "ctas_x": auto.ctas_x,
                           "ctas": auto.ctas}
            rec["sweep"] = {}
            for unroll in dropout.UNROLLS:
                # CTAs along a row: the plan's count times a factor, or one
                # CTA for each unroll x THREADS vectors (a single trip each)
                whole = -(-(auto.row_len // auto.vec) // (dropout.THREADS * unroll))
                for ctas_x in sorted({max(1, round(auto.ctas_x * f)) for f in (0.5, 1, 2, 4)}
                                     | {whole}):
                    plan = dropout.launch_plan(x.numel(), x.dtype, rowmap, unroll=unroll,
                                               ctas_x=ctas_x)
                    for part, launch in parts.items():
                        rec["sweep"][f"{part}_u{unroll}_ctas{plan.ctas}"] = times(
                            lambda: launch(plan))
        out["shapes"].append(rec)
        fb, bb = rec["fwd_bound"]["bound_ms"], rec["bwd_bound"]["bound_ms"]
        log(f"{label} {tuple(x.shape)}: fwd {rec['fwd']['ms']:.4f} ms flushed (median "
            f"{rec['fwd']['median_ms']:.4f}, bwd {rec['bwd']['median_ms']:.4f}) "
            f"{rec['fwd']['warm_ms']:.4f} warm (bound {fb:.4f}, copy_ {rec['copy']['ms']:.4f} "
            f"/ {rec['copy']['warm_ms']:.4f}); bwd {rec['bwd']['ms']:.4f} / "
            f"{rec['bwd']['warm_ms']:.4f} (bound {bb:.4f}, add {rec['add']['ms']:.4f} / "
            f"{rec['add']['warm_ms']:.4f}); bit-equal to plain: fwd {equal}, bwd "
            f"{bwd_equal} ({card})")
        for key, t in rec.get("sweep", {}).items():
            log(f"    {key}: {t['ms']:.4f} / {t['warm_ms']:.4f}")
        del x, g, y
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
