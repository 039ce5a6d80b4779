"""batch_norm_roofline's arithmetic, on the CPU: the generator's BatchNorm
sites and the bytes and operations of one step at `sndcgan-256x144`, the
kernel rule against the source's kernels, and a trace without them."""

import re

import pytest

from portbench import harness, peaks, spec as speclib, trace

SPEC = speclib.Spec.load(harness.ROOT)
READER = SPEC.reader("batch_norm_roofline")


def test_sites_of_the_headline_generator():
    c = harness.Cell(SPEC, "sndcgan-b128")
    sites = READER.site_shapes(c)
    assert sites == [(128 * 294912, 294912), (128 * 256 * 36 * 64, 256),
                     (128 * 128 * 72 * 128, 128), (128 * 64 * 144 * 256, 64)]
    assert sum(n for n, _ in sites) == 566_231_040


def test_bytes_and_operations_of_one_step():
    c = harness.Cell(SPEC, "sndcgan-b128")
    nbytes, ops = READER.work(c)
    channels = 294912 + 256 + 128 + 64
    # forward: read x, write y (bf16) and 8 float32 vectors; backward: read x
    # and dy, write dx and 6 vectors
    assert nbytes == 4 * 566_231_040 + 32 * channels + 6 * 566_231_040 + 24 * channels
    assert nbytes == 5_678_850_560
    assert ops == (7 + 12) * 566_231_040
    # bytes bound it: 1.695 ms at 3.35 TB/s
    assert nbytes / 3.35e12 == pytest.approx(1.6952e-3, rel=1e-4)
    assert peaks.roofline_pct("NVIDIA H100 80GB HBM3", "bfloat16", nbytes, ops,
                              nbytes / 3.35e12) == pytest.approx(100.0)


def test_kernel_rule_matches_the_sources_kernels():
    src = harness.ROOT / harness.PROGRAM / "csrc" / "batch_norm.cu"
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\(\w+\))?\s+(\w+)\(",
                         src.read_text())
    assert sorted(kernels) == ["bn_bwd_apply_kernel", "bn_bwd_reduce_kernel",
                               "bn_fwd_apply_kernel", "bn_fwd_stats_kernel"]
    for k in kernels:
        assert READER.KERNELS.search(f"void (anonymous namespace)::{k}<__nv_bfloat16, 8>(...)")
    assert not READER.KERNELS.search("void in_fwd_apply_kernel<float, 4>")
    assert not READER.KERNELS.search("at::native::batch_norm_collect_statistics_kernel")


def test_reads_nothing_without_the_kernels_or_off_sndcgan():
    c = harness.Cell(SPEC, "sndcgan-b128")
    c.kind = "NVIDIA H100 80GB HBM3"
    ann = {"ph": "X", "cat": "user_annotation", "name": harness.ANNOTATION, "ts": 0.0,
           "dur": 100.0}
    other = {"ph": "X", "cat": "kernel", "name": "void elementwise_kernel<128, 2>", "ts": 10.0,
             "dur": 50.0}
    c.profiled, c.profiled_steps = trace.Window([ann, other], harness.ANNOTATION), 1
    assert READER.read(c) is None
    bn = {**other, "name": "void (anonymous namespace)::bn_fwd_stats_kernel<bf16, 8>(...)"}
    c.profiled = trace.Window([ann, bn], harness.ANNOTATION)
    assert READER.read(c) == pytest.approx(100.0 * (5_678_850_560 / 3.35e12) / 50e-6)
    g = harness.Cell(SPEC, "cyclegan-b4")
    g.kind, g.profiled, g.profiled_steps = c.kind, c.profiled, 1
    assert READER.read(g) is None
