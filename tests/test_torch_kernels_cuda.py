"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test skips where no CUDA device is visible (the CPU
test run). On a machine with an H100 and nvcc, run them with

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_cuda.py -q

(`--noconftest`: tests/conftest.py imports jax, which the GPU machine
lacks.) Bounds: the dropout kernels are bit-identical to their plain
versions (same float32 products, one rounding to the storage dtype; the
mask is integer arithmetic), and so is Adam (explicitly rounded float32
operations in both), on ragged, misaligned and channels_last leaf lists
and on lists longer than one launch's table. The shapes include odd,
non-power-of-two extents so that the grid-stride tail is exercised.

The InstanceNorm kernels sum their statistics in another order than the
plain version, so they are held to the bounds of the JAX package's own
kernel tests (tests/test_pallas_ops.py): rtol/atol 2e-5 for y, dx, dgamma
and dbeta, 1e-5 for mean and rstd, in float32. dgamma and dbeta are sums of
N = B*H*W terms per channel, whose float32 rounding grows as sqrt(N): their
atol is 2e-5 at the N = 128 (2 x 8 x 8) of those tests, scaled by
sqrt(N / 128). A bfloat16 output may in addition round to the neighbouring
bf16 value (one ulp, 2^-7 |v|). The backward is fed the plain forward's
mean and rstd, so both rebuild the same ReLU mask.
"""

import dataclasses
import math

import pytest
import torch

from imagegeneration_tpu_torch.models.cyclegan import CycleGANConfig
from imagegeneration_tpu_torch.models.sndcgan import SNDCGANConfig
from imagegeneration_tpu_torch.ops import adam, dropout
from imagegeneration_tpu_torch.ops import instance_norm as inorm
from imagegeneration_tpu_torch.tools import split_times
from imagegeneration_tpu_torch.train import cyclegan_step
from imagegeneration_tpu_torch.train import sndcgan_step as steplib

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (3, 64, 17, 33), (1, 512, 18, 32)])
@pytest.mark.parametrize("rate", [0.5, 0.1])
def test_dropout_kernels_equal_plain(cuda, dtype, shape, rate):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    g = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    g = g.contiguous(memory_format=torch.channels_last)
    kw = torch.tensor([0x9E3779B9, 0x7F4A7C15], device=cuda)
    cut = dropout.dropout_cut(rate)
    before = dict(dropout.LAUNCHES)
    y = dropout.leaky_relu_dropout(x, kw, rate)
    y.backward(g)
    assert dropout.LAUNCHES["leaky_relu_dropout_fwd"] == before["leaky_relu_dropout_fwd"] + 1
    assert dropout.LAUNCHES["leaky_relu_dropout_bwd"] == before["leaky_relu_dropout_bwd"] + 1
    assert y.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(
        y, dropout.fwd_plain(x.detach(), kw, cut), rtol=0, atol=0)
    torch.testing.assert_close(
        x.grad, dropout.bwd_plain(x.detach(), g, kw, cut),
        rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 3, 5, 7), (6, 64, 17, 33)])
def test_dropout_kernels_with_a_row_base_equal_the_full_batch_rows(cuda, dtype, shape):
    """A data-parallel rank's rows, with the element-index base of its
    first row: bit-equal to those rows of the full batch, through the
    autograd wrapper, and to the plain version with that base."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    g = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    g = g.contiguous(memory_format=torch.channels_last)
    kw = torch.tensor([0x9E3779B9, 0x7F4A7C15], device=cuda)
    cut = dropout.dropout_cut(0.5)
    full_y, full_dx = dropout.fwd_kernel(x, kw, cut), dropout.bwd_kernel(x, g, kw, cut)
    b = shape[0] // 2
    for first in (0, b):
        rows = slice(first, first + b)
        xr = x[rows].detach().requires_grad_(True)
        y = dropout.leaky_relu_dropout(xr, kw, 0.5, rows=(first, shape[0]))
        y.backward(g[rows])
        base = dropout.rows_base(x, first)
        assert torch.equal(y, full_y[rows]) and torch.equal(xr.grad, full_dx[rows])
        assert torch.equal(y, dropout.fwd_plain(x[rows], kw, cut, base))
        assert torch.equal(xr.grad, dropout.bwd_plain(x[rows], g[rows], kw, cut, base))
    with pytest.raises(ValueError, match="2\\*\\*32"):
        dropout.fwd_kernel(x, kw, cut, base=0, total=2**32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 3, 10, 7), (6, 64, 18, 33)])
def test_dropout_kernels_on_an_h_shard_equal_the_whole_array(cuda, dtype, shape):
    """A spatial rank's image rows (and a data x spatial rank's batch rows
    and image rows), with the row-block index mapping: bit-equal to those
    elements of the whole array's call, through the autograd wrapper, and
    to the plain version with the same mapping."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + 1)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    g = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    g = g.contiguous(memory_format=torch.channels_last)
    kw = torch.tensor([0x9E3779B9, 0x7F4A7C15], device=cuda)
    cut = dropout.dropout_cut(0.5)
    full_y, full_dx = dropout.fwd_kernel(x, kw, cut), dropout.bwd_kernel(x, g, kw, cut)
    b, h = shape[0] // 2, shape[2] // 2
    for first, h0, nb in ((0, 0, shape[0]), (0, h, shape[0]), (b, h, b)):
        rows, hrows = slice(first, first + nb), slice(h0, h0 + h)
        xs = x[rows, :, hrows].contiguous(memory_format=torch.channels_last)
        gs = g[rows, :, hrows].contiguous(memory_format=torch.channels_last)
        xs.requires_grad_(True)
        y = dropout.leaky_relu_dropout(xs, kw, 0.5, rows=(first, shape[0]),
                                       hblock=(h0, shape[2]))
        y.backward(gs)
        assert torch.equal(y, full_y[rows, :, hrows])
        assert torch.equal(xs.grad, full_dx[rows, :, hrows])
        base = dropout.rows_base(xs, first, shape[2])
        assert torch.equal(y, dropout.fwd_plain(xs.detach(), kw, cut, base, (h0, shape[2])))
        assert torch.equal(xs.grad, dropout.bwd_plain(xs.detach(), gs, kw, cut, base,
                                                      (h0, shape[2])))


# The forward's launch plans (ops/dropout.launch_plan): the SNDCGAN
# headline's four sites, whole, and config 5's four sites as H-shards of 2.
DROPOUT_SITES = [(32, 64, 144, 256), (32, 128, 72, 128), (32, 256, 36, 64), (32, 512, 18, 32)]
CONFIG5_SITES = [(16, 64, 288, 512), (16, 128, 144, 256), (16, 256, 72, 128), (16, 512, 36, 64)]
KW = (0x9E3779B9, 0x7F4A7C15)


def dropout_input(cuda, shape, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    return x.contiguous(memory_format=torch.channels_last)


def forward_against_plain(x, kw, cut, base=0, total=None, hblock=None, path="vector",
                          plan=None):
    """The forward kernel bit-equal to the plain version, through `path`."""
    before = dict(dropout.FWD_PATHS)
    y = dropout.fwd_kernel(x, kw, cut, base, total, hblock, plan)
    assert dropout.FWD_PATHS[path] == before[path] + 1
    assert torch.equal(y.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32),
                       dropout.fwd_plain(x, kw, cut, base, hblock).view(
                           torch.int16 if x.dtype == torch.bfloat16 else torch.int32))
    return y


@pytest.mark.parametrize("rate", [0.5, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DROPOUT_SITES)
def test_dropout_forward_equals_plain_at_the_headline_sites(cuda, shape, dtype, rate):
    """Every main-path site, whole (one row, the vector path), and a
    data-parallel rank's half of it with its row base."""
    x = dropout_input(cuda, shape, dtype, sum(shape))
    kw = torch.tensor(KW, device=cuda)
    cut = dropout.dropout_cut(rate)
    forward_against_plain(x, kw, cut)
    b = shape[0] // 2
    forward_against_plain(x[b:], kw, cut, dropout.rows_base(x, b), x.numel())


@pytest.mark.parametrize("rate", [0.5, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CONFIG5_SITES)
def test_dropout_forward_equals_plain_on_the_config5_shards(cuda, shape, dtype, rate):
    """Config 5's sites on 2 spatial ranks (image rows [0, H/2) and [H/2,
    H): one grid row per batch row), and on data 2 x spatial 2 (batch rows
    [B/2, B) as well, with their row base); equal to the whole array's
    elements too."""
    x = dropout_input(cuda, shape, dtype, sum(shape) + 1)
    kw = torch.tensor(KW, device=cuda)
    cut = dropout.dropout_cut(rate)
    full = dropout.fwd_kernel(x, kw, cut)
    b, _, h, _ = shape
    hh = h // 2
    for first, s in ((0, 0), (0, 1), (b // 2, 1)):
        rows, hrows = slice(first, b), slice(s * hh, (s + 1) * hh)
        xs = x[rows, :, hrows].contiguous(memory_format=torch.channels_last)
        y = forward_against_plain(xs, kw, cut, dropout.rows_base(xs, first, h), x.numel(),
                                  (s * hh, h))
        assert torch.equal(y, full[rows, :, hrows])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_forward_tails_and_misaligned_views(cuda, dtype):
    """Tails of 1 to 7 elements (1 to 3 in float32) past the last vector
    of a one-row launch; the same data as a view 1 to 7 elements past a
    16-byte boundary (the scalar path); and a shard whose rows are not whole
    vectors (W*C = 21, the scalar path)."""
    kw = torch.tensor(KW, device=cuda)
    cut = dropout.dropout_cut(0.5)
    vec = 128 // torch.finfo(dtype).bits
    for tail in range(1, vec):
        n = 37 * vec + tail
        x = dropout_input(cuda, (1, 1, 1, n), dtype, tail)
        assert dropout.launch_plan(n, dtype).tail == tail
        forward_against_plain(x, kw, cut)
        for off in range(1, vec):
            buf = dropout_input(cuda, (1, 1, 1, n + off), dtype, off)
            view = buf.view(-1)[off:].view(1, 1, 1, n)
            assert view.data_ptr() % 16 != 0
            forward_against_plain(view, kw, cut, path="scalar")
    x = dropout_input(cuda, (4, 3, 10, 7), dtype, 9)
    xs = x[:, :, 5:].contiguous(memory_format=torch.channels_last)
    forward_against_plain(xs, kw, cut, 0, x.numel(), (5, 10), path="scalar")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_forward_plans_give_the_same_bits(cuda, dtype):
    """Every unroll and CTA count the plan could choose, on a whole map
    and on a shard, equal the plain version."""
    kw = torch.tensor(KW, device=cuda)
    cut = dropout.dropout_cut(0.5)
    x = dropout_input(cuda, (6, 64, 18, 33), dtype, 3)
    xs = x[:, :, 9:].contiguous(memory_format=torch.channels_last)
    for unroll in dropout.UNROLLS:
        for ctas_x in (1, 7, 132, 1000):
            plan = dropout.launch_plan(x.numel(), dtype, unroll=unroll, ctas_x=ctas_x)
            forward_against_plain(x, kw, cut, plan=plan)
            plan = dropout.launch_plan(xs.numel(), dtype, dropout.row_map(xs, (9, 18)),
                                       unroll=unroll, ctas_x=ctas_x)
            forward_against_plain(xs, kw, cut, 0, x.numel(), (9, 18), plan=plan)


def test_dropout_forward_refuses_a_plan_the_tensor_does_not_allow(cuda):
    """The vector kernel on a view off 16 bytes is a CUDA invalid-value
    error, before any launch, and nothing is counted."""
    buf = dropout_input(cuda, (1, 1, 1, 65), torch.bfloat16, 0)
    view = buf.view(-1)[1:].view(1, 1, 1, 64)
    kw = torch.tensor(KW, device=cuda)
    plan = dropout.launch_plan(64, torch.bfloat16, None, True)
    assert plan.path == "vector"
    before = (dict(dropout.LAUNCHES), dict(dropout.FWD_PATHS))
    with pytest.raises(RuntimeError, match="invalid argument"):
        dropout.fwd_kernel(view, kw, 128, plan=plan)
    assert (dropout.LAUNCHES, dropout.FWD_PATHS) == before


def backward_against_plain(x, g, kw, cut, base=0, total=None, hblock=None, path="vector",
                           plan=None):
    """The backward kernel bit-equal to the plain version, through `path`."""
    before = (dict(dropout.BWD_PATHS), dropout.LAUNCHES["leaky_relu_dropout_bwd"])
    dx = dropout.bwd_kernel(x, g, kw, cut, base, total, hblock, plan)
    assert dropout.BWD_PATHS[path] == before[0][path] + 1
    assert dropout.LAUNCHES["leaky_relu_dropout_bwd"] == before[1] + 1
    bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(dx.view(bits), dropout.bwd_plain(x, g, kw, cut, base, hblock).view(bits))
    return dx


@pytest.mark.parametrize("rate", [0.5, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DROPOUT_SITES)
def test_dropout_backward_equals_plain_at_the_headline_sites(cuda, shape, dtype, rate):
    """Every main-path site, whole (one row, the vector path), and a
    data-parallel rank's half of it with its row base."""
    x = dropout_input(cuda, shape, dtype, sum(shape))
    g = dropout_input(cuda, shape, dtype, sum(shape) + 5)
    kw = torch.tensor(KW, device=cuda)
    cut = dropout.dropout_cut(rate)
    backward_against_plain(x, g, kw, cut)
    b = shape[0] // 2
    backward_against_plain(x[b:], g[b:], kw, cut, dropout.rows_base(x, b), x.numel())


@pytest.mark.parametrize("rate", [0.5, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CONFIG5_SITES)
def test_dropout_backward_equals_plain_on_the_config5_shards(cuda, shape, dtype, rate):
    """Config 5's sites on 2 spatial ranks and on data 2 x spatial 2, as the
    forward's test; equal to the whole array's elements too."""
    x = dropout_input(cuda, shape, dtype, sum(shape) + 1)
    g = dropout_input(cuda, shape, dtype, sum(shape) + 2)
    kw = torch.tensor(KW, device=cuda)
    cut = dropout.dropout_cut(rate)
    full = dropout.bwd_kernel(x, g, kw, cut)
    b, _, h, _ = shape
    hh = h // 2
    for first, s in ((0, 0), (0, 1), (b // 2, 1)):
        rows, hrows = slice(first, b), slice(s * hh, (s + 1) * hh)
        xs, gs = (t[rows, :, hrows].contiguous(memory_format=torch.channels_last)
                  for t in (x, g))
        dx = backward_against_plain(xs, gs, kw, cut, dropout.rows_base(xs, first, h),
                                    x.numel(), (s * hh, h))
        assert torch.equal(dx, full[rows, :, hrows])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_backward_tails_and_misaligned_views(cuda, dtype):
    """Tails of 1 to 7 elements (1 to 3 in float32) past the last vector
    of a one-row launch; x or g (or both) a view 1 to 7 elements past a
    16-byte boundary (the scalar path); and a shard whose rows are not whole
    vectors (W*C = 21, the scalar path)."""
    kw = torch.tensor(KW, device=cuda)
    cut = dropout.dropout_cut(0.5)
    vec = 128 // torch.finfo(dtype).bits
    for tail in range(1, vec):
        n = 37 * vec + tail
        x = dropout_input(cuda, (1, 1, 1, n), dtype, tail)
        g = dropout_input(cuda, (1, 1, 1, n), dtype, tail + 100)
        backward_against_plain(x, g, kw, cut)
        for off in range(1, vec):
            views = [dropout_input(cuda, (1, 1, 1, n + off), dtype, off + k).view(-1)[off:]
                     .view(1, 1, 1, n) for k in (0, 100)]
            assert all(v.data_ptr() % 16 != 0 for v in views)
            backward_against_plain(views[0], g, kw, cut, path="scalar")
            backward_against_plain(x, views[1], kw, cut, path="scalar")
            backward_against_plain(*views, kw, cut, path="scalar")
    x = dropout_input(cuda, (4, 3, 10, 7), dtype, 9)
    g = dropout_input(cuda, (4, 3, 10, 7), dtype, 10)
    xs, gs = (t[:, :, 5:].contiguous(memory_format=torch.channels_last) for t in (x, g))
    backward_against_plain(xs, gs, kw, cut, 0, x.numel(), (5, 10), path="scalar")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_backward_plans_give_the_same_bits(cuda, dtype):
    """Every unroll and CTA count the plan could choose, on a whole map
    and on a shard, and the scalar kernel on aligned data, equal the plain
    version."""
    kw = torch.tensor(KW, device=cuda)
    cut = dropout.dropout_cut(0.5)
    x = dropout_input(cuda, (6, 64, 18, 33), dtype, 3)
    g = dropout_input(cuda, (6, 64, 18, 33), dtype, 4)
    xs, gs = (t[:, :, 9:].contiguous(memory_format=torch.channels_last) for t in (x, g))
    rowmap = dropout.row_map(xs, (9, 18))
    for unroll in dropout.UNROLLS:
        for ctas_x in (1, 7, 132, 1000):
            plan = dropout.launch_plan(x.numel(), dtype, unroll=unroll, ctas_x=ctas_x)
            backward_against_plain(x, g, kw, cut, plan=plan)
            plan = dropout.launch_plan(xs.numel(), dtype, rowmap, unroll=unroll, ctas_x=ctas_x)
            backward_against_plain(xs, gs, kw, cut, 0, x.numel(), (9, 18), plan=plan)
    for ctas_x in (1, 1000):
        plan = dropout.launch_plan(x.numel(), dtype, None, False, ctas_x=ctas_x)
        backward_against_plain(x, g, kw, cut, plan=plan, path="scalar")


def test_dropout_backward_refuses_a_plan_the_tensors_do_not_allow(cuda):
    """The vector kernel with g off 16 bytes is a CUDA invalid-value error,
    before any launch, and nothing is counted."""
    x = dropout_input(cuda, (1, 1, 1, 64), torch.bfloat16, 0)
    buf = dropout_input(cuda, (1, 1, 1, 65), torch.bfloat16, 1)
    g = buf.view(-1)[1:].view(1, 1, 1, 64)
    kw = torch.tensor(KW, device=cuda)
    plan = dropout.launch_plan(64, torch.bfloat16, None, True)
    assert plan.path == "vector"
    before = (dict(dropout.LAUNCHES), dict(dropout.BWD_PATHS))
    with pytest.raises(RuntimeError, match="invalid argument"):
        dropout.bwd_kernel(x, g, kw, 128, plan=plan)
    assert (dropout.LAUNCHES, dropout.BWD_PATHS) == before


def test_dropout_plans_read_the_cards_sm_count(cuda):
    x = dropout_input(cuda, DROPOUT_SITES[0], torch.bfloat16, 0)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    assert dropout.sm_count(x.device.index) == sms
    assert dropout.plan_for(x, (x, x), 0, None, sms) == dropout.launch_plan(
        x.numel(), x.dtype, sms=sms)


def test_dropout_kernel_refuses_nchw_and_bad_keys(cuda):
    x = torch.randn(2, 8, 3, 5, device=cuda)
    kw = torch.tensor([1, 2], device=cuda)
    with pytest.raises(ValueError, match="channels_last"):
        dropout.leaky_relu_dropout(x, kw, 0.5)
    # The kernel entry points check the layout themselves, for callers that
    # reach them without the autograd wrapper.
    with pytest.raises(ValueError, match="channels_last"):
        dropout.fwd_kernel(x, kw, 128)
    with pytest.raises(ValueError, match="channels_last"):
        dropout.bwd_kernel(x, x.contiguous(memory_format=torch.channels_last), kw, 128)
    x = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="kw"):
        dropout.leaky_relu_dropout(x, kw.cpu(), 0.5)  # keys on the CPU


def adam_inputs(cuda, shapes, offsets=None, seed=0, channels_last=()):
    """p, g, m, v lists: leaf i of shape shapes[i], each tensor a view
    offsets[i] floats into its own storage (1-D leaves) or laid out
    channels_last (the indices in `channels_last`)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    offsets = offsets or [0] * len(shapes)
    out = {k: [] for k in "pgmv"}
    for i, (shape, off) in enumerate(zip(shapes, offsets)):
        for k in "pgmv":
            n = math.prod(shape)
            base = torch.randn(n + 8, generator=gen, device=cuda)
            t = (base.abs() if k == "v" else base)[off:off + n].view(shape)
            if i in channels_last:
                t = t.contiguous(memory_format=torch.channels_last)
            out[k].append(t)
    return out["p"], out["g"], out["m"], out["v"]


def adam_against_plain(cuda, p, g, m, v, b1=0.9):
    """One multi-tensor apply against the plain version leaf by leaf, bit
    for bit; returns the kernel launches it took."""
    alpha = adam.adam_alpha(torch.tensor(2, device=cuda), 1e-3, b1, 0.999)
    pk, mk, vk = ([t.clone() for t in ts] for ts in (p, m, v))
    before = adam.LAUNCHES["adam"]
    adam.adam_kernel(adam.LeafTable(pk, mk, vk), g, alpha, b1, 0.999)
    launches = adam.LAUNCHES["adam"] - before
    adam.adam_plain(p, g, m, v, alpha, b1, 0.999)
    for a, b in zip(pk + mk + vk, p + m + v):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    return launches


@pytest.mark.parametrize("n", [1, 1000, 4097, 1 << 20])
def test_adam_kernel_equals_plain(cuda, n):
    p, g, m, v = adam_inputs(cuda, [(n,)], seed=n)
    assert adam_against_plain(cuda, p, g, m, v) == 1


@pytest.mark.parametrize("case", ["ragged", "misaligned", "aligned_unlike", "channels_last",
                                  "longer_than_a_table"])
def test_adam_multi_tensor_equals_plain(cuda, case):
    """Ragged element counts (1-3, not a multiple of 4, several chunks),
    views at odd offsets, leaves whose four tensors are aligned unlike,
    channels_last conv weights, and more leaves than one table holds."""
    ns = [1, 2, 3, 4, 5, 7, 4095, 4096, 4097, 9001, 3 * adam.CHUNK + 5, 300_001]
    shapes = [(n,) for n in ns]
    if case == "ragged":
        args = adam_inputs(cuda, shapes)
    elif case == "misaligned":
        args = adam_inputs(cuda, shapes, [i % 4 for i in range(len(ns))])
    elif case == "aligned_unlike":
        p, g, m, v = adam_inputs(cuda, shapes)
        g = [torch.cat([t.new_zeros(1), t])[1:] for t in g]  # one float off
        args = p, g, m, v
    elif case == "channels_last":
        shapes = [(64, 3, 3, 3), (128, 64, 4, 4), (3, 64, 3, 3), (256, 256, 3, 3), (64,)]
        args = adam_inputs(cuda, shapes, channels_last=(0, 1, 2, 3))
    else:
        shapes = [((i * 37) % 301 + 1,) for i in range(adam.TABLE_LEAVES + 90)]
        args = adam_inputs(cuda, shapes, [i % 4 for i in range(len(shapes))])
    launches = adam_against_plain(cuda, *args, b1=0.5)
    assert launches == -(-len(shapes) // adam.TABLE_LEAVES)


def adam_bf16_against_plain(cuda, p, g, m, v, b1=0.9):
    """The bfloat16-moment form (m and v of the inputs rounded to bfloat16)
    against the plain version leaf by leaf, bit for bit; returns the
    launches of that form, and checks the float32 form launched none."""
    m, v = ([t.to(torch.bfloat16) for t in ts] for ts in (m, v))
    alpha = adam.adam_alpha(torch.tensor(2, device=cuda), 1e-3, b1, 0.999)
    pk, mk, vk = ([t.clone() for t in ts] for ts in (p, m, v))
    before, f32_before = adam.BF16_LAUNCHES["adam_bf16"], adam.LAUNCHES["adam"]
    adam.adam_kernel(adam.LeafTable(pk, mk, vk), g, alpha, b1, 0.999)
    launches = adam.BF16_LAUNCHES["adam_bf16"] - before
    assert adam.LAUNCHES["adam"] == f32_before
    adam.adam_plain(p, g, m, v, alpha, b1, 0.999)
    for a, b in zip(pk, p):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for a, b in zip(mk + vk, m + v):
        assert a.dtype == torch.bfloat16 and torch.equal(a.view(torch.int16), b.view(torch.int16))
    return launches


@pytest.mark.parametrize("case", ["ragged", "misaligned", "moments_8_bytes_off",
                                  "aligned_unlike", "channels_last", "longer_than_a_table"])
def test_adam_bf16_moments_equal_plain(cuda, case):
    """The bfloat16-moment form over ragged leaves, views at odd offsets,
    moments 8 bytes past p's 16-byte phase (a body for bfloat16, none for
    float32), moments at another element phase than p (scalar), channels_last
    conv weights, and more leaves than one table holds."""
    ns = [1, 2, 3, 4, 5, 7, 4095, 4096, 4097, 9001, 3 * adam.CHUNK + 5, 300_001]
    shapes = [(n,) for n in ns]
    if case == "ragged":
        p, g, m, v = adam_inputs(cuda, shapes)
    elif case == "misaligned":
        p, g, m, v = adam_inputs(cuda, shapes, [i % 4 for i in range(len(ns))])
    elif case in ("moments_8_bytes_off", "aligned_unlike"):
        p, g, m, v = adam_inputs(cuda, shapes)
        pad = 4 if case == "moments_8_bytes_off" else 1  # bfloat16 elements
        m, v = ([torch.cat([t.new_zeros(pad), t]).to(torch.bfloat16)[pad:] for t in ts]
                for ts in (m, v))
    elif case == "channels_last":
        shapes = [(64, 3, 3, 3), (128, 64, 4, 4), (3, 64, 3, 3), (256, 256, 3, 3), (64,)]
        p, g, m, v = adam_inputs(cuda, shapes, channels_last=(0, 1, 2, 3))
    else:
        shapes = [((i * 37) % 301 + 1,) for i in range(adam.TABLE_LEAVES + 90)]
        p, g, m, v = adam_inputs(cuda, shapes, [i % 4 for i in range(len(shapes))])
    launches = adam_bf16_against_plain(cuda, p, g, m, v, b1=0.5)
    assert launches == -(-len(shapes) // adam.TABLE_LEAVES)


def test_adam_bf16_table_refuses_mixed_moments(cuda):
    p, g, m, v = adam_inputs(cuda, [(5,), (7,)])
    with pytest.raises(ValueError, match="bfloat16"):
        adam.LeafTable(p, [t.to(torch.bfloat16) for t in m], v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        adam.LeafTable(p, [t.half() for t in m], [t.half() for t in v])


def test_adam_kernel_is_deterministic(cuda):
    """Two calls on the same inputs give the same bits."""
    p, g, m, v = adam_inputs(cuda, [(4097,), (128, 64, 4, 4), (3,)], channels_last=(1,))
    alpha = adam.adam_alpha(torch.tensor(5, device=cuda), 2e-4, 0.9, 0.999)
    out = []
    for _ in range(2):
        pk, mk, vk = ([t.clone() for t in ts] for ts in (p, m, v))
        adam.adam_kernel(adam.LeafTable(pk, mk, vk), g, alpha, 0.9, 0.999)
        out.append(pk + mk + vk)
    for a, b in zip(*out):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_adam_kernel_refuses_mismatched_grads(cuda):
    """The kernel wrapper raises on a g of other strides, dtype or device
    (and on a p, m, v of other layouts), and launches nothing."""
    p, g, m, v = adam_inputs(cuda, [(8, 4, 3, 3), (5,)], channels_last=(0,))
    table = adam.LeafTable(p, m, v)
    alpha = adam.adam_alpha(torch.tensor(1, device=cuda), 1e-3, 0.9, 0.999)
    before = adam.LAUNCHES["adam"]
    with pytest.raises(ValueError, match="strides"):
        adam.adam_kernel(table, [g[0].contiguous(), g[1]], alpha, 0.9, 0.999)
    with pytest.raises(ValueError, match="float32"):
        adam.adam_kernel(table, [g[0], g[1].double()], alpha, 0.9, 0.999)
    with pytest.raises(ValueError, match="float32"):
        adam.adam_kernel(table, [g[0], g[1].cpu()], alpha, 0.9, 0.999)
    with pytest.raises(ValueError, match="strides"):
        adam.LeafTable(p, [m[0].contiguous(), m[1]], v)
    assert adam.LAUNCHES["adam"] == before


def test_adam_apply_copies_a_grad_in_another_layout(cuda):
    """adam_apply brings a g whose memory order differs from p's to p's
    layout (one copy, counted), then one launch; a g that differs only in
    the stride of a size-1 dimension is taken as it is."""
    p, g, m, v = adam_inputs(cuda, [(8, 4, 3, 3), (16, 32, 1, 1)], channels_last=(0, 1))
    # (16, 32, 1, 1): strides that differ only where the size is 1
    grads = [g[0].contiguous(), g[1].as_strided(g[1].shape, (32, 1, 32, 32))]
    count = torch.zeros((), dtype=torch.int64, device=cuda)
    pp, mp, vp = ([t.clone() for t in ts] for ts in (p, m, v))
    copies, launches = adam.GRAD_COPIES["adam"], adam.LAUNCHES["adam"]
    adam.adam_apply(p, grads, m, v, count, 1e-3)
    assert adam.GRAD_COPIES["adam"] == copies + 1
    assert adam.LAUNCHES["adam"] == launches + 1
    adam.adam_plain(pp, grads, mp, vp, adam.adam_alpha(count, 1e-3, 0.9, 0.999), 0.9, 0.999)
    for a, b in zip(p + m + v, pp + mp + vp):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_adam_kernel_refuses_a_bad_plan(cuda):
    """The entry point checks the table: a body that does not start on a
    16-byte boundary is a CUDA invalid-value error, and nothing runs."""
    p, g, m, v = adam_inputs(cuda, [(4097,)])
    table = adam.LeafTable(p, m, v)
    (group, t), = table.launches
    t.body_begin[0], t.body_end[0] = 1, 4093
    alpha = adam.adam_alpha(torch.tensor(1, device=cuda), 1e-3, 0.9, 0.999)
    before = [x.clone() for x in p]
    with pytest.raises(RuntimeError, match="invalid argument"):
        adam.adam_kernel(table, g, alpha, 0.9, 0.999)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(p, before))


def test_adam_step_states_take_one_launch_per_apply(cuda):
    """A small SNDCGAN step on the card: G once and D twice, one Adam launch
    each, and no gradient copied to its parameter's layout."""
    cfg = steplib.SNDCGANTrainConfig(
        model=SNDCGANConfig(image_size=(16, 24, 3), base_width=16, spectral_norm=True),
        batch_size=4, loss="hinge")
    state = steplib.init_state(cfg, cuda)
    batch = torch.randint(0, 256, (4, 16, 24, 3), device=cuda, dtype=torch.uint8)
    step = steplib.make_train_step(cfg)
    launches, copies = adam.LAUNCHES["adam"], adam.GRAD_COPIES["adam"]
    step(state, batch)
    torch.cuda.synchronize()
    assert adam.LAUNCHES["adam"] == launches + 3
    assert adam.GRAD_COPIES["adam"] == copies


def test_small_step_on_card_matches_cpu(cuda):
    """Two float32 steps (TF32 off) from the same weights, z and key words:
    the card's step (kernels, cuDNN) within 1e-3 of the CPU's (plain)."""
    cfg = steplib.SNDCGANTrainConfig(
        model=SNDCGANConfig(image_size=(16, 24, 3), base_width=16, spectral_norm=True),
        batch_size=4, loss="hinge")
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    batch = torch.randint(0, 256, (4, 16, 24, 3), generator=gen, dtype=torch.uint8)
    z = torch.rand((4, 128), generator=gen) * 2 - 1
    kw = torch.randint(0, 2**32, (steplib.N_SITES, 2), generator=gen)
    out = []
    for dev in (torch.device("cpu"), cuda):
        state = steplib.init_state(cfg, dev)
        step = steplib.make_train_step(cfg)
        for _ in range(2):
            state, m = step(state, batch.to(dev), z.to(dev), kw.to(dev))
        out.append(({k: float(v) for k, v in m.items()},
                    [p.detach().cpu() for p in state.gen.parameters()]))
    (m_cpu, p_cpu), (m_gpu, p_gpu) = out
    for k in m_cpu:
        assert m_gpu[k] == pytest.approx(m_cpu[k], rel=1e-3, abs=1e-4), k
    for a, b in zip(p_gpu, p_cpu):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


def assert_in_close(got, want, tol, terms=128):
    """Within rtol `tol` and atol `tol` * sqrt(terms / 128) (a sum of
    `terms` float32 values), plus one bf16 ulp for a bf16 output."""
    ulp = 2.0**-7 if got.dtype == torch.bfloat16 else 0.0
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = tol * max(1.0, (terms / 128) ** 0.5) + (tol + ulp) * want.abs()
    assert bool((err <= bound).all()), f"max excess {(err - bound).max().item()}"


def in_inputs(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    c = shape[1]
    x = (2.0 + 3.0 * torch.randn(shape, generator=gen, device=cuda)).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    dy = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    dy = dy.contiguous(memory_format=torch.channels_last)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device=cuda)
    beta = 0.1 * torch.randn(c, generator=gen, device=cuda)
    return x, dy, gamma, beta


def check_instance_norm(x, dy, gamma, beta, relu, fwd_plan=None, bwd_plan=None):
    """Both kernels against their plain versions, one launch each."""
    before = dict(inorm.LAUNCHES)
    y, mean, rstd = inorm.in_fwd_kernel(x, gamma, beta, 1e-3, relu, fwd_plan)
    yp, meanp, rstdp = inorm.in_fwd_plain(x, gamma, beta, 1e-3, relu)
    assert y.dtype == x.dtype and y.is_contiguous(memory_format=torch.channels_last)
    assert_in_close(y, yp, 2e-5)
    if relu:
        assert torch.equal(y == 0, yp == 0), "ReLU zero pattern differs"
    assert_in_close(mean, meanp, 1e-5)
    assert_in_close(rstd, rstdp, 1e-5)
    dx, dg, db = inorm.in_bwd_kernel(x, dy, gamma, beta, meanp, rstdp, relu, bwd_plan)
    dxp, dgp, dbp = inorm.in_bwd_plain(x, dy, gamma, beta, meanp, rstdp, relu)
    assert dx.dtype == x.dtype and dg.dtype == db.dtype == torch.float32
    assert dg.shape == db.shape == gamma.shape
    assert_in_close(dx, dxp, 2e-5)
    n = x.shape[0] * x.shape[2] * x.shape[3]
    assert_in_close(dg, dgp, 2e-5, n)
    assert_in_close(db, dbp, 2e-5, n)
    assert inorm.LAUNCHES["instance_norm_fwd"] == before["instance_norm_fwd"] + 1
    assert inorm.LAUNCHES["instance_norm_bwd"] == before["instance_norm_bwd"] + 1


# (4, 64, 128, 128): 16-CTA clusters, the backward re-reading from L2;
# (4, 3, 128, 128) and (2, 6, 17, 33): the scalar path (C not a multiple of
# 4); (1, 64, 129, 131): a row split that leaves the last CTA short.
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (4, 64, 17, 33), (4, 256, 32, 32),
                                   (3, 512, 6, 6), (2, 40, 9, 11), (4, 64, 128, 128),
                                   (4, 3, 128, 128), (1, 64, 129, 131), (2, 6, 17, 33)])
def test_instance_norm_kernels_match_plain(cuda, shape, dtype, relu):
    check_instance_norm(*in_inputs(cuda, shape, dtype), relu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("overrides", [
    dict(held=0), dict(held=1), dict(channel_block=16, cluster=16), dict(cluster=1),
    dict(channel_block=16, cluster=8, held=0)])
def test_instance_norm_plan_variants_match_plain(cuda, dtype, overrides):
    """Plans the default does not pick at this shape: the L2 re-read path in
    both kernels, the backward holding x but not dy, narrower channel
    blocks, a cluster of one."""
    shape = (3, 64, 40, 45)
    b, c, h, w = shape
    fwd = inorm.launch_plan(b, c, h, w, dtype, 1, **overrides)
    bwd = inorm.launch_plan(b, c, h, w, dtype, 2, **overrides)
    check_instance_norm(*in_inputs(cuda, shape, dtype), True, fwd, bwd)


@pytest.mark.parametrize("shape", [(4, 64, 128, 128), (4, 256, 32, 32), (4, 3, 128, 128)])
def test_instance_norm_kernels_are_deterministic(cuda, shape):
    """Two calls on the same inputs give the same bits: fixed summation
    orders, and dgamma/dbeta summed over the batch without float atomics."""
    x, dy, gamma, beta = in_inputs(cuda, shape, torch.float32)
    _, mean, rstd = inorm.in_fwd_plain(x, gamma, beta, 1e-3, True)
    first = inorm.in_fwd_kernel(x, gamma, beta, 1e-3, True) + inorm.in_bwd_kernel(
        x, dy, gamma, beta, mean, rstd, True)
    second = inorm.in_fwd_kernel(x, gamma, beta, 1e-3, True) + inorm.in_bwd_kernel(
        x, dy, gamma, beta, mean, rstd, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# The split pair of an H-partitioned map, its shards simulated in one
# process: (4, 64, 24, 33) the 16-byte path, (2, 6, 24, 33) and (1, 3, 12, 5)
# the scalar path (C not a multiple of 4), with 1 to 4 row blocks.
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 64, 24, 33), (2, 6, 24, 33), (1, 3, 12, 5)])
def test_split_instance_norm_kernels_match_plain(cuda, shape, dtype, relu, shards):
    """Each split kernel against its plain version on the same inputs, and
    the shards together against the single-pass kernels on the whole map."""
    x, dy, gamma, beta = in_inputs(cuda, shape, dtype)
    xs = [t.contiguous(memory_format=torch.channels_last) for t in x.chunk(shards, 2)]
    dys = [t.contiguous(memory_format=torch.channels_last) for t in dy.chunk(shards, 2)]
    before = dict(inorm.SPLIT_LAUNCHES)
    parts = []
    for xb in xs:
        got = inorm.in_fwd_partial_kernel(xb)  # (k, B, C, 2): the plan's chunks
        assert_in_close(got, inorm.in_fwd_partial_plain(xb, got.shape[0]), 2e-5,
                        -(-xb.shape[2] * xb.shape[3] // got.shape[0]))
        parts.append(got)
    parts = torch.stack(parts)
    ys = []
    for xb in xs:
        y, mean, rstd = inorm.in_fwd_apply_kernel(xb, parts, gamma, beta, 1e-3, relu)
        yp, meanp, rstdp = inorm.in_fwd_apply_plain(xb, parts, gamma, beta, 1e-3, relu)
        assert_in_close(y, yp, 2e-5)
        assert_in_close(mean, meanp, 1e-5)
        assert_in_close(rstd, rstdp, 1e-5)
        ys.append(y)
    sums, dgs, dbs = 0, 0, 0
    for xb, db in zip(xs, dys):
        sm, dg, dbt = inorm.in_bwd_partial_kernel(xb, db, gamma, beta, mean, rstd, relu)
        smp, dgp, dbp = inorm.in_bwd_partial_plain(xb, db, gamma, beta, mean, rstd, relu)
        n = xb.shape[2] * xb.shape[3]
        assert_in_close(sm, smp, 2e-5, n)
        assert_in_close(dg, dgp, 2e-5, xb.shape[0] * n)
        assert_in_close(dbt, dbp, 2e-5, xb.shape[0] * n)
        sums, dgs, dbs = sums + sm, dgs + dg, dbs + dbt
    total = shape[2] * shape[3]
    dxs = []
    for xb, db in zip(xs, dys):
        dx = inorm.in_bwd_apply_kernel(xb, db, sums, gamma, beta, mean, rstd, relu, total)
        assert_in_close(dx, inorm.in_bwd_apply_plain(xb, db, sums, gamma, beta, mean, rstd,
                                                     relu, total), 2e-5)
        dxs.append(dx)
    yw, meanw, rstdw = inorm.in_fwd_kernel(x, gamma, beta, 1e-3, relu)
    dxw, dgw, dbw = inorm.in_bwd_kernel(x, dy, gamma, beta, mean, rstd, relu)
    assert_in_close(torch.cat(ys, 2), yw, 2e-5)
    assert_in_close(mean, meanw, 1e-5)
    assert_in_close(rstd, rstdw, 1e-5)
    assert_in_close(torch.cat(dxs, 2), dxw, 2e-5)
    n = shape[0] * total
    assert_in_close(dgs, dgw, 2e-5, n)
    assert_in_close(dbs, dbw, 2e-5, n)
    assert inorm.SPLIT_LAUNCHES == {k: v + shards for k, v in before.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 64, 16, 32), (4, 3, 16, 32), (2, 40, 9, 11)])
def test_split_instance_norm_on_one_shard_is_the_single_pass_pair(cuda, shape, dtype):
    """One shard: the backward partial takes the single-pass backward's CTAs
    and orders and the backward apply its last pass's expression, so the
    backward is bit-equal; the forward partial's chunks, merged by Chan's
    formula, sum in another order than the single-pass forward's cluster,
    so y, mean and rstd are held within 1e-6 of each plane's scale (max
    |y|, max |x|, rstd; y also to one bf16 ulp of |y|)."""
    x, dy, gamma, beta = in_inputs(cuda, shape, dtype)
    ulp = 2.0**-7 if dtype == torch.bfloat16 else 0.0
    y, mean, rstd = inorm.in_fwd_kernel(x, gamma, beta, 1e-3, True)
    dx, dg, db = inorm.in_bwd_kernel(x, dy, gamma, beta, mean, rstd, True)
    y1, mean1, rstd1 = inorm.in_fwd_apply_kernel(x, inorm.in_fwd_partial_kernel(x)[None],
                                                 gamma, beta, 1e-3, True)
    for got, want, scale, rel in ((y1, y, y.abs().amax((2, 3), keepdim=True), ulp),
                                  (mean1, mean, x.abs().amax((2, 3)), 0.0),
                                  (rstd1, rstd, rstd, 0.0)):
        got, want, scale = got.float(), want.float(), scale.float()
        assert bool(((got - want).abs() <= 1e-6 * scale + rel * want.abs()).all())
    sums, dg1, db1 = inorm.in_bwd_partial_kernel(x, dy, gamma, beta, mean, rstd, True)
    dx1 = inorm.in_bwd_apply_kernel(x, dy, sums, gamma, beta, mean, rstd, True,
                                    shape[2] * shape[3])
    for a, b in ((dx1, dx), (dg1, dg), (db1, db)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("depth", [1, 4, 8, 32])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 37, 45), (2, 3, 41, 43)])
def test_split_applies_match_plain_at_every_depth(cuda, shape, dtype, relu, depth):
    """The applies at plans of 1 to 32 rows a thread (fwd_apply_plan /
    bwd_apply_plan's `depth`: ragged last chunks; the forward's shallow
    kernel (up to 4 rows) and its deep one; past the kernels' rows in
    flight (16 forward, 4 backward), so that later rows load batch by
    batch) against their plain versions, each from 2 shards' partials, and
    each twice giving the same bits."""
    x, dy, gamma, beta = in_inputs(cuda, shape, dtype)
    b, c, h, w = shape
    parts = torch.stack([inorm.in_fwd_partial_kernel(x)] * 2)
    fwd = inorm.fwd_apply_plan(b, c, h, w, dtype, depth)
    y, mean, rstd = inorm.in_fwd_apply_kernel(x, parts, gamma, beta, 1e-3, relu, fwd)
    yp, meanp, rstdp = inorm.in_fwd_apply_plain(x, parts, gamma, beta, 1e-3, relu)
    assert_in_close(y, yp, 2e-5)
    assert_in_close(mean, meanp, 1e-5)
    assert_in_close(rstd, rstdp, 1e-5)
    again = inorm.in_fwd_apply_kernel(x, parts, gamma, beta, 1e-3, relu, fwd)
    assert all(torch.equal(u, v) for u, v in zip((y, mean, rstd), again))
    sums = inorm.in_bwd_partial_kernel(x, dy, gamma, beta, mean, rstd, relu)[0] * 2
    bwd = inorm.bwd_apply_plan(b, c, h, w, dtype, depth)
    dx = inorm.in_bwd_apply_kernel(x, dy, sums, gamma, beta, mean, rstd, relu, 2 * h * w, bwd)
    assert_in_close(dx, inorm.in_bwd_apply_plain(x, dy, sums, gamma, beta, mean, rstd, relu,
                                                 2 * h * w), 2e-5)
    assert torch.equal(dx, inorm.in_bwd_apply_kernel(x, dy, sums, gamma, beta, mean, rstd,
                                                     relu, 2 * h * w, bwd))


# Partials past the forward apply's registers (merge_rounds > 1, the
# pairwise fallback): 2 shards of k chunks each, k a count that
# chunk_counts keeps (every chunk of ceil(h*W / k) rows but the last).
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k", [((2, 64, 12, 33), 40), ((2, 6, 12, 33), 132)])
def test_split_forward_apply_merges_past_its_registers(cuda, shape, k, dtype, relu):
    x, dy, gamma, beta = in_inputs(cuda, shape, dtype)
    b, c, h, w = shape
    part = inorm.in_fwd_partial_plain(x, k).float()
    assert part.shape[0] == k
    parts = torch.stack([part, inorm.in_fwd_partial_plain(x.flip(2), k).float()])
    cb = inorm.fwd_apply_plan(b, c, h, w, dtype).channel_block
    assert inorm.merge_rounds(cb, 2 * k) > 1
    y, mean, rstd = inorm.in_fwd_apply_kernel(x, parts, gamma, beta, 1e-3, relu)
    yp, meanp, rstdp = inorm.in_fwd_apply_plain(x, parts, gamma, beta, 1e-3, relu)
    assert_in_close(y, yp, 2e-5)
    assert_in_close(mean, meanp, 1e-5)
    assert_in_close(rstd, rstdp, 1e-5)
    again = inorm.in_fwd_apply_kernel(x, parts, gamma, beta, 1e-3, relu)
    assert all(torch.equal(u, v) for u, v in zip((y, mean, rstd), again))


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("shape", [(4, 64, 16, 32), (2, 40, 9, 11), (2, 3, 10, 7)])
def test_library_calls_beside_the_split_applies_match_plain(cuda, shape, shards):
    """The PyTorch calls that tools/split_times.py times beside the applies
    (never used by the port), at ReLU off, against the plain versions within
    the kernels' tolerances: batch_norm_gather_stats_with_counts then
    batch_norm_elemt (y, mean, invstd), batch_norm_backward_elemt (dx)."""
    x, dy, gamma, beta = in_inputs(cuda, shape, torch.float32)
    b, c = shape[:2]
    calls = split_times.split_calls(inorm, x, dy, gamma, beta, shards, plain=True)
    y, mean, invstd = calls["instance_norm_fwd_apply"][2]()
    yp, meanp, rstdp = calls["instance_norm_fwd_apply"][1]()
    assert_in_close(y.view(shape), yp, 2e-5)
    assert_in_close(mean.view(b, c), meanp, 1e-5)
    assert_in_close(invstd.view(b, c), rstdp, 1e-5)
    _, plain_bwd, library_bwd = calls["instance_norm_bwd_apply"]
    assert_in_close(library_bwd().view(shape), plain_bwd(), 2e-5)


# The generator's norm maps as half-height shards of 2 spatial ranks
# (chip_smoke.IN_SPLIT_SHAPES): the partial kernels' own plans there.
SPLIT_SHAPES = [(4, 64, 64, 128), (4, 128, 32, 64), (4, 256, 16, 32), (4, 3, 64, 128)]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_partial_kernels_match_plain_at_the_generator_shards(cuda, shape, dtype, relu):
    """The forward partial against the plain partial cut into the same
    chunks (each chunk a sum of at most ceil(h*W / k) terms), the backward
    partial against its plain version (sums of h*W terms, dgamma/dbeta of
    B*h*W), and each twice on the same inputs giving the same bits."""
    x, dy, gamma, beta = in_inputs(cuda, shape, dtype)
    b, c, h, w = shape
    got = inorm.in_fwd_partial_kernel(x)
    k = inorm.fwd_partial_plan(b, c, h, w, dtype).chunks
    assert got.shape == (k, b, c, 2)
    assert_in_close(got, inorm.in_fwd_partial_plain(x, k), 2e-5, -(-h * w // k))
    assert torch.equal(got, inorm.in_fwd_partial_kernel(x))
    _, mean, rstd = inorm.in_fwd_apply_plain(x, got[None], gamma, beta, 1e-3, relu)
    sums, dg, db = inorm.in_bwd_partial_kernel(x, dy, gamma, beta, mean, rstd, relu)
    sp, dgp, dbp = inorm.in_bwd_partial_plain(x, dy, gamma, beta, mean, rstd, relu)
    assert_in_close(sums, sp, 2e-5, h * w)
    assert_in_close(dg, dgp, 2e-5, b * h * w)
    assert_in_close(db, dbp, 2e-5, b * h * w)
    again = inorm.in_bwd_partial_kernel(x, dy, gamma, beta, mean, rstd, relu)
    assert all(torch.equal(u, v) for u, v in zip((sums, dg, db), again))


def test_instance_norm_kernel_refuses_a_bad_plan(cuda):
    """The kernels check the plan they are given: a cluster that leaves a
    CTA without rows is a CUDA invalid-value error, and nothing is counted."""
    x, dy, gamma, beta = in_inputs(cuda, (2, 64, 5, 5), torch.float32)
    plan = inorm.launch_plan(2, 64, 5, 5, torch.float32, 1)
    bad = dataclasses.replace(plan, cluster=16, rows=2)
    before = dict(inorm.LAUNCHES)
    with pytest.raises(RuntimeError, match="invalid argument"):
        inorm.in_fwd_kernel(x, gamma, beta, 1e-3, False, bad)
    assert inorm.LAUNCHES == before


def test_instance_norm_autograd_takes_any_layout(cuda):
    """The wrapper brings an NCHW input and gradient to channels_last; the
    kernel entry points refuse them."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 8, 6, 5, generator=gen, device=cuda).requires_grad_(True)
    gamma = torch.ones(8, device=cuda, requires_grad=True)
    beta = torch.zeros(8, device=cuda, requires_grad=True)
    y = inorm.instance_norm(x, gamma, beta, relu=True)
    g = torch.randn(2, 8, 6, 5, generator=gen, device=cuda)
    y.backward(g)
    yp, mean, rstd = inorm.in_fwd_plain(x.detach(), gamma.detach(), beta.detach(), 1e-3, True)
    dxp, dgp, dbp = inorm.in_bwd_plain(x.detach(), g, gamma.detach(), beta.detach(),
                                       mean, rstd, True)
    assert_in_close(y, yp, 2e-5)
    assert_in_close(x.grad, dxp, 2e-5)
    assert_in_close(gamma.grad, dgp, 2e-5)
    assert_in_close(beta.grad, dbp, 2e-5)
    with pytest.raises(ValueError, match="channels_last"):
        inorm.in_fwd_kernel(x.detach(), gamma.detach(), beta.detach(), 1e-3, False)


def test_small_cyclegan_step_on_card_matches_cpu(cuda):
    """Two float32 steps of the tiny CycleGAN (TF32 off) from the same
    weights and batches: card (kernels, cuDNN) within 1e-3 of the CPU."""
    cfg = cyclegan_step.CycleGANTrainConfig(
        model=CycleGANConfig(image_size=(96, 96, 3), base_width=8, n_res_blocks=2))
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    batches = torch.randint(0, 256, (2, 2, 1, 96, 96, 3), generator=gen, dtype=torch.uint8)
    out = []
    for dev in (torch.device("cpu"), cuda):
        state = cyclegan_step.init_state(cfg, dev)
        step = cyclegan_step.make_train_step(cfg)
        for bx, by in batches:
            state, m = step(state, bx.to(dev), by.to(dev))
        out.append(({k: float(v) for k, v in m.items()},
                    [p.detach().cpu() for p in state.gen_g.parameters()]))
    (m_cpu, p_cpu), (m_gpu, p_gpu) = out
    for k in m_cpu:
        assert m_gpu[k] == pytest.approx(m_cpu[k], rel=1e-3, abs=1e-4), k
    for a, b in zip(p_gpu, p_cpu):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
