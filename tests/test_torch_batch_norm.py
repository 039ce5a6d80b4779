"""The BatchNorm + activation of ops/batch_norm.py on the CPU.

1. The plain version that `nn.layers.BatchNorm` now calls (with the
   activation the models pass as `slope`) equals the layer's former
   arithmetic followed by the models' former `torch.relu` / `F.leaky_relu`
   bit for bit: the output, the gradients of x, scale and bias, and the
   running statistics, at the SNDCGAN generator's four channel counts (the
   stem's 294,912 features as a (B, features) input, the maps' 256, 128 and
   64 channels_last), in bfloat16, float32 and float64, with no activation,
   ReLU and LeakyReLU(0.2), in train mode, inference mode, and inference
   mode under gradients (`quirk_eval_bn`).
2. The kernels' algebra, written out in float64 torch ops as the source
   computes it (sums, then an apply from them; the backward's [sum g, sum
   g xhat] and its apply), against autograd of the plain version.
3. The second derivative's route (the WGAN-GP penalty through an
   inference-mode critic): the autograd wrapper and its differentiable
   inference backward, with the kernels replaced by float64 torch ops of
   the source's arithmetic, against autograd's double backward of the
   plain version; a penalty that reads dscale (no kernel) raises.
4. `launch_plan`: grid, vector width, chunk count and ticket layout for C
   from 3 to 294,912 and rows from 128 to 4.7M, the SNDCGAN sites' plans,
   its refusals and the timing tool's variants (`bn_times.plan_variant`);
   the wrappers' refusals of CPU tensors.
5. `bn_times.differences`, the bound the card's tests hold the kernels to:
   a (2, C) input, whose channels' fast variance cancels, passes with
   float32 statistics taken in another order, and a planted fault in the
   variance fails.

The kernels themselves run on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py). No JAX here.
"""

import itertools

import pytest
import torch
import torch.nn.functional as F

from imagegeneration_tpu_torch.nn import layers as tl
from imagegeneration_tpu_torch.ops import batch_norm as bn
from imagegeneration_tpu_torch.tools import bn_times

torch.set_num_threads(1)

BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64
# The SNDCGAN generator's sites at batch 2 with small maps: the stem's
# (B, 294,912) input, then up0, up1, up2 (C 256, 128, 64).
SITES = {"stem": (2, 294912), "up0": (2, 256, 3, 4), "up1": (2, 128, 4, 6),
         "up2": (2, 64, 5, 8)}
SLOPES = {"none": None, "relu": 0.0, "leaky": 0.2}
MODES = ("train", "inference", "quirk_eval_bn")


def _former(mod: tl.BatchNorm, x: torch.Tensor, use_running_average: bool,
            slope: float | None) -> torch.Tensor:
    """The layer's forward before the kernels (its `_moments` and forward,
    expression for expression), then the models' activation."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct)
    shape = [1, -1] + [1] * (x.dim() - 2)
    if use_running_average:
        mean, var = mod.mean, mod.var
    else:
        dims = [d for d in range(xf.dim()) if d != 1]
        mean, mean2 = xf.mean(dims), (xf * xf).mean(dims)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            m = mod.momentum
            mod.mean.copy_(m * mod.mean + (1.0 - m) * mean)
            mod.var.copy_(m * mod.var + (1.0 - m) * var)
    mul = torch.rsqrt(var + mod.epsilon) * mod.scale
    y = ((xf - mean.view(shape)) * mul.view(shape) + mod.bias.view(shape)).to(mod.dtype or ct)
    if slope is None:
        return y
    return torch.relu(y) if slope == 0.0 else F.leaky_relu(y, slope)


def _layer(c: int, dtype: torch.dtype, seed: int) -> tl.BatchNorm:
    gen = torch.Generator().manual_seed(seed)
    mod = tl.BatchNorm(c, dtype=dtype)
    with torch.no_grad():
        mod.scale.uniform_(0.5, 1.5, generator=gen)
        mod.bias.normal_(0.0, 0.5, generator=gen)
        mod.mean.normal_(0.0, 0.5, generator=gen)
        mod.var.uniform_(0.5, 2.0, generator=gen)
    return mod


def _inputs(shape: tuple, dtype: torch.dtype, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    gen = torch.Generator().manual_seed(seed)
    x = (0.7 + 1.3 * torch.randn(shape, generator=gen, dtype=F64)).to(dtype)
    g = torch.randn(shape, generator=gen, dtype=F64).to(dtype)
    if len(shape) == 4:
        x = x.contiguous(memory_format=torch.channels_last)
        g = g.contiguous(memory_format=torch.channels_last)
    return x, g


def _run(mod, fn, x, g, use_running_average, grads):
    xg = x.detach().clone().requires_grad_(grads)
    y = fn(mod, xg, use_running_average)
    if not grads:
        return y, None, None, None
    y.backward(g)
    return y, xg.grad, mod.scale.grad, mod.bias.grad


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("slope", list(SLOPES), ids=list(SLOPES))
@pytest.mark.parametrize("dtype", [BF16, F32, F64], ids=["bf16", "f32", "f64"])
@pytest.mark.parametrize("site", list(SITES))
def test_plain_equals_the_former_layer_and_activation(site, dtype, slope, mode):
    shape = SITES[site]
    c = shape[1]
    seed = sum(shape) + len(mode)
    x, g = _inputs(shape, dtype, seed)
    new, old = _layer(c, dtype, seed), _layer(c, dtype, seed)
    s = SLOPES[slope]
    use_running_average = mode != "train"
    grads = mode != "inference"
    with torch.set_grad_enabled(grads):
        got = _run(new, lambda m, t, u: m(t, u, s), x, g, use_running_average, grads)
        want = _run(old, lambda m, t, u: _former(m, t, u, s), x, g, use_running_average,
                    grads)
    assert got[0].dtype == dtype and got[0].shape == x.shape
    if x.dim() == 4:
        assert got[0].is_contiguous(memory_format=torch.channels_last)
    for a, b in zip(got, want):
        if b is not None:
            assert torch.equal(a, b)
    assert torch.equal(new.mean, old.mean) and torch.equal(new.var, old.var)
    if mode == "train":
        assert not torch.equal(new.mean, _layer(c, dtype, seed).mean)


# ------------------------------------------------------ the kernels' algebra
def _kernel_math(x, dy, scale, bias, rmean, rvar, train, slope, momentum=0.99, eps=1e-3):
    """The source's arithmetic in float64 torch ops over a (rows, C) matrix:
    (y, dx, dscale, dbias, running mean, running var)."""
    n = x.shape[0]
    if train:
        s1, s2 = x.sum(0), (x * x).sum(0)  # the statistics pass
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        rmean, rvar = momentum * rmean + (1 - momentum) * mean, momentum * rvar + (1 - momentum) * var
    else:
        mean, var = rmean, rvar
    rstd = torch.rsqrt(var + eps)
    mul = rstd * scale
    z = (x - mean) * mul + bias
    act = slope is not None
    y = z if not act else torch.where(z > 0, z, z * slope)
    g = dy if not act else torch.where(z > 0, dy, dy * slope)  # the reduce pass
    xhat = (x - mean) * rstd
    sg, sgx = g.sum(0), (g * xhat).sum(0)
    dx = mul * (g - sg / n - xhat * sgx / n) if train else mul * g  # the apply back
    return y, dx, sgx, sg, rmean, rvar


@pytest.mark.parametrize("train", [True, False], ids=["train", "inference"])
@pytest.mark.parametrize("slope", list(SLOPES), ids=list(SLOPES))
@pytest.mark.parametrize("shape", [(6, 294912 // 64), (2, 64, 5, 8)], ids=["2d", "4d"])
def test_kernel_algebra_equals_autograd_of_plain(shape, slope, train):
    s = SLOPES[slope]
    x, dy = _inputs(shape, F64, 11)
    mod = _layer(shape[1], F64, 11)
    rmean, rvar = mod.mean.double().clone(), mod.var.double().clone()
    mod = mod.double()
    xg = x.detach().clone().requires_grad_(True)
    y = bn.bn_plain(xg, mod.scale, mod.bias, mod.mean, mod.var, not train, 0.99, 1e-3,
                    None, s)
    y.backward(dy)
    rows = (lambda t: t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])) if x.dim() == 4 else (
        lambda t: t)
    with torch.no_grad():
        ky, kdx, kds, kdb, km, kv = _kernel_math(rows(x), rows(dy), mod.scale, mod.bias,
                                                 rmean, rvar, train, s)
    tol = dict(rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(ky, rows(y.detach()), **tol)
    torch.testing.assert_close(kdx, rows(xg.grad), **tol)
    torch.testing.assert_close(kds, mod.scale.grad, **tol)
    torch.testing.assert_close(kdb, mod.bias.grad, **tol)
    torch.testing.assert_close(km, mod.mean, **tol)
    torch.testing.assert_close(kv, mod.var, **tol)


# ---------------------------------------------- the second derivative's route
def _view(x):
    return [1, -1] + [1] * (x.dim() - 2)


def _masked(x, dy, scale, bias, mean, rstd, slope):
    """dy through the activation's mask, t rebuilt from x as the source does."""
    if slope is None:
        return dy
    v = _view(x)
    t = ((x - mean.view(v)) * (rstd * scale).view(v) + bias.view(v)).to(x.dtype)
    return torch.where(t > 0, dy, dy * slope)


def _fwd_apply(x, sums, n, scale, bias, rmean, rvar, momentum, eps, slope, plan=None):
    assert sums is None  # the inference form
    rstd = torch.rsqrt(rvar + eps)
    v = _view(x)
    y = (x - rmean.view(v)) * (rstd * scale).view(v) + bias.view(v)
    return bn.activation_plain(y, slope), rmean.clone(), rstd


def _bwd_reduce(x, dy, scale, bias, mean, rstd, slope, plan=None):
    g = _masked(x, dy, scale, bias, mean, rstd, slope)
    dims = [d for d in range(x.dim()) if d != 1]
    return torch.stack([g.sum(dims), (g * (x - mean.view(_view(x))) * rstd.view(_view(x)))
                        .sum(dims)])


def _bwd_apply(x, dy, sums, n, scale, bias, mean, rstd, slope, plan=None):
    assert sums is None  # the inference form
    return _masked(x, dy, scale, bias, mean, rstd, slope) * (rstd * scale).view(_view(x))


def _emulate_kernels(monkeypatch):
    monkeypatch.setattr(bn, "plan_for", lambda x: bn.launch_plan(*bn.matrix_shape(x), F32))
    monkeypatch.setattr(bn, "fwd_apply_kernel", _fwd_apply)
    monkeypatch.setattr(bn, "bwd_reduce_kernel", _bwd_reduce)
    monkeypatch.setattr(bn, "bwd_apply_kernel", _bwd_apply)


@pytest.mark.parametrize("slope", list(SLOPES), ids=list(SLOPES))
@pytest.mark.parametrize("shape", [(5, 32), (2, 16, 3, 4)], ids=["2d", "4d"])
def test_inference_backward_route_matches_double_backward(monkeypatch, shape, slope):
    """A gradient penalty through the inference form (the WGAN-GP's: it
    reads dx): the autograd wrapper (`_BatchNormAct`, whose backward is
    `_InferenceBackward`) with the kernels' arithmetic in float64 torch
    ops, against autograd of the plain version: dx and the penalty's
    gradients of x, dy, scale and bias."""
    _emulate_kernels(monkeypatch)
    s = SLOPES[slope]
    x, dy = _inputs(shape, F64, 5)
    mod = _layer(shape[1], F64, 5).double()
    results = []
    for route in ("autograd", "kernel_route"):
        mod.zero_grad()
        xg = x.detach().clone().requires_grad_(True)
        dyg = dy.detach().clone().requires_grad_(True)
        args = (mod.scale, mod.bias, mod.mean, mod.var)
        if route == "autograd":
            y = bn.bn_plain(xg, *args, True, 0.99, 1e-3, None, s)
        else:
            y = bn._BatchNormAct.apply(xg, *args, False, 0.99, 1e-3, s, None)
        (dx,) = torch.autograd.grad(y, xg, dyg, create_graph=True)
        p = ((dx * dx).sum() - 1.0) ** 2
        p.backward()
        results.append((dx.detach(), p.detach(),
                        *[torch.zeros_like(t) if t.grad is None else t.grad.clone()
                          for t in (xg, dyg, mod.scale, mod.bias)]))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    assert results[0][-2].abs().max() > 0  # the penalty reaches scale


def test_penalty_through_a_conv_runs_each_derivative_once(monkeypatch):
    """BatchNorm, then a conv, inference mode: the penalty's second pass
    reaches the norm's output with no gradient (the conv's double backward
    gives its input none), and the norm's backward then launches nothing:
    one forward apply, a reduce and an apply back for each derivative."""
    calls = {"fwd_apply": 0, "bwd_reduce": 0, "bwd_apply": 0}

    def counted(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return run

    _emulate_kernels(monkeypatch)
    for name, fn in (("fwd_apply", _fwd_apply), ("bwd_reduce", _bwd_reduce),
                     ("bwd_apply", _bwd_apply)):
        monkeypatch.setattr(bn, f"{name}_kernel", counted(name, fn))
    x, _ = _inputs((2, 16, 5, 6), F64, 9)
    mod = _layer(16, F64, 9).double()
    w = torch.randn(8, 16, 3, 3, dtype=F64, requires_grad=True)
    xg = x.detach().clone().requires_grad_(True)
    y = bn._BatchNormAct.apply(xg, mod.scale, mod.bias, mod.mean, mod.var, False, 0.99, 1e-3,
                               0.2, None)
    (g,) = torch.autograd.grad(F.conv2d(y, w).sum(), xg, create_graph=True)
    ((g * g).sum()).backward()
    assert calls == {"fwd_apply": 1, "bwd_reduce": 2, "bwd_apply": 2}
    assert w.grad.abs().max() > 0 and mod.scale.grad.abs().max() > 0


def test_inference_second_derivative_through_dscale_raises(monkeypatch):
    _emulate_kernels(monkeypatch)
    x, dy = _inputs((4, 8), F64, 7)
    mod = _layer(8, F64, 7).double()
    y = bn._BatchNormAct.apply(x.requires_grad_(True), mod.scale, mod.bias, mod.mean,
                               mod.var, False, 0.99, 1e-3, 0.0, None)
    dx, dscale = torch.autograd.grad(y, (x, mod.scale), dy, create_graph=True)
    with pytest.raises(RuntimeError, match="dscale or dbias has no kernel"):
        ((dx * dx).sum() + (dscale * dscale).sum()).backward()


def test_inference_backward_is_differentiable_twice(monkeypatch):
    _emulate_kernels(monkeypatch)
    x, dy = _inputs((4, 8), F64, 3)
    mod = _layer(8, F64, 3).double()
    xg, dyg = x.requires_grad_(True), dy.requires_grad_(True)
    rstd = torch.rsqrt(mod.var + 1e-3)
    dx, _, _ = bn._InferenceBackward.apply(xg, dyg, mod.scale, mod.bias, mod.mean, rstd, 0.2,
                                           bn.launch_plan(4, 8, F32))
    # dx is the first derivative: its backward is the second, a graph of it the third
    (d_dy,) = torch.autograd.grad((dx * dx).sum(), dyg, retain_graph=True)
    torch.testing.assert_close(d_dy, _bwd_apply(x, 2 * dx, None, 4, mod.scale, mod.bias,
                                                 mod.mean, rstd, 0.2), rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="differentiable twice"):
        torch.autograd.grad((dx * dx).sum(), dyg, create_graph=True)


# ------------------------------------------------------------- launch plan
ROWS = (128, 4096, 128 * 36 * 64, 128 * 72 * 128, 128 * 144 * 256)
CHANNELS = (3, 7, 64, 128, 256, 512, 1000, 294912)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("rows,c", list(itertools.product(ROWS, CHANNELS)))
def test_launch_plan_covers_the_matrix(rows, c, dtype):
    p = bn.launch_plan(rows, c, dtype)
    esize = 2 if dtype == BF16 else 4
    assert p.vec == (16 // esize if c % (16 // esize) == 0 else 1)
    assert p.lanes & (p.lanes - 1) == 0 and 1 <= p.lanes <= bn.THREADS
    line = bn.MAX_BLOCK_BYTES // (p.vec * esize) if p.vec > 1 else 32
    # one line of channels, or wider where a thread would walk few rows
    assert p.lanes <= line or rows < p.slots * 2 * bn.THREAD_ROWS
    assert p.slots * p.lanes == bn.THREADS and p.cb == p.lanes * p.vec
    width = c // p.vec
    assert p.blocks * p.lanes >= width > (p.blocks - 1) * p.lanes
    assert p.lanes < 2 * width or p.lanes == 1
    assert p.chunk_rows % p.slots == 0
    assert p.chunks * p.chunk_rows >= rows > (p.chunks - 1) * p.chunk_rows
    target = bn.H100_SXM_SMS * bn.CTAS_PER_SM
    if p.chunks > 1:  # chunks only up to the target, each thread with UNROLL rows
        assert p.ctas < target + p.blocks
        assert p.chunk_rows >= p.slots * bn.UNROLL
        assert (p.tickets, p.partial_floats) == (p.blocks, p.chunks * 2 * c)
    else:
        assert (p.tickets, p.partial_floats) == (0, 0)
    assert p.args() == [rows, c, p.vec, p.lanes, p.chunks, p.chunk_rows]


# bf16 plans at the SNDCGAN headline's sites (batch 128): (lanes, blocks,
# chunks, chunk rows).
HEADLINE_PLANS = {"stem": ((128, 294912), (64, 576, 1, 128)),
                  "up0": ((128 * 36 * 64, 256), (16, 2, 132, 2240)),
                  "up1": ((128 * 72 * 128, 128), (16, 1, 264, 4480)),
                  "up2": ((128 * 144 * 256, 64), (8, 1, 264, 17888))}


@pytest.mark.parametrize("site", list(HEADLINE_PLANS))
def test_launch_plan_at_the_sndcgan_sites(site):
    (rows, c), want = HEADLINE_PLANS[site]
    p = bn.launch_plan(rows, c, BF16)
    assert (p.lanes, p.blocks, p.chunks, p.chunk_rows) == want
    assert p.vec == 8 and p.cb == 8 * p.lanes
    # on a card of 114 SMs the narrow maps take fewer chunks, the stem none
    q = bn.launch_plan(rows, c, BF16, sms=114)
    assert (q.lanes, q.blocks) == (p.lanes, p.blocks)
    assert q.chunks == 1 if site == "stem" else q.chunks < p.chunks and q.ctas < 228 + q.blocks


def test_launch_plan_overrides():
    p = bn_times.plan_variant(4096, 294912, BF16, lanes=256, chunks=4)
    assert (p.lanes, p.slots, p.cb, p.blocks, p.chunks, p.chunk_rows) == (256, 1, 2048, 144, 4,
                                                                           1024)
    assert bn.launch_plan(5, 3, F32).lanes == 4 and bn.launch_plan(5, 3, F32).vec == 1
    assert bn.launch_plan(1, 8, BF16).lanes == 1


@pytest.mark.parametrize("args,kwargs,error", [
    ((128, 64, F64), {}, TypeError),
    ((128, 64, torch.float16), {}, TypeError),
    ((0, 64, BF16), {}, ValueError),
    ((128, 0, BF16), {}, ValueError),
    ((128, 64, BF16), {"lanes": 3}, ValueError),
    ((128, 64, BF16), {"lanes": 512}, ValueError),
    ((128, 64, BF16), {"lanes": 16}, ValueError),  # 16 lanes over 8 vectors a row
    ((128, 64, BF16), {"chunks": 0}, ValueError),
    ((4096, 16 * 8 * 65536 + 8, BF16), {}, ValueError),  # 65,537 channel blocks
], ids=["f64", "f16", "no_rows", "no_channels", "lanes_3", "lanes_512", "lanes_wide",
        "chunks_0", "blocks"])
def test_launch_plan_refusals(args, kwargs, error):
    """The program's plan refuses what the kernels cannot take; the timing
    tool's variants (lanes, chunks) refuse what they cannot launch."""
    with pytest.raises(error):
        (bn_times.plan_variant if kwargs else bn.launch_plan)(*args, **kwargs)


def test_matrix_shape_and_the_kernels_refuse_cpu_tensors():
    assert bn.matrix_shape(torch.empty(4, 10)) == (4, 10)
    assert bn.matrix_shape(torch.empty(2, 3, 4, 5)) == (40, 3)
    with pytest.raises(ValueError):
        bn.matrix_shape(torch.empty(2, 3, 4))
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        bn.fwd_stats_kernel(x)
    with pytest.raises(ValueError, match="CUDA"):
        bn.bwd_reduce_kernel(x, x, *[torch.zeros(16)] * 4, None)


# ------------------------------------------------- the card tests' bound
def _kernel_like(t: dict, fault: float = 0.0) -> dict:
    """The train-mode forward's y with float32 statistics from sums taken
    in float64 and rounded once (another order than the plain version's
    float32 means), the variance times 1 + `fault`; the rest the plain
    version's."""
    x = t["x"]
    n = x.shape[0]
    mean = (x.double().sum(0) / n).float()
    mean2 = ((x.double() ** 2).sum(0) / n).float()
    var = torch.clamp(mean2 - mean * mean, min=0.0) * (1.0 + fault)
    mul = torch.rsqrt(var + bn_times.EPS) * t["scale"]
    y = torch.relu(((x - mean) * mul + t["bias"]).to(x.dtype))
    return {"y": y}


@pytest.mark.parametrize("fault", [0.0, 2.0**-8], ids=["sound", "variance_fault"])
def test_differences_bound_scales_with_cancellation(fault):
    t = bn_times.inputs((2, 16384), F32, torch.device("cpu"), 29)
    want, _, _ = bn_times.plain(t)
    got = {**{k: want[k] for k in ("dx", "dscale", "dbias", "mean", "var")},
           **_kernel_like(t, fault)}
    readings = bn_times.differences(got, want)
    # two rows: many channels' variance cancels far past ABS_SHARE's room
    assert want["cancel"].max() * bn_times.CANCEL_SHARE > 16 * bn_times.ABS_SHARE
    assert readings["ok"] == (fault == 0.0), readings
    if fault:
        assert readings["y"] > 10.0  # every channel's y moves by ~2^-9 of itself
