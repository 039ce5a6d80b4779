"""Fused LeakyReLU + hash dropout (port) vs the JAX main path's dropout.

The JAX discriminator computes leaky_relu(x, 0.1) followed by
`bitdropout.hash_dropout` with the hash1 mask (rounds=1). The port fuses
both into one kernel pair; on the CPU its wrapper runs the plain PyTorch
version checked here. Given the same two key words:
- the keep mask equals `bitdropout._hash_mask(..., rounds=1)` BIT FOR BIT
  (uint32 hash, exact);
- forward and VJP at float32 are bit-identical (the same float32 products
  in the same order);
- at bfloat16 the mask is exact and values are within 1 bf16 ulp (JAX
  rounds leaky_relu to bf16 before the dropout multiply; the port rounds
  once, after it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegeneration_tpu.ops import bitdropout
from imagegeneration_tpu_torch.ops import adam as tadam
from imagegeneration_tpu_torch.ops import dropout as tdrop

torch.set_num_threads(1)

SHAPES = [(2, 5, 7, 3), (1, 16, 16, 64), (3, 9, 11, 13), (2, 4, 4, 128)]
RATES = [0.5, 0.25, 0.1]


def _kw(seed):
    return np.random.default_rng(seed).integers(0, 2**32, 2, dtype=np.uint64)


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype).permute(0, 3, 1, 2)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rate", RATES)
def test_plain_mask_is_hash1_bit_for_bit(shape, rate):
    kw = _kw(sum(shape) * 1000 + round(rate * 256))
    cut = tdrop.dropout_cut(rate)
    ones = jnp.ones(shape, jnp.float32)
    masked = bitdropout._hash_mask(
        jnp.asarray(kw.astype(np.uint32)), ones, cut, (256 - cut) / 256.0, rounds=1
    )
    want = np.asarray(masked) != 0
    got = tdrop.hash_keep_mask(
        torch.from_numpy(kw.astype(np.int64)), int(np.prod(shape)), cut
    ).view(shape).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.0 < want.mean() < 1.0


def _jax_fused(kw, rate):
    def f(x):
        y = jax.nn.leaky_relu(x, negative_slope=0.1)
        return bitdropout._hash_dropout_vjp(jnp.asarray(kw.astype(np.uint32)), y, rate, 1)

    return f


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_vjp_match_jax_f32(shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    kw = _kw(7)
    y, vjp = jax.vjp(_jax_fused(kw, 0.5), jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(g))

    xt = _nchw(x).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    yt = tdrop.leaky_relu_dropout(xt, torch.from_numpy(kw.astype(np.int64)), 0.5)
    assert yt.is_contiguous(memory_format=torch.channels_last)
    yt.backward(_nchw(g).contiguous(memory_format=torch.channels_last))
    np.testing.assert_array_equal(yt.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y))
    np.testing.assert_array_equal(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(dx))


def test_forward_and_vjp_match_jax_bf16():
    shape = (2, 8, 12, 64)
    rng = np.random.default_rng(2)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    kw = _kw(11)
    xj = jnp.asarray(x, jnp.bfloat16)
    y, vjp = jax.vjp(_jax_fused(kw, 0.5), xj)
    (dx,) = vjp(jnp.asarray(g, jnp.bfloat16))

    xt = _nchw(np.asarray(xj.astype(jnp.float32)), torch.bfloat16).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    gt = _nchw(np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32)),
               torch.bfloat16).contiguous(memory_format=torch.channels_last)
    yt = tdrop.leaky_relu_dropout(xt, torch.from_numpy(kw.astype(np.int64)), 0.5)
    yt.backward(gt)
    for got, want in ((yt.detach(), y), (xt.grad, dx)):
        got = got.float().permute(0, 2, 3, 1).numpy()
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_array_equal(got == 0, want == 0)  # the mask, exactly
        ulp = np.abs(want) * 2.0**-7  # one bf16 ulp is at most |v| * 2^-7
        assert np.all(np.abs(got - want) <= ulp + 1e-30)


def test_layout_and_rate_checks():
    kw = torch.tensor([1, 2], dtype=torch.int64)
    x = torch.randn(2, 8, 3, 5)  # NCHW-contiguous: its memory order is not NHWC
    with pytest.raises(ValueError, match="channels_last"):
        tdrop.leaky_relu_dropout(x, kw, 0.5)
    with pytest.raises(ValueError, match="rate"):
        tdrop.dropout_cut(0.999)
    assert tdrop.dropout_cut(0.0) == 0 and tdrop.keep_scale(0) == 1.0


def test_rate_zero_is_leaky_relu():
    x = torch.randn(2, 4, 3, 5).contiguous(memory_format=torch.channels_last)
    y = tdrop.leaky_relu_dropout(x, torch.tensor([3, 4]), 0.0)
    torch.testing.assert_close(y, torch.nn.functional.leaky_relu(x, 0.1), rtol=0, atol=0)


def test_cpu_never_launches_a_kernel():
    before = dict(tdrop.LAUNCHES), dict(tadam.LAUNCHES)
    x = torch.randn(2, 4, 3, 5).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    tdrop.leaky_relu_dropout(x, torch.tensor([3, 4]), 0.5).sum().backward()
    assert (tdrop.LAUNCHES, tadam.LAUNCHES) == before
    assert all(v == 0 for v in tdrop.LAUNCHES.values())
