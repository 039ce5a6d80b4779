"""The port's InstanceNorm and the CycleGAN layers vs the JAX package, on CPU.

- The plain forward/backward (ops/instance_norm.py), with and without the
  fused ReLU, against both JAX paths: `_in_fwd_xla`/`_in_bwd_xla` and the
  Pallas kernels `_in_fwd_pallas`/`_in_bwd_pallas` in interpret mode.
  Tolerance rtol/atol 2e-5 (mean, rstd 1e-5): the bounds the JAX package
  holds its own kernel to (tests/test_pallas_ops.py); the two frameworks
  sum in different orders.
- The autograd.Function's gradient against `jax.grad` of
  `instance_norm(..., "pallas_interpret")`.
- The InstanceNorm module (per-channel, and the `quirk_axis1` form),
  reflection padding, the ResBlock, and the 3x3 stride-2 ConvTranspose with
  its high-side crop against `lax.conv_transpose(..., "SAME",
  transpose_kernel=False)`, forward and gradients, at 1e-5 as
  tests/test_torch_layers.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegeneration_tpu.nn import layers as jl
from imagegeneration_tpu.ops.pallas import instance_norm as jin
from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.nn import layers as tl
from imagegeneration_tpu_torch.ops import instance_norm as tin

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)
STAT_TOL = dict(rtol=1e-5, atol=1e-5)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b=2, h=8, w=8, c=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(2.0, 3.0, (b, h, w, c)).astype(np.float32)
    dy = rng.normal(size=(b, h, w, c)).astype(np.float32)
    gamma = rng.normal(1.0, 0.1, (c,)).astype(np.float32)
    beta = rng.normal(0.0, 0.1, (c,)).astype(np.float32)
    return x, dy, gamma, beta


def _nchw(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    return t.requires_grad_(grad)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_forward_matches_jax(backend, relu):
    x, _, gamma, beta = _inputs(seed=1)
    args = (jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 1e-3, relu)
    if backend == "xla":
        y, mean, rstd = jin._in_fwd_xla(*args)
    else:
        y, mean, rstd = jin._in_fwd_pallas(*args, interpret=True)
    yt, mt, rt = tin.in_fwd_plain(_nchw(x), torch.from_numpy(gamma),
                                  torch.from_numpy(beta), 1e-3, relu)
    np.testing.assert_allclose(_nhwc(yt), np.asarray(y), **TOL)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mean), **STAT_TOL)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rstd), **STAT_TOL)


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_backward_matches_jax(backend, relu):
    x, dy, gamma, beta = _inputs(seed=2)
    xj, gj, bj = jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta)
    _, mean, rstd = jin._in_fwd_xla(xj, gj, bj, 1e-3, relu)
    args = (xj, jnp.asarray(dy), gj, bj, mean, rstd, relu)
    if backend == "xla":
        dx, dg, db = jin._in_bwd_xla(*args)
    else:
        dx, dg, db = jin._in_bwd_pallas(*args, interpret=True)
    dxt, dgt, dbt = tin.in_bwd_plain(
        _nchw(x), _nchw(dy), torch.from_numpy(gamma), torch.from_numpy(beta),
        torch.from_numpy(np.array(mean)), torch.from_numpy(np.array(rstd)), relu)
    np.testing.assert_allclose(_nhwc(dxt), np.asarray(dx), **TOL)
    np.testing.assert_allclose(dgt.numpy(), np.asarray(dg), **TOL)
    np.testing.assert_allclose(dbt.numpy(), np.asarray(db), **TOL)


@pytest.mark.parametrize("relu", [False, True])
def test_autograd_function_matches_jax_grad(relu):
    """The custom backward (y not saved, mask rebuilt) against jax.grad of
    the custom_vjp in interpret mode, on a loss that weights every output."""
    x, dy, gamma, beta = _inputs(b=2, h=8, w=8, c=128, seed=3)

    def loss(x_, g_, b_):
        y = jin.instance_norm(x_, g_, b_, 1e-3, relu, "pallas_interpret")
        return jnp.sum(y * jnp.asarray(dy))

    gx, gg, gb = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    xt = _nchw(x, grad=True)
    gt = torch.from_numpy(gamma).requires_grad_(True)
    bt = torch.from_numpy(beta).requires_grad_(True)
    y = tin.instance_norm(xt, gt, bt, 1e-3, relu)
    (y * _nchw(dy)).sum().backward()
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), **TOL)
    np.testing.assert_allclose(gt.grad.numpy(), np.asarray(gg), **TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb), **TOL)


def test_forward_saves_no_output_and_takes_nchw():
    """An NCHW-contiguous input is brought to channels_last; the backward
    saves x, gamma, beta, mean and rstd (not y)."""
    x, _, gamma, beta = _inputs(b=1, h=5, w=6, c=4, seed=4)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    y = tin.instance_norm(xt, torch.from_numpy(gamma), torch.from_numpy(beta))
    assert y.is_contiguous(memory_format=torch.channels_last)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 5 and not any(s.data_ptr() == y.data_ptr() for s in saved)
    assert tin.LAUNCHES == {"instance_norm_fwd": 0, "instance_norm_bwd": 0}


@pytest.mark.parametrize("quirk_axis1", [False, True])
def test_instance_norm_module_matches_flax(quirk_axis1):
    x, dy, _, _ = _inputs(b=2, h=6, w=7, c=5, seed=5)
    mod = jl.InstanceNorm(quirk_axis1=quirk_axis1, backend="auto")
    v = mod.init(jax.random.key(0), jnp.asarray(x))
    y, vjp = jax.vjp(lambda p, x: mod.apply(p, x), v, jnp.asarray(x))
    dv, dx = vjp(jnp.asarray(dy))

    norm = tl.InstanceNorm(5, quirk_axis1, height=6)
    assert norm.scale.shape == v["params"]["scale"].shape  # (C,) or (H, 1, 1)
    for k in ("scale", "bias"):
        bridge.copy_in(getattr(norm, k), "vec", v["params"][k])
    xt = _nchw(x, grad=True)
    yt = norm(xt)
    yt.backward(_nchw(dy))
    np.testing.assert_allclose(_nhwc(yt), np.asarray(y), **LAYER_TOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx), **LAYER_TOL)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(getattr(norm, k).grad.numpy(),
                                   np.asarray(dv["params"][k]), **LAYER_TOL)


def test_keras_random_uniform_init():
    norm = tl.InstanceNorm(4096, generator=torch.Generator().manual_seed(0))
    for p in (norm.scale, norm.bias):
        assert p.shape == (4096,) and p.abs().max() <= 0.05 and p.std() > 0.02


def test_reflection_pad_matches_jax():
    x = np.random.default_rng(6).normal(size=(2, 5, 7, 3)).astype(np.float32)
    want = jl.reflection_pad_2d(jnp.asarray(x), (1, 2))
    got = tl.reflection_pad_2d(_nchw(x), (1, 2))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_resblock_forward_and_grads():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 6, 6, 8)).astype(np.float32)
    g = rng.normal(size=(2, 6, 6, 8)).astype(np.float32)
    mod = jl.ResBlock(8, in_backend="auto")
    v = mod.init(jax.random.key(1), jnp.asarray(x))
    y, vjp = jax.vjp(lambda p, x: mod.apply(p, x), v, jnp.asarray(x))
    dv, dx = vjp(jnp.asarray(g))

    block = tl.ResBlock(8)
    # A ResBlock bridges through a model that holds it, as in the generator.
    holder = torch.nn.Module()
    holder.res0 = block
    bridge.load_flax_variables(holder, {"params": {"res0": jax.device_get(v["params"])}})
    xt = _nchw(x, grad=True)
    yt = block(xt)
    yt.backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(yt), np.asarray(y), **LAYER_TOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx), **LAYER_TOL)
    got = bridge.param_tree(holder, [p.grad for p in holder.parameters()])["res0"]
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(dv["params"])):
        np.testing.assert_allclose(a, np.asarray(b), **LAYER_TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("hw", [(3, 5), (4, 4), (8, 8)])
def test_conv_transpose_3x3_s2_crop_matches_lax(hw):
    """lax pads the dilated input (2, 1) for a 3x3 stride-2 SAME transposed
    conv; the port computes (2, 2) and crops the extra high-side row and
    column."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, *hw, 6)).astype(np.float32)
    g = rng.normal(size=(2, 2 * hw[0], 2 * hw[1], 4)).astype(np.float32)
    w = rng.normal(size=(3, 3, 6, 4)).astype(np.float32) * 0.3
    b = rng.normal(size=(4,)).astype(np.float32)

    def f(x, w, b):
        y = jax.lax.conv_transpose(x, w, (2, 2), "SAME",
                                   dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                   transpose_kernel=False)
        return y + b

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    dx, dw, db = vjp(jnp.asarray(g))

    convt = tl.ConvTranspose(6, 4, (3, 3), (2, 2))
    assert convt.crop
    bridge.copy_in(convt.weight, "convT", w)
    bridge.copy_in(convt.bias, "vec", b)
    xt = _nchw(x, grad=True)
    yt = convt(xt)
    assert yt.shape == (2, 4, 2 * hw[0], 2 * hw[1])
    yt.backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(yt), np.asarray(y), **LAYER_TOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx), **LAYER_TOL)
    np.testing.assert_allclose(bridge.to_flax_layout("convT", convt.weight.grad.numpy()),
                               np.asarray(dw), **LAYER_TOL)
    np.testing.assert_allclose(convt.bias.grad.numpy(), np.asarray(db), **LAYER_TOL)
    # The 4x4 stride-2 case (SNDCGAN) needs no crop.
    assert not tl.ConvTranspose(6, 4, (4, 4), (2, 2)).crop
