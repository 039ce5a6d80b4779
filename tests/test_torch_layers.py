"""Port layers (imagegeneration_tpu_torch.nn) vs the flax layers they replace.

Same inputs (numpy, seeded) through the flax module and its port on
bridged weights, forward and gradients, at float32 on the CPU. Tolerance:
1e-5 absolute + relative on O(1) values -- the two frameworks sum convs and
reductions in different orders, which moves float32 results by a few ulp;
a wrong padding, flip or layout moves them by O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegeneration_tpu.nn import layers as jl
from imagegeneration_tpu.nn import spectral_norm as jsn
from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.nn import layers as tl
from imagegeneration_tpu_torch.nn import spectral_norm as tsn

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last
    ).requires_grad_(True)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _kernel_grad(t, kind):
    return bridge.to_flax_layout(kind, t.grad.numpy())


@pytest.mark.parametrize(
    "hw,k,s",
    [((9, 11), (3, 3), (1, 1)), ((9, 11), (4, 4), (2, 2)), ((8, 12), (4, 4), (2, 2))],
)
def test_conv_same_forward_and_grads(hw, k, s):
    """Odd extents with a 4x4 s2 kernel take the asymmetric TF-SAME pad."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, *hw, 5)).astype(np.float32)
    g = rng.normal(size=(2, -(-hw[0] // s[0]), -(-hw[1] // s[1]), 7)).astype(np.float32)
    mod = jl.Conv(7, k, s, "SAME")
    v = mod.init(jax.random.key(0), jnp.asarray(x))
    v = {"params": {"Conv_0": {
        "kernel": v["params"]["Conv_0"]["kernel"],
        "bias": jnp.asarray(rng.normal(size=(7,)).astype(np.float32)),
    }}}
    y, vjp = jax.vjp(lambda p, x: mod.apply(p, x), v, jnp.asarray(x))
    dv, dx = vjp(jnp.asarray(g))

    conv = tl.Conv(5, 7, k, s, "SAME")
    bridge.copy_in(conv.weight, "conv", v["params"]["Conv_0"]["kernel"])
    bridge.copy_in(conv.bias, "vec", v["params"]["Conv_0"]["bias"])
    xt = _nchw(x)
    yt = conv(xt)
    yt.backward(_nchw(g).detach())
    np.testing.assert_allclose(_nhwc(yt), np.asarray(y), **TOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx), **TOL)
    np.testing.assert_allclose(_kernel_grad(conv.weight, "conv"),
                               np.asarray(dv["params"]["Conv_0"]["kernel"]), **TOL)
    np.testing.assert_allclose(conv.bias.grad.numpy(),
                               np.asarray(dv["params"]["Conv_0"]["bias"]), **TOL)


@pytest.mark.parametrize("hw", [(3, 5), (4, 4)])
def test_conv_transpose_s2_forward_and_grads(hw):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, *hw, 6)).astype(np.float32)
    g = rng.normal(size=(2, 2 * hw[0], 2 * hw[1], 4)).astype(np.float32)
    mod = jl.ConvTranspose(4, (4, 4), (2, 2), "SAME", use_bias=False)
    v = mod.init(jax.random.key(1), jnp.asarray(x))
    y, vjp = jax.vjp(lambda p, x: mod.apply(p, x), v, jnp.asarray(x))
    dv, dx = vjp(jnp.asarray(g))

    convt = tl.ConvTranspose(6, 4, (4, 4), (2, 2), use_bias=False)
    bridge.copy_in(convt.weight, "convT", v["params"]["ConvTranspose_0"]["kernel"])
    xt = _nchw(x)
    yt = convt(xt)
    yt.backward(_nchw(g).detach())
    np.testing.assert_allclose(_nhwc(yt), np.asarray(y), **TOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx), **TOL)
    np.testing.assert_allclose(
        _kernel_grad(convt.weight, "convT"),
        np.asarray(dv["params"]["ConvTranspose_0"]["kernel"]), **TOL)


def test_dense_forward_and_grads():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 10)).astype(np.float32)
    g = rng.normal(size=(3, 6)).astype(np.float32)
    mod = jl.Dense(6)
    v = mod.init(jax.random.key(2), jnp.asarray(x))
    y, vjp = jax.vjp(lambda p, x: mod.apply(p, x), v, jnp.asarray(x))
    dv, dx = vjp(jnp.asarray(g))
    dense = tl.Dense(10, 6)
    bridge.copy_in(dense.weight, "dense", v["params"]["Dense_0"]["kernel"])
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = dense(xt)
    yt.backward(torch.from_numpy(g))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), **TOL)
    np.testing.assert_allclose(_kernel_grad(dense.weight, "dense"),
                               np.asarray(dv["params"]["Dense_0"]["kernel"]), **TOL)


@pytest.mark.parametrize("image", [True, False])
def test_batchnorm_train_eval_and_running_stats(image):
    """Train-mode output and gradients, the running-stat update with the
    BIASED batch variance, and inference mode on the updated statistics."""
    rng = np.random.default_rng(3)
    shape = (4, 5, 3, 6) if image else (8, 6)
    x = (2.0 + 3.0 * rng.normal(size=shape)).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    mod_t = jl.BatchNorm(use_running_average=False)
    v = mod_t.init(jax.random.key(3), jnp.asarray(x))
    p = {"BatchNorm_0": {
        "scale": jnp.asarray(rng.uniform(0.5, 1.5, 6).astype(np.float32)),
        "bias": jnp.asarray(rng.normal(size=6).astype(np.float32)),
    }}
    bs = v["batch_stats"]

    def f(p, x):
        return mod_t.apply({"params": p, "batch_stats": bs}, x,
                           mutable=["batch_stats"])

    (y, mut), vjp = jax.vjp(f, p, jnp.asarray(x))
    dp, dx = vjp((jnp.asarray(g), jax.tree.map(jnp.zeros_like, mut)))
    y_eval = jl.BatchNorm(use_running_average=True).apply(
        {"params": p, **mut}, jnp.asarray(x))

    bn = tl.BatchNorm(6)
    bridge.copy_in(bn.scale, "vec", p["BatchNorm_0"]["scale"])
    bridge.copy_in(bn.bias, "vec", p["BatchNorm_0"]["bias"])
    xt = _nchw(x) if image else torch.from_numpy(x).requires_grad_(True)
    gt = _nchw(g).detach() if image else torch.from_numpy(g)
    out = (lambda t: _nhwc(t)) if image else (lambda t: t.detach().numpy())
    yt = bn(xt, use_running_average=False)
    yt.backward(gt)
    np.testing.assert_allclose(out(yt), np.asarray(y), **TOL)
    np.testing.assert_allclose(out(xt.grad), np.asarray(dx), **TOL)
    np.testing.assert_allclose(bn.scale.grad.numpy(),
                               np.asarray(dp["BatchNorm_0"]["scale"]), **TOL)
    np.testing.assert_allclose(bn.bias.grad.numpy(),
                               np.asarray(dp["BatchNorm_0"]["bias"]), **TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(mut["batch_stats"]["BatchNorm_0"][k]),
                                   **TOL)
    with torch.no_grad():
        np.testing.assert_allclose(out(bn(xt, use_running_average=True)),
                                   np.asarray(y_eval), **TOL)


def test_batchnorm_float64_statistics_match_flax_x64():
    """A float64 input gets float64 statistics, as flax computes them in
    promote_types(x.dtype, float32): train-mode output and gradients, the
    running-stat update (stored float32, as the JAX step keeps it) at 1e-12
    (bit-equal for the statistics), and inference mode. Statistics taken in
    float32 are ~1e-7 off."""
    rng = np.random.default_rng(4)
    x = 2.0 + 3.0 * rng.normal(size=(4, 5, 3, 6))
    g = rng.normal(size=x.shape)
    scale, bias = rng.uniform(0.5, 1.5, 6), rng.normal(size=6)
    old_x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        p = {"BatchNorm_0": {"scale": jnp.asarray(scale, jnp.float32),
                             "bias": jnp.asarray(bias, jnp.float32)}}
        mod_t = jl.BatchNorm(use_running_average=False)
        bs = mod_t.init(jax.random.key(4), jnp.asarray(x))["batch_stats"]

        def f(p, x):
            return mod_t.apply({"params": p, "batch_stats": bs}, x, mutable=["batch_stats"])

        (y, mut), vjp = jax.vjp(f, p, jnp.asarray(x))
        dp, dx = vjp((jnp.asarray(g), jax.tree.map(jnp.zeros_like, mut)))
        stats = jax.tree.map(lambda a: np.asarray(a, np.float32), mut["batch_stats"])
        y_eval = jl.BatchNorm(use_running_average=True).apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(x))
        assert y.dtype == y_eval.dtype == jnp.float64
    finally:
        jax.config.update("jax_enable_x64", old_x64)

    bn = tl.BatchNorm(6)
    bridge.copy_in(bn.scale, "vec", scale.astype(np.float32))
    bridge.copy_in(bn.bias, "vec", bias.astype(np.float32))
    xt = _nchw(x)
    yt = bn(xt, use_running_average=False)
    assert yt.dtype == torch.float64 and bn.mean.dtype == torch.float32
    yt.backward(_nchw(g).detach())
    tight = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_nhwc(yt), np.asarray(y), **tight)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx), **tight)
    for k in ("scale", "bias"):  # float32 parameters: float32 gradients
        np.testing.assert_allclose(getattr(bn, k).grad.numpy(),
                                   np.asarray(dp["BatchNorm_0"][k]), rtol=1e-6)
    for k in ("mean", "var"):
        np.testing.assert_array_equal(getattr(bn, k).numpy(), stats["BatchNorm_0"][k])
    # Inference normalizes with the float32 running statistics on both sides
    # (flax takes rsqrt of the float32 var), so it agrees to float32 rounding.
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(bn(xt, use_running_average=True)),
                                   np.asarray(y_eval), rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("update", [True, False])
def test_spectral_norm_conv_sigma_u_and_grads(update):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 7, 9, 4)).astype(np.float32)
    g = rng.normal(size=(2, 4, 5, 8)).astype(np.float32)
    mod = jsn.SpectralNormConv(8, (4, 4), (2, 2), "SAME")
    v = mod.init({"params": jax.random.key(4)}, jnp.asarray(x))

    def f(params, x):
        return mod.apply({"params": params, "spectral": v["spectral"]}, x,
                         update_stats=update, mutable=["spectral"])

    (y, mut), vjp = jax.vjp(f, v["params"], jnp.asarray(x))
    dp, dx = vjp((jnp.asarray(g), jax.tree.map(jnp.zeros_like, mut)))

    sn = tsn.SpectralNormConv(4, 8, (4, 4), (2, 2), "SAME")
    bridge.copy_in(sn.weight, "conv", v["params"]["kernel"])
    bridge.copy_in(sn.u, "vec", v["spectral"]["u"])
    u0 = sn.u.clone()
    xt = _nchw(x)
    yt = sn(xt, update_sn=update)
    yt.backward(_nchw(g).detach())
    np.testing.assert_allclose(_nhwc(yt), np.asarray(y), **TOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx), **TOL)
    np.testing.assert_allclose(_kernel_grad(sn.weight, "conv"),
                               np.asarray(dp["kernel"]), **TOL)
    np.testing.assert_allclose(sn.bias.grad.numpy(), np.asarray(dp["bias"]), **TOL)
    want_u = np.asarray(mut["spectral"]["u"]) if update else u0.numpy()
    np.testing.assert_allclose(sn.u.numpy(), want_u, **TOL)
    if not update:
        assert torch.equal(sn.u, u0)

    # sigma itself, against the JAX power iteration on the HWIO matrix
    w_mat = jnp.asarray(v["params"]["kernel"]).reshape(-1, 8)
    sigma, _ = jsn.power_iteration(w_mat, jnp.asarray(v["spectral"]["u"]))
    t_sigma, _ = tsn.power_iteration(sn.weight.detach().flatten(1), u0)
    np.testing.assert_allclose(float(t_sigma), float(sigma), rtol=1e-5)


def test_spectral_norm_dense_sigma_u_and_grads():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 12)).astype(np.float32)
    g = rng.normal(size=(3, 1)).astype(np.float32)
    mod = jsn.SpectralNormDense(1)
    v = mod.init({"params": jax.random.key(5)}, jnp.asarray(x))

    def f(params, x):
        return mod.apply({"params": params, "spectral": v["spectral"]}, x,
                         update_stats=True, mutable=["spectral"])

    (y, mut), vjp = jax.vjp(f, v["params"], jnp.asarray(x))
    dp, dx = vjp((jnp.asarray(g), jax.tree.map(jnp.zeros_like, mut)))
    sn = tsn.SpectralNormDense(12, 1)
    bridge.copy_in(sn.weight, "dense", v["params"]["kernel"])
    bridge.copy_in(sn.u, "vec", v["spectral"]["u"])
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = sn(xt, update_sn=True)
    yt.backward(torch.from_numpy(g))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), **TOL)
    np.testing.assert_allclose(_kernel_grad(sn.weight, "dense"),
                               np.asarray(dp["kernel"]), **TOL)
    np.testing.assert_allclose(sn.u.numpy(), np.asarray(mut["spectral"]["u"]), **TOL)
