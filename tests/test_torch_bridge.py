"""bridge.py: JAX (flax) variables <-> port modules.

A round trip (flax -> port -> flax) is exact for every collection the
bridge covers. One conv, one 4x4 stride-2 ConvTranspose, `to_rgb`, one
dense and one BatchNorm, each bridged from flax-initialized weights, match
the flax layer at float32 within 1e-5 (summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegeneration_tpu.models import sndcgan as jmodels
from imagegeneration_tpu.nn import layers as jl
from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.models import sndcgan as tmodels
from imagegeneration_tpu_torch.nn import layers as tl

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
IMAGE = (16, 24, 3)


def _tree_equal(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("spectral_norm", [True, False])
def test_round_trip_is_exact(spectral_norm):
    jcfg = jmodels.SNDCGANConfig(image_size=IMAGE, base_width=16,
                                 spectral_norm=spectral_norm)
    tcfg = tmodels.SNDCGANConfig(image_size=IMAGE, base_width=16,
                                 spectral_norm=spectral_norm)
    g_vars = jax.device_get(jmodels.Generator(jcfg).init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 128)), train=False))
    d_vars = jax.device_get(jmodels.Discriminator(jcfg).init(
        {"params": jax.random.key(1)}, jnp.zeros((1, *IMAGE)), train=False))
    # non-trivial batch_stats so that mean/var are told apart
    g_vars = jax.tree.map(lambda x: np.asarray(x) + 0.25, g_vars)
    gen, disc = tmodels.Generator(tcfg), tmodels.Discriminator(tcfg)
    bridge.load_flax_variables(gen, g_vars)
    bridge.load_flax_variables(disc, d_vars)
    _tree_equal(bridge.flax_variables(gen), g_vars)
    _tree_equal(bridge.flax_variables(disc), d_vars)
    # a params-shaped tree (Adam moments) through the parameter-list order
    mu = jax.tree.map(lambda x: np.asarray(x) * 3.0, g_vars["params"])
    dst = [torch.empty_like(p) for p in gen.parameters()]
    bridge.load_param_tree(gen, mu, dst)
    _tree_equal(bridge.param_tree(gen, dst), mu)


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_conv_convt_to_rgb_dense_bn_match_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 10, 8)).astype(np.float32)

    conv = jl.Conv(5, (3, 3), (1, 1), "SAME")
    v = conv.init(jax.random.key(0), jnp.asarray(x))
    t = tl.Conv(8, 5, (3, 3))
    bridge.load_flax_variables(torch.nn.ModuleDict({"c": t}), {"params": {"c": v["params"]}})
    np.testing.assert_allclose(_nhwc(t(_nchw(x))), np.asarray(conv.apply(v, x)), **TOL)

    convt = jl.ConvTranspose(4, (4, 4), (2, 2), "SAME", use_bias=False)
    v = convt.init(jax.random.key(1), jnp.asarray(x))
    t = tl.ConvTranspose(8, 4, (4, 4), (2, 2), use_bias=False)
    bridge.load_flax_variables(torch.nn.ModuleDict({"c": t}), {"params": {"c": v["params"]}})
    np.testing.assert_allclose(_nhwc(t(_nchw(x))), np.asarray(convt.apply(v, x)), **TOL)

    # to_rgb: a stride-1 ConvTranspose in flax, stored under ConvTranspose_0
    # but computed (and bridged) as a plain, unflipped conv
    to_rgb = jl.ConvTranspose(3, (3, 3), (1, 1), "SAME", use_bias=False)
    v = to_rgb.init(jax.random.key(2), jnp.asarray(x))
    assert set(v["params"]) == {"ConvTranspose_0"}
    t = tl.Conv(8, 3, (3, 3), use_bias=False)
    bridge.copy_in(t.weight, "conv", v["params"]["ConvTranspose_0"]["kernel"])
    np.testing.assert_allclose(_nhwc(t(_nchw(x))), np.asarray(to_rgb.apply(v, x)), **TOL)

    xf = x.reshape(2, -1)
    dense = jl.Dense(7)
    v = dense.init(jax.random.key(3), jnp.asarray(xf))
    t = tl.Dense(xf.shape[1], 7)
    bridge.load_flax_variables(torch.nn.ModuleDict({"d": t}), {"params": {"d": v["params"]}})
    np.testing.assert_allclose(t(torch.from_numpy(xf)).detach().numpy(),
                               np.asarray(dense.apply(v, xf)), **TOL)

    bn = jl.BatchNorm(use_running_average=True)
    v = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(0.1, 1.0, a.shape).astype(np.float32),
                     jax.device_get(bn.init(jax.random.key(4), jnp.asarray(x))))
    t = tl.BatchNorm(8)
    bridge.load_flax_variables(
        torch.nn.ModuleDict({"b": t}),
        {"params": {"b": v["params"]}, "batch_stats": {"b": v["batch_stats"]}})
    np.testing.assert_allclose(_nhwc(t(_nchw(x), use_running_average=True)),
                               np.asarray(bn.apply(v, x)), **TOL)


def test_bf16_moments_round_trip_is_exact():
    """bfloat16 Adam moments (`opt_moments="bf16"`, ml_dtypes arrays on the
    JAX side) through load_jax_train_state / jax_train_state, bit for bit."""
    import ml_dtypes

    from imagegeneration_tpu.train import sndcgan_step as jstep
    from imagegeneration_tpu_torch.train import sndcgan_step as tstep

    jcfg = jstep.SNDCGANTrainConfig(
        model=jmodels.SNDCGANConfig(image_size=IMAGE, base_width=16, spectral_norm=True),
        batch_size=2, opt_moments="bf16")
    state = jax.device_get(jstep.init_state(jcfg))
    rng = np.random.default_rng(5)

    def draw(x):
        return rng.normal(size=np.shape(x)).astype(ml_dtypes.bfloat16)

    opt = lambda o: {"count": np.asarray(3), "mu": jax.tree.map(draw, o.mu),  # noqa: E731
                     "nu": jax.tree.map(lambda x: np.abs(draw(x)), o.nu)}
    want = {"step": np.asarray(3), "g_params": state.g_params,
            "g_batch_stats": state.g_batch_stats, "g_opt": opt(state.g_opt),
            "d_params": state.d_params, "d_spectral": state.d_spectral,
            "d_opt": opt(state.d_opt)}
    port = tstep.init_state(tstep.SNDCGANTrainConfig(
        model=tmodels.SNDCGANConfig(image_size=IMAGE, base_width=16, spectral_norm=True),
        batch_size=2, opt_moments="bf16"), "cpu")
    bridge.load_jax_train_state(port, want)
    assert {t.dtype for t in port.g_opt.mu + port.d_opt.nu} == {torch.bfloat16}
    got = bridge.jax_train_state(port)
    for key in ("g_opt", "d_opt"):
        for m in ("mu", "nu"):
            leaves = jax.tree.leaves(got[key][m])
            assert {x.dtype for x in leaves} == {np.dtype(ml_dtypes.bfloat16)}
            la = jax.tree_util.tree_leaves_with_path(got[key][m])
            lb = jax.tree_util.tree_leaves_with_path(want[key][m])
            assert [p for p, _ in la] == [p for p, _ in lb]
            for (path, x), (_, y) in zip(la, lb):
                np.testing.assert_array_equal(x.view(np.uint16), y.view(np.uint16),
                                              err_msg=f"{key}.{m}{jax.tree_util.keystr(path)}")
    _tree_equal(got["g_params"], want["g_params"])
    _tree_equal(got["d_params"], want["d_params"])
