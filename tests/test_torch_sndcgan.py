"""Port SNDCGAN generator/discriminator vs the flax models, bridged weights.

Forward parity at float32 on the CPU: G in train mode (batch statistics,
and the running-statistic update) and in inference mode; D without
dropout, with the fused LeakyReLU + hash dropout (the JAX side is fed the
same per-site key words by monkeypatching `bitdropout.hash_dropout`), with
spectral norm updating `u`, and the `features=True` 8x8 average-pool
extractor. Tolerance 1e-4 abs + rel on O(1) outputs: a 7-conv trunk
summed in another order drifts by ~1e-6; a layout or mask error is O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegeneration_tpu.models import sndcgan as jm
from imagegeneration_tpu.ops import bitdropout
from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.models import sndcgan as tm

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
KW = np.random.default_rng(5).integers(0, 2**32, (7, 2), dtype=np.uint64)


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("quirk_eval_bn", [False, True])
def test_generator_forward_train_and_eval(quirk_eval_bn):
    image = (16, 24, 3)
    jcfg = jm.SNDCGANConfig(image_size=image, base_width=16, quirk_eval_bn=quirk_eval_bn)
    tcfg = tm.SNDCGANConfig(image_size=image, base_width=16, quirk_eval_bn=quirk_eval_bn)
    z = np.random.default_rng(0).uniform(-1, 1, (3, 128)).astype(np.float32)
    gen_j = jm.Generator(jcfg)
    v = jax.device_get(gen_j.init({"params": jax.random.key(0)}, jnp.zeros((1, 128)),
                                  train=False))
    v["batch_stats"] = jax.tree.map(lambda a: np.asarray(a) + 0.5, v["batch_stats"])
    y_train, mut = gen_j.apply(v, jnp.asarray(z), train=True, mutable=["batch_stats"])
    y_eval = gen_j.apply(v, jnp.asarray(z), train=False)

    gen_t = tm.Generator(tcfg)
    bridge.load_flax_variables(gen_t, v)
    with torch.no_grad():
        yt_eval = gen_t(torch.from_numpy(z), train=False)
        yt_train = gen_t(torch.from_numpy(z), train=True)
    assert yt_train.shape == (3, 3, 16, 24)
    assert yt_train.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(yt_eval.permute(0, 2, 3, 1).numpy(), np.asarray(y_eval), **TOL)
    np.testing.assert_allclose(yt_train.permute(0, 2, 3, 1).numpy(), np.asarray(y_train), **TOL)
    got_bs = bridge.flax_variables(gen_t)["batch_stats"]
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got_bs),
                                 jax.tree_util.tree_leaves_with_path(mut["batch_stats"])):
        np.testing.assert_allclose(a, np.asarray(b), **TOL, err_msg=jax.tree_util.keystr(path))


def _patch_dropout(monkeypatch):
    calls = []

    def fixed_kw_dropout(key, x, rate, rounds=2):
        site = len(calls)
        calls.append(site)
        return bitdropout._hash_dropout_vjp(
            jnp.asarray(KW[site].astype(np.uint32)), x, rate, rounds)

    monkeypatch.setattr(bitdropout, "hash_dropout", fixed_kw_dropout)
    return calls


@pytest.mark.parametrize("spectral_norm", [True, False])
def test_discriminator_forward_dropout_sn_and_features(spectral_norm, monkeypatch):
    image = (64, 72, 3)
    jcfg = jm.SNDCGANConfig(image_size=image, spectral_norm=spectral_norm)
    tcfg = tm.SNDCGANConfig(image_size=image, spectral_norm=spectral_norm)
    x = np.random.default_rng(1).uniform(-1, 1, (2, *image)).astype(np.float32)
    disc_j = jm.Discriminator(jcfg)
    v = jax.device_get(disc_j.init({"params": jax.random.key(1)}, jnp.zeros((1, *image)),
                                   train=False))
    disc_t = tm.Discriminator(tcfg)
    bridge.load_flax_variables(disc_t, v)
    xt = _nchw(x)

    # inference: no dropout, u unchanged
    want = disc_j.apply(v, jnp.asarray(x), train=False, update_sn=False)
    with torch.no_grad():
        got = disc_t(xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # features=True: 8x8 avg-pool of the trunk, NHWC flatten
    want = disc_j.apply(v, jnp.asarray(x), train=False, update_sn=False, features=True)
    with torch.no_grad():
        got = disc_t(xt, features=True)
    assert got.shape == want.shape == (2, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # training: the fused dropout with the same key words, and the SN update
    calls = _patch_dropout(monkeypatch)
    if spectral_norm:
        want, mut = disc_j.apply(v, jnp.asarray(x), train=True, update_sn=True,
                                 rngs={"dropout": jax.random.key(9)}, mutable=["spectral"])
    else:
        want = disc_j.apply(v, jnp.asarray(x), train=True, rngs={"dropout": jax.random.key(9)})
    assert calls == list(range(7))
    with torch.no_grad():
        got = disc_t(xt, torch.from_numpy(KW.astype(np.int64)), update_sn=spectral_norm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if spectral_norm:
        got_u = bridge.flax_variables(disc_t)["spectral"]
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got_u),
                                     jax.tree_util.tree_leaves_with_path(mut["spectral"])):
            np.testing.assert_allclose(a, np.asarray(b), **TOL,
                                       err_msg=jax.tree_util.keystr(path))
