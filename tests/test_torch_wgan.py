"""Port WGAN generator/critic, RMSprop and the Wasserstein loss vs the JAX package.

Forward parity at float32 on the CPU from bridged weights, at a small
configuration (32x48, base_width 16, batch 2): the generator (Dense stem,
three 4x4 s2 ConvTransposes with BN, the plain-conv `to_rgb`, tanh) and
the critic (seven TF-SAME convs with BN, LeakyReLU 0.2/0.1, NHWC flatten,
Dense head), each in train mode (batch statistics, running statistics
updated) and in inference mode. Tolerance 1e-4 abs + rel on O(1) outputs,
as tests/test_torch_sndcgan.py: a deep conv stack summed in another order
drifts by ~1e-6; a layout, padding or flatten-order error is O(1). The
running statistics: 1e-5.

Also: which parameters the clip and the gan update select (mirroring
tests/test_wgan.py), the N(0, 0.02) initializer, RMSprop against optax
(1e-6 relative: XLA's and PyTorch's rsqrt may differ by an ulp) with the
frozen (None-gradient) leaves, the Wasserstein loss, and the bridge round
trip of a whole WGAN train state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagegeneration_tpu.models import wgan as jm
from imagegeneration_tpu.train import common as jcommon
from imagegeneration_tpu.train import wgan_step as jstep
from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.core import rng as trng
from imagegeneration_tpu_torch.models import wgan as tm
from imagegeneration_tpu_torch.nn import layers as tl
from imagegeneration_tpu_torch.train import common as tcommon
from imagegeneration_tpu_torch.train import wgan_step as tstep

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
IMAGE = (32, 48, 3)


def _configs():
    return (jm.WGANConfig(image_size=IMAGE, base_width=16),
            tm.WGANConfig(image_size=IMAGE, base_width=16))


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _stats_close(model, want):
    got = bridge.flax_variables(model)["batch_stats"]
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("train", [True, False])
def test_generator_forward_matches_flax(train):
    jcfg, tcfg = _configs()
    z = np.random.default_rng(0).normal(size=(2, 128)).astype(np.float32)
    gen_j = jm.Generator(jcfg)
    v = jax.device_get(gen_j.init(jax.random.key(0), jnp.zeros((1, 128)), train=False))
    # running statistics away from their (0, 1) start
    v = {**v, "batch_stats": jax.tree.map(lambda x: np.asarray(x) + 0.25, v["batch_stats"])}
    want, mut = gen_j.apply(v, jnp.asarray(z), train=train, mutable=["batch_stats"])
    gen_t = tm.Generator(tcfg)
    bridge.load_flax_variables(gen_t, v)
    with torch.no_grad():
        got = gen_t(torch.from_numpy(z), train=train)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 32, 48)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)
    _stats_close(gen_t, mut["batch_stats"])


@pytest.mark.parametrize("train", [True, False])
def test_critic_forward_matches_flax(train):
    jcfg, tcfg = _configs()
    x = np.random.default_rng(1).uniform(-1, 1, (2, *IMAGE)).astype(np.float32)
    critic_j = jm.Critic(jcfg)
    v = jax.device_get(critic_j.init(jax.random.key(1), jnp.zeros((1, *IMAGE)), train=False))
    v = {**v, "batch_stats": jax.tree.map(lambda x: np.asarray(x) + 0.25, v["batch_stats"])}
    want, mut = critic_j.apply(v, jnp.asarray(x), train=train, mutable=["batch_stats"])
    critic_t = tm.Critic(tcfg)
    bridge.load_flax_variables(critic_t, v)
    with torch.no_grad():
        got = critic_t(_nchw(x), train=train)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _stats_close(critic_t, mut["batch_stats"])


def test_flax_names_and_plain_conv_head():
    """The port's leaves carry the flax paths; `to_rgb` is a plain Conv
    (`to_rgb/Conv_0`, 3x3, HWIO), not the SNDCGAN ConvTranspose override."""
    jcfg, tcfg = _configs()
    gen, critic = tm.make_models(tcfg)
    g_vars = jm.Generator(jcfg).init(jax.random.key(0), jnp.zeros((1, 128)), train=False)
    c_vars = jm.Critic(jcfg).init(jax.random.key(1), jnp.zeros((1, *IMAGE)), train=False)
    for model, want in ((gen, g_vars), (critic, c_vars)):
        got = bridge.flax_variables(model)
        assert jax.tree.structure(got) == jax.tree.structure(jax.device_get(want))
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.shape == b.shape
    assert bridge.flax_variables(gen)["params"]["to_rgb"]["Conv_0"]["kernel"].shape == (
        3, 3, 2, 3)


def test_clip_targets_only_conv_kernels():
    """tests/test_wgan.py:43-58 on the port: the seven conv weights are
    clipped to +-0.01; their biases, BN and the Dense head are not."""
    _, tcfg = _configs()
    critic = tm.Critic(tcfg)
    with torch.no_grad():
        for p in critic.parameters():
            p.fill_(0.5)
    tm.clip_critic_kernels_(critic)
    kernels = {id(p) for p in tm.critic_kernels(critic)}
    assert len(kernels) == 7
    for name, p in critic.named_parameters():
        want = np.float32(0.01) if id(p) in kernels else 0.5
        assert name.endswith(".weight") == (id(p) in kernels or name == "head.weight"), name
        assert torch.all(p == want), name
    assert torch.all(critic.conv0.weight == 0.01) and torch.all(critic.conv0.bias == 0.5)
    assert torch.all(critic.conv0_bn.scale == 0.5) and torch.all(critic.head.weight == 0.5)
    with torch.no_grad():
        critic.conv3.weight.fill_(-0.7)
    tm.clip_critic_kernels_(critic)
    assert torch.all(critic.conv3.weight == np.float32(-0.01))


def test_bn_params_are_the_mask_of_the_gan_update():
    """`critic_bn_params` is JAX's `critic_bn_mask`: every BN scale and bias
    of the critic, and nothing else."""
    jcfg, tcfg = _configs()
    critic = tm.Critic(tcfg)
    v = jm.Critic(jcfg).init(jax.random.key(0), jnp.zeros((1, *IMAGE)), train=False)
    mask = jm.critic_bn_mask(v["params"])
    selected = {id(p) for p in tm.critic_bn_params(critic)}
    by_name = dict(critic.named_parameters())
    leaves = bridge.leaves(critic)
    n_true = 0
    for leaf in leaves:
        if leaf.collection != "params":
            continue
        m = mask
        for k in leaf.path:
            m = m[k]
        assert (id(by_name[leaf.torch_name]) in selected) == bool(m), leaf.torch_name
        n_true += bool(m)
    assert n_true == len(selected) == 14


def test_normal_002_initializer():
    """Keras RandomNormal(stddev=0.02): N(0, 0.02), drawn in the contiguous
    order and stored channels_last, as the glorot rule; an unknown name is
    refused."""
    gen = torch.Generator().manual_seed(0)
    conv = tl.Conv(64, 128, (4, 4), (2, 2), generator=gen, kernel_init="normal_002")
    w = conv.weight.detach()
    assert w.is_contiguous(memory_format=torch.channels_last)
    assert abs(w.mean().item()) < 1e-3 and w.std().item() == pytest.approx(0.02, rel=0.02)
    same = torch.empty(128, 64, 4, 4).normal_(0.0, 0.02, generator=torch.Generator().manual_seed(0))
    assert torch.equal(w, same)
    convt = tl.ConvTranspose(64, 32, (4, 4), (2, 2), use_bias=False,
                             generator=torch.Generator().manual_seed(1), kernel_init="normal_002")
    assert convt.weight.std().item() == pytest.approx(0.02, rel=0.05)
    with pytest.raises(ValueError, match="kernel_init"):
        tl.Conv(3, 4, (3, 3), kernel_init="he_normal")
    # the models draw every conv of both nets this way
    _, tcfg = _configs()
    gen_t, critic_t = tm.make_models(tcfg)
    for w in tm.critic_kernels(critic_t) + [gen_t.up0.weight, gen_t.to_rgb.weight]:
        assert w.abs().max().item() < 0.02 * 7


def test_rmsprop_matches_optax_with_frozen_leaves():
    """rmsprop_apply = optax.rmsprop(lr, decay=0.9, eps=1e-7) on the same
    leaves over three applies; a None gradient is a zero one: its nu decays
    by 0.9 per apply and its parameter keeps every bit."""
    rng = np.random.default_rng(2)
    shapes = [(5, 3, 3, 4), (7,), (6, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    nu0 = [rng.uniform(0, 1e-3, size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 10.0 ** rng.integers(-6, 2)
              for s in shapes] for _ in range(3)]
    lr = 5e-5
    tx = optax.rmsprop(lr, decay=0.9, eps=1e-7)
    jp = tuple(jnp.asarray(p) for p in params)
    js = tx.init(jp)
    js = (js[0]._replace(nu=tuple(jnp.asarray(n) for n in nu0)),) + tuple(js[1:])
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = tcommon.rmsprop_init(tp)
    ts.load_state_dict({"nu": [torch.from_numpy(n) for n in nu0]})
    frozen_before = tp[1].clone()
    for g in grads:
        g_j = (g[0], np.zeros_like(g[1]), g[2])  # leaf 1 frozen
        upd, js = tx.update(tuple(jnp.asarray(x) for x in g_j), js, jp)
        jp = optax.apply_updates(jp, upd)
        tcommon.rmsprop_apply(tp, [torch.from_numpy(g[0]), None, torch.from_numpy(g[2])],
                              ts, lr)
    assert torch.equal(tp[1], frozen_before)
    np.testing.assert_array_equal(ts.nu[1].numpy(), np.asarray(js[0].nu[1]))
    np.testing.assert_allclose(ts.nu[1].numpy(), nu0[1] * 0.9**3, rtol=1e-6)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)
    for a, b in zip(ts.nu, js[0].nu):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_rmsprop_state_keeps_each_parameter_layout():
    w = tl.conv_weight((4, 3, 3, 3), torch.Generator().manual_seed(0))
    state = tcommon.rmsprop_init([w, torch.zeros(4)])
    assert state.nu[0].is_contiguous(memory_format=torch.channels_last)
    assert state.nu[0].dtype == torch.float32 and not state.nu[0].any()


def test_wasserstein_loss_matches_jax():
    y = np.asarray([[1.0], [-1.0], [1.0], [-1.0]], np.float32)
    p = np.asarray([[2.0], [4.0], [-0.5], [1.5]], np.float32)
    want = float(jcommon.wasserstein_loss(jnp.asarray(y), jnp.asarray(p)))
    got = tcommon.wasserstein_loss(torch.from_numpy(y), torch.from_numpy(p))
    assert got.dtype == torch.float32 and float(got) == want == -1.0
    bf = tcommon.wasserstein_loss(torch.from_numpy(y), torch.from_numpy(p).bfloat16())
    assert bf.dtype == torch.float32


def test_normal_z_is_a_seeded_standard_normal():
    z1 = trng.normal_z(trng.KeyChain(3).generator("z"), 4096, 128, "cpu")
    z2 = trng.normal_z(trng.KeyChain(3).generator("z"), 4096, 128, "cpu")
    assert z1.shape == (4096, 128) and z1.dtype == torch.float32 and torch.equal(z1, z2)
    assert abs(z1.mean().item()) < 0.01 and z1.std().item() == pytest.approx(1.0, rel=0.01)


def _jax_state_dict(s):
    return {"step": s.step, "critic_count": s.critic_count,
            "g_params": s.g_params, "g_batch_stats": s.g_batch_stats,
            "c_params": s.c_params, "c_batch_stats": s.c_batch_stats,
            "c_opt": {"nu": s.c_opt[0].nu}, "gan_opt": {"nu": s.gan_opt[0].nu}}


def test_train_state_round_trip_is_exact():
    """JAX init_state (every collection made distinct) -> port -> JAX: exact,
    and the gan optimizer's nu spans every G and critic leaf."""
    jcfg, tcfg = _configs()
    want = _jax_state_dict(jax.device_get(jstep.init_state(
        jstep.WGANTrainConfig(model=jcfg, batch_size=2))))
    rng = np.random.default_rng(4)
    want = jax.tree.map(lambda x: np.asarray(x) + rng.uniform(0.1, 1.0, np.shape(x)).astype(
        np.asarray(x).dtype) if np.asarray(x).dtype.kind == "f" else np.asarray(x), want)
    want["step"], want["critic_count"] = np.asarray(7, np.int32), np.asarray(3, np.int32)
    state = tstep.init_state(tstep.WGANTrainConfig(model=tcfg, batch_size=2), "cpu")
    n_g, n_c = len(list(state.gen.parameters())), len(list(state.critic.parameters()))
    assert len(state.gan_opt.nu) == n_g + n_c and len(state.c_opt.nu) == n_c
    bridge.load_jax_wgan_state(state, want)
    assert int(state.step) == 7 and state.critic_count == 3
    got = bridge.jax_wgan_state(state)
    la, lb = jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, a), (_, b) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))
    # copies, not views: a later in-place step leaves the snapshot alone
    before = got["c_opt"]["nu"]["head"]["Dense_0"]["kernel"].copy()
    with torch.no_grad():
        state.c_opt.nu[-2].add_(1.0)
    np.testing.assert_array_equal(got["c_opt"]["nu"]["head"]["Dense_0"]["kernel"], before)
