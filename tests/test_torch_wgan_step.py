"""The ported WGAN train step vs the JAX step, and the engine and CLI on CPU.

Both steps take the same uint8 batches and latents (numpy, seeded; the JAX
step is fed the same `z_fake`/`z_gan`), at 32x48, base_width 16, batch 2,
n_critic 2, so that 4 steps run two gan updates (did_gan_update [0, 1, 0,
1]). The JAX steps are built and run once per module (a module-scoped
fixture) in float64, with x64 enabled for the fixture only (parameters and
RMSprop state stay float32); the port runs in float64 too. The gan
optimizer's nu starts from positive values (the same on both sides), so
the frozen critic leaves' nu visibly decays by 0.9 per gan update.

The trajectory itself is ill-conditioned: RMSprop moves every entry by
about sqrt(10) * lr whatever the size of its gradient, and the critic's
clipped convs feed BatchNorm over 2 images. On the port alone, one float32
ulp on 1% of one conv weight moves the fourth step's g_loss by 5e-3
(relative) and the critic's BN biases by 3% of their largest value. So
the step is held against JAX step by step: each port step starts from the
JAX state before it (bridged) and its result is compared with the JAX state
after it. A free run of all four steps is held to the exact cadence and
counters and to the critic losses.

Tolerances, per step:
- metrics: rtol 1e-4 (abs 1e-6); `step`, `critic_count`, `did_gan_update`:
  exact. Free run: the critic losses rtol 1e-4.
- parameters: 1e-5 (abs + rel) per entry, except RMSprop sign flips on
  near-zero gradients: at most 0.5% of a leaf's entries, each within
  2 * sqrt(10) * lr per apply that leaf had in the step. A leaf the step
  does not update is bit-equal.
- BN running statistics (float32): 1e-5 (abs + rel).
- nu of both optimizers: 1e-4 of the leaf's largest value. A critic conv
  bias feeds a BatchNorm, so its exact gradient is 0 and its critic nu is
  rounding noise on both sides: for those, below 1e-12 of the tree's
  largest nu.
The gradient-penalty step (gp_lambda 10, n_critic 1, 2 steps) takes the
JAX package's own interpolation weights: split(fold_in(KeyChain(seed).
stream("z"), step), 3)[2], uniform (B, 1, 1, 1).
"""

import json
import pickle

import jax
import numpy as np
import pytest
import torch

from imagegeneration_tpu.core import rng as jrng
from imagegeneration_tpu.models.wgan import WGANConfig as JaxModelConfig
from imagegeneration_tpu.train import wgan_step as jstep
from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.cli import wgan_trainer
from imagegeneration_tpu_torch.core import checkpoint as ckptlib
from imagegeneration_tpu_torch.core import data as datalib
from imagegeneration_tpu_torch.core import preview as tpreview
from imagegeneration_tpu_torch.models.wgan import WGANConfig
from imagegeneration_tpu_torch.models.wgan import critic_kernels as tm_critic_kernels
from imagegeneration_tpu_torch.ops import adam as tadam
from imagegeneration_tpu_torch.ops import dropout as tdropout
from imagegeneration_tpu_torch.ops import instance_norm as tin
from imagegeneration_tpu_torch.train import wgan_engine
from imagegeneration_tpu_torch.train import wgan_step as tstep

torch.set_num_threads(1)

STEPS, GP_STEPS = 4, 2
BF16_DRAWS = 4
IMAGE = (32, 48, 3)
B = 2
LR = 5e-5
MODEL = dict(image_size=IMAGE, base_width=16)
FLIP = 2 * np.sqrt(10.0) * LR


def _inputs(steps):
    rng = np.random.default_rng(7)
    batches = rng.integers(0, 256, (steps, B, *IMAGE), dtype=np.uint8)
    z_fake = rng.normal(size=(steps, B, 128)).astype(np.float32)
    z_gan = rng.normal(size=(steps, B, 128)).astype(np.float32)
    return batches, z_fake, z_gan


def _as_dict(s):
    return {"step": s.step, "critic_count": s.critic_count,
            "g_params": s.g_params, "g_batch_stats": s.g_batch_stats,
            "c_params": s.c_params, "c_batch_stats": s.c_batch_stats,
            "c_opt": {"nu": s.c_opt[0].nu}, "gan_opt": {"nu": s.gan_opt[0].nu}}


def _jax_steps(cfg, steps, seed_gan_nu):
    state = jstep.init_state(cfg)
    if seed_gan_nu:
        rng = np.random.default_rng(8)
        nu = jax.tree.map(lambda x: rng.uniform(5e-3, 1.5e-2, np.shape(x)).astype(np.float32),
                          state.gan_opt[0].nu)
        state = state.replace(gan_opt=(state.gan_opt[0]._replace(nu=nu), *state.gan_opt[1:]))
    step = jax.jit(jstep.make_train_step(cfg))
    batches, z_fake, z_gan = _inputs(steps)
    states, metrics = [_as_dict(jax.device_get(state))], []
    for i in range(steps):
        state, m = step(state, batches[i], z_fake[i], z_gan[i])
        states.append(_as_dict(jax.device_get(state)))
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


@pytest.fixture(scope="module")
def jax_run():
    """{"clip": (states 0..STEPS, metrics), "gp": (states, metrics, gp_eps)}
    of the JAX step in float64, as numpy trees."""
    old_x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        model = JaxModelConfig(**MODEL, dtype=jax.numpy.float64)
        clip = _jax_steps(jstep.WGANTrainConfig(model=model, batch_size=B, n_critic=2),
                          STEPS, seed_gan_nu=True)
        gp_cfg = jstep.WGANTrainConfig(model=model, batch_size=B, n_critic=1, gp_lambda=10.0)
        gp = _jax_steps(gp_cfg, GP_STEPS, seed_gan_nu=False)
        stream = jrng.KeyChain(gp_cfg.seed).stream("z")
        eps = [np.asarray(jax.random.uniform(
            jax.random.split(jax.random.fold_in(stream, i), 3)[2], (B, 1, 1, 1)))
            for i in range(GP_STEPS)]
        assert eps[0].dtype == np.float64
        return {"clip": clip, "gp": (*gp, eps)}
    finally:
        jax.config.update("jax_enable_x64", old_x64)


def _port_cfg(**kw):
    return tstep.WGANTrainConfig(model=WGANConfig(**MODEL, dtype=torch.float64),
                                 batch_size=B, **kw)


def _port_state(cfg, jax_state):
    state = tstep.init_state(cfg, "cpu")
    bridge.load_jax_wgan_state(state, jax_state)
    return state


def _leaves(got, want, name):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w], name
    for (path, a), (_, b) in zip(flat_g, flat_w):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        where = f"{name}{jax.tree_util.keystr(path)}"
        assert a.shape == b.shape, where
        yield where, np.abs(a - b), b


def _check_params(got, want, name, applies, flip=FLIP):
    for where, err, b in _leaves(got, want, name):
        n = applies(where)
        if n == 0:
            assert not err.any(), f"{where}: not updated, yet differs"
            continue
        out = err > 1e-5 + 1e-5 * np.abs(b)
        assert out.mean() <= 0.005, f"{where}: {out.mean():.4%} beyond 1e-5"
        assert err.max(initial=0) <= n * flip + 1e-5, f"{where}: {err.max()}"


def _feeds_bn(where):
    return "['Conv_0']['bias']" in where


def _check_nu(got, want, name, noisy_biases):
    tree_max = max(np.abs(np.asarray(b)).max() for b in jax.tree.leaves(want))
    for where, err, b in _leaves(got, want, name):
        bound = (1e-12 * tree_max if noisy_biases and _feeds_bn(where)
                 else 1e-4 * np.abs(b).max())
        assert err.max(initial=0) <= bound, f"{where}: {err.max()} > {bound}"


def _check_stats(got, want, name):
    for where, err, b in _leaves(got, want, name):
        assert not (err > 1e-5 + 1e-5 * np.abs(b)).any(), f"{where}: {err.max()}"


@pytest.mark.parametrize("mode", ["clip", "gp"])
def test_each_step_matches_jax(jax_run, mode):
    """Each port step from the JAX state before it against the JAX state
    after it: metrics, counters, parameters, BN statistics and both nu."""
    if mode == "clip":
        (states, metrics), cfg, gp_eps = jax_run["clip"], _port_cfg(n_critic=2), None
    else:
        states, metrics, gp_eps = jax_run["gp"]
        cfg = _port_cfg(n_critic=1, gp_lambda=10.0)
    batches, z_fake, z_gan = _inputs(len(metrics))
    step = tstep.make_train_step(cfg)
    for i, want_m in enumerate(metrics):
        state = _port_state(cfg, states[i])
        eps = None if gp_eps is None else torch.from_numpy(np.array(gp_eps[i]))
        state, m = step(state, torch.from_numpy(batches[i]), torch.from_numpy(z_fake[i]),
                        torch.from_numpy(z_gan[i]), gp_eps=eps)
        assert set(m) == set(want_m) == set(tstep.METRIC_KEYS)
        assert m["g_loss"].dtype == m["did_gan_update"].dtype == torch.float32
        for k, v in want_m.items():
            assert float(m[k]) == pytest.approx(v, rel=1e-4, abs=1e-6), f"step {i} {k}"
        got, want = bridge.jax_wgan_state(state), states[i + 1]
        assert int(got["step"]) == int(want["step"]) == i + 1
        assert int(got["critic_count"]) == int(want["critic_count"])
        gan = want_m["did_gan_update"] == 1.0
        _check_params(got["c_params"], want["c_params"], f"step {i} c_params",
                      lambda w: 2 + (gan and "_bn" in w))
        _check_params(got["g_params"], want["g_params"], f"step {i} g_params",
                      lambda w: int(gan))
        for key in ("g_batch_stats", "c_batch_stats"):
            _check_stats(got[key], want[key], f"step {i} {key}")
        _check_nu(got["c_opt"]["nu"], want["c_opt"]["nu"], f"step {i} c_nu", True)
        _check_nu(got["gan_opt"]["nu"], want["gan_opt"]["nu"], f"step {i} gan_nu", False)
    if mode == "clip":
        assert [m["did_gan_update"] for m in metrics] == [0.0, 1.0, 0.0, 1.0]
    else:
        assert [m["did_gan_update"] for m in metrics] == [1.0, 1.0]


def test_free_run_keeps_the_cadence_and_decays_frozen_nu(jax_run):
    """Four steps in a row from the JAX initial state: the cadence and the
    counters are exact, the critic losses within 1e-4, and the frozen
    critic leaves' gan nu is 0.9^2 of its start, bit-equal to JAX."""
    states, metrics = jax_run["clip"]
    cfg = _port_cfg(n_critic=2)
    state = _port_state(cfg, states[0])
    step = tstep.make_train_step(cfg)
    for i, (batch, zf, zg) in enumerate(zip(*_inputs(STEPS))):
        state, m = step(state, torch.from_numpy(batch), torch.from_numpy(zf),
                        torch.from_numpy(zg))
        assert float(m["did_gan_update"]) == metrics[i]["did_gan_update"]
        assert state.critic_count == int(states[i + 1]["critic_count"])
        assert int(state.step) == i + 1
        for k in ("c_loss_real", "c_loss_fake"):
            assert float(m[k]) == pytest.approx(metrics[i][k], rel=1e-4), f"step {i} {k}"
        if not metrics[i]["did_gan_update"]:
            assert float(m["g_loss"]) == 0.0
    got = bridge.jax_wgan_state(state)["gan_opt"]["nu"][1]
    want, start = states[-1]["gan_opt"]["nu"][1], states[0]["gan_opt"]["nu"][1]
    for i in range(7):
        for leaf in ("kernel", "bias"):
            a = got[f"conv{i}"]["Conv_0"][leaf]
            np.testing.assert_array_equal(a, want[f"conv{i}"]["Conv_0"][leaf])
            np.testing.assert_allclose(a, start[f"conv{i}"]["Conv_0"][leaf] * 0.81, rtol=1e-6)
    np.testing.assert_array_equal(got["head"]["Dense_0"]["kernel"],
                                  want["head"]["Dense_0"]["kernel"])


def test_gan_update_leaves_frozen_critic_weights_bit_equal(jax_run):
    """One step from the same state, with a gan update (n_critic 2,
    critic_count 1) and without (n_critic 99): the critic's conv weights,
    conv biases and head are bit-equal, its BN scale and bias are not."""
    start = jax_run["clip"][0][1]  # after one step: critic_count 1
    batch, zf, zg = (torch.from_numpy(a[1]) for a in _inputs(2))
    states = []
    for n_critic in (2, 99):
        cfg = _port_cfg(n_critic=n_critic)
        state, m = tstep.make_train_step(cfg)(_port_state(cfg, start), batch, zf, zg)
        assert float(m["did_gan_update"]) == float(n_critic == 2)
        states.append(state)
    with_gan, without = (dict(s.critic.named_parameters()) for s in states)
    bn = {n for n in with_gan if "_bn." in n}
    assert len(bn) == 14
    for name, p in with_gan.items():
        assert torch.equal(p, without[name]) != (name in bn), name


@pytest.fixture(scope="module")
def jax_bf16_draws():
    """The JAX bfloat16 step (n_critic 1: both critic updates and the gan
    update) from its initial state on BF16_DRAWS seeded inputs: (initial
    state, [(inputs, metrics, state after)])."""
    cfg = jstep.WGANTrainConfig(model=JaxModelConfig(**MODEL, dtype=jax.numpy.bfloat16),
                                batch_size=B, n_critic=1)
    state = jstep.init_state(cfg)
    step = jax.jit(jstep.make_train_step(cfg))
    draws = []
    for d in range(BF16_DRAWS):
        rng = np.random.default_rng(100 + d)
        inputs = (rng.integers(0, 256, (B, *IMAGE), dtype=np.uint8),
                  rng.normal(size=(B, 128)).astype(np.float32),
                  rng.normal(size=(B, 128)).astype(np.float32))
        after, m = step(state, *inputs)
        draws.append((inputs, {k: float(v) for k, v in m.items()},
                      _as_dict(jax.device_get(after))))
    return _as_dict(jax.device_get(state)), draws


def _update_misses(got, want, start):
    """Entries of the parameter trees whose update differs from `want`'s
    by more than 1e-5 (abs + rel), and the count of entries."""
    misses = total = 0
    for (_, a), (_, b), (_, s) in zip(*(jax.tree_util.tree_leaves_with_path(t)
                                        for t in (got, want, start))):
        da = np.asarray(a, np.float64) - np.asarray(s, np.float64)
        db = np.asarray(b, np.float64) - np.asarray(s, np.float64)
        misses += int((np.abs(da - db) > 1e-5 + 1e-5 * np.abs(db)).sum())
        total += da.size
    return misses, total


def test_bf16_step_rounds_like_jax(jax_bf16_draws):
    """`--bf16`: bfloat16 compute, float32 parameters, statistics and
    optimizer state. Per draw: counters, dtypes and the clip exact. bf16
    noise at this size is large for both packages (a fake-batch loss moves
    by up to 0.6 from the float64 step), so the numbers are held against
    the float64 step (the port's, held to the JAX float64 step above): over
    the draws, the port's bf16 losses and parameter updates are no further
    from it than the JAX package's bf16 step, up to a factor of 2. That
    catches a wrong update or a lost cast of the state, not a single extra
    bf16 rounding, which this noise hides. A gradient-penalty bf16 step
    (double backward in bf16) runs to finite float32 losses."""
    start, draws = jax_bf16_draws
    steps = {}
    for dt in (torch.bfloat16, torch.float64):
        cfg = tstep.WGANTrainConfig(model=WGANConfig(**MODEL, dtype=dt), batch_size=B,
                                    n_critic=1)
        steps[dt] = cfg, tstep.make_train_step(cfg)
    loss_err = {"port": [], "jax": []}
    misses = {"port": 0, "jax": 0}
    for inputs, want_m, want in draws:
        out = {}
        for dt, (cfg, step) in steps.items():
            state, m = step(_port_state(cfg, start), *map(torch.from_numpy, inputs))
            out[dt] = state, {k: float(v) for k, v in m.items()}
            assert all(v.dtype == torch.float32 for v in m.values())
        state, m = out[torch.bfloat16]
        assert m["did_gan_update"] == want_m["did_gan_update"] == 1.0
        assert int(state.step) == 1 and state.critic_count == 0
        tensors = [*state.gen.parameters(), *state.critic.parameters(),
                   *state.gen.buffers(), *state.critic.buffers(),
                   *state.c_opt.nu, *state.gan_opt.nu]
        assert {t.dtype for t in tensors} == {torch.float32}
        for w in tm_critic_kernels(state.critic):
            assert w.abs().max() <= 0.01
        sample = tstep.make_sampler(steps[torch.bfloat16][0])(state, torch.zeros(1, 128))
        assert sample.dtype == torch.float32
        truth_state, truth = out[torch.float64]
        for k in ("c_loss_real", "c_loss_fake", "g_loss"):
            loss_err["port"].append(abs(m[k] - truth[k]) / (abs(truth[k]) + 1))
            loss_err["jax"].append(abs(want_m[k] - truth[k]) / (abs(truth[k]) + 1))
        truth_tree = bridge.jax_wgan_state(truth_state)
        got = bridge.jax_wgan_state(state)
        for key in ("g_params", "c_params"):
            n, total = _update_misses(got[key], truth_tree[key], start[key])
            misses["port"] += n
            n, _ = _update_misses(want[key], truth_tree[key], start[key])
            misses["jax"] += n
    assert np.mean(loss_err["port"]) <= 2 * np.mean(loss_err["jax"])
    assert misses["port"] <= 2 * misses["jax"]

    cfg = tstep.WGANTrainConfig(model=WGANConfig(**MODEL, dtype=torch.bfloat16),
                                batch_size=B, n_critic=1, gp_lambda=10.0)
    state, m = tstep.make_train_step(cfg)(_port_state(cfg, start),
                                          *map(torch.from_numpy, draws[0][0]))
    assert all(v.dtype == torch.float32 and torch.isfinite(v) for v in m.values())
    assert {p.dtype for p in state.critic.parameters()} == {torch.float32}


# The bf16 BatchNorm gate: the batch statistics of a bf16 (B, H, W, C) map
# against JAX's, per channel, the mean's error over the channel's std and
# the variance's over the variance. Readings on the CPU: sound 2.4e-6
# (mean) and 3.9e-5 (var: float32 sums of 16,384 squares in another
# order); statistics taken in bf16 (the planted fault) 3.9e-3 and 2.2e-2.
# The bound is 5x the sound reading and 19x under the fault's.
BN_SHAPE = (16, 32, 32, 64)
BN_STAT_BOUND = 2e-4


def _bn_statistics(x: np.ndarray) -> dict:
    """The port's BatchNorm on `x` (NHWC float32, cast to bf16) in train mode
    with momentum 0, whose running statistics are then the batch's."""
    from imagegeneration_tpu_torch.nn import layers as tl

    bn = tl.BatchNorm(x.shape[-1], momentum=0.0, dtype=torch.bfloat16)
    xb = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    with torch.no_grad():
        bn(xb, use_running_average=False)
    return {"mean": bn.mean.numpy().copy(), "var": bn.var.numpy().copy()}


def test_bf16_batchnorm_statistics_are_float32_like_jax(monkeypatch):
    """`--bf16` BatchNorm alone: on a bf16 map of 16,384 values a channel
    (mean 3, std 2, so that E[x^2] - E[x]^2 cancels part of its digits), the
    port's batch statistics (float32 buffers) are the JAX BatchNorm's
    (flax, statistics in float32 from the bf16 input) within BN_STAT_BOUND
    of each channel's std (mean) and variance (var); statistics taken in
    bf16 (one more rounding of
    E[x] and E[x^2]: the planted fault, `moments_plain` on a bf16 copy) miss it
    by >= 10x. test_bf16_step_rounds_like_jax cannot see that rounding
    through a whole step's bf16 noise."""
    import jax.numpy as jnp

    from imagegeneration_tpu.nn.layers import BatchNorm as JaxBatchNorm
    from imagegeneration_tpu_torch.ops import batch_norm as bn_ops

    x = np.random.default_rng(31).normal(3.0, 2.0, BN_SHAPE).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    assert np.array_equal(np.asarray(jx.astype(jnp.float32)),
                          torch.from_numpy(x).to(torch.bfloat16).float().numpy())
    jbn = JaxBatchNorm(use_running_average=False, momentum=0.0, dtype=jnp.bfloat16)
    variables = jbn.init(jax.random.key(0), jx)
    _, upd = jbn.apply(variables, jx, mutable=["batch_stats"])
    want = {k: np.asarray(v) for k, v in upd["batch_stats"]["BatchNorm_0"].items()}
    assert {v.dtype for v in want.values()} == {np.dtype(np.float32)}

    scale = {"mean": np.sqrt(want["var"]), "var": want["var"]}

    def errors(got):
        return {k: float(np.max(np.abs(got[k].astype(np.float64) - want[k]) / scale[k]))
                for k in ("mean", "var")}

    sound = errors(_bn_statistics(x))
    moments = bn_ops.moments_plain
    monkeypatch.setattr(bn_ops, "moments_plain",
                        lambda xf, group=None: moments(xf.to(torch.bfloat16), group))
    planted = errors(_bn_statistics(x))
    assert max(sound.values()) <= BN_STAT_BOUND, sound
    assert min(planted.values()) >= 10 * BN_STAT_BOUND, planted


def test_epoch_runner_equals_per_batch_stepping():
    cfg = tstep.WGANTrainConfig(model=WGANConfig(**MODEL), batch_size=B, n_critic=2)
    images = torch.from_numpy(
        np.random.default_rng(5).integers(0, 256, (8, *IMAGE), dtype=np.uint8))
    perm = torch.tensor([[3, 1], [0, 7], [2, 6], [5, 4]])
    stepped = tstep.init_state(cfg, "cpu")
    step = tstep.make_train_step(cfg)
    per_step = []
    for b in range(4):
        stepped, m = step(stepped, images[perm[b]])
        per_step.append(m)
    run, metrics = tstep.make_epoch_runner(cfg)(tstep.init_state(cfg, "cpu"), images, perm)
    for k in tstep.METRIC_KEYS:
        assert torch.equal(metrics[k], torch.stack([m[k] for m in per_step])), k
    assert metrics["did_gan_update"].tolist() == [0.0, 1.0, 0.0, 1.0]
    assert run.critic_count == stepped.critic_count == 0 and int(run.step) == 4
    for a, b in zip(run.gen.parameters(), stepped.gen.parameters()):
        assert torch.equal(a, b)
    sample = tstep.make_sampler(cfg)(run, torch.zeros(3, 128))
    assert sample.shape == (3, *IMAGE) and 0.0 <= sample.min() and sample.max() <= 1.0


# ------------------------------------------------------------------ engine
@pytest.fixture()
def no_figures(monkeypatch):
    """The engine as on a machine without matplotlib: the 10x10 sample sheet
    takes seconds per epoch on the CPU, and the figures are held to the JAX
    package in tests/test_torch_preview.py (the CLI test below draws them)."""
    monkeypatch.setattr(tpreview, "matplotlib_available", lambda skipped: False)


def _engine(out, load=False, n_images=6):
    return wgan_engine.WGANEngine(
        datalib.SyntheticImageDataset(n_images, IMAGE[:2]), IMAGE, B,
        critic_learn_iterations=2, path_like=str(out), load=load,
        device=torch.device("cpu"), base_width=16)


def test_fold_metrics_follows_the_reference_windows(tmp_path):
    """c1/c2 are averaged over the window that ends at each gan update and
    appended with that update's g; an open window carries across epochs
    of one train() call and is dropped by the next call."""
    eng = _engine(tmp_path / "w")
    eng._fold_metrics([1.0, 2.0, 3.0], [10.0, 20.0, 30.0], [0.0, 5.0, 0.0], [0, 1, 0])
    eng._fold_metrics([4.0, 6.0], [40.0, 60.0], [0.0, 7.0], [0, 1])
    assert eng.loss_hist.data == {"c1_hist": [1.5, 13 / 3], "c2_hist": [15.0, 130 / 3],
                                  "g_hist": [5.0, 7.0]}
    eng._fold_metrics([8.0], [80.0], [0.0], [0])
    eng._c1_tmp, eng._c2_tmp = [], []  # what train() does on entry
    eng._fold_metrics([9.0], [90.0], [1.5], [1])
    assert eng.loss_hist.data["c1_hist"][-1] == 9.0 and eng.loss_hist.data["g_hist"][-1] == 1.5


@pytest.mark.usefixtures("no_figures")
def test_engine_resume_carries_critic_count_and_history(tmp_path, monkeypatch):
    """3 batches per epoch, n_critic 2: gan updates at steps 2, 4 and 6. The
    resumed engine restores step 3 and critic_count 1, so its first batch
    (step 4) runs a gan update; the new train() call drops the open window
    of step 3, so the second entry averages step 4 alone."""
    monkeypatch.setattr(datalib, "resident_budget", lambda device: 0)  # streaming
    out = tmp_path / "run"
    out.mkdir()
    (out / "stale.txt").write_text("wiped unless load")
    eng = _engine(out)
    assert not eng.resident and not (out / "stale.txt").exists()
    assert all((out / d).is_dir() for d in ("g_models", "c_models", "samples"))
    seen = []

    def recording(step):
        def run(*args):
            state, m = step(*args)
            seen.append(m)
            return state, m
        return run

    eng.feed.step = recording(eng.feed.step)
    eng.train(1)
    assert eng.epoch == 1 and int(eng.state.step) == 3 and eng.state.critic_count == 1
    resumed = _engine(out, load=True)
    assert resumed.epoch == 1 and int(resumed.state.step) == 3
    assert resumed.state.critic_count == 1
    resumed.feed.step = recording(resumed.feed.step)
    resumed.train(2)
    assert int(resumed.state.step) == 6 and resumed.state.critic_count == 0
    did = [float(m["did_gan_update"]) for m in seen]
    assert did == [0, 1, 0, 1, 0, 1]
    c1 = [float(m["c_loss_real"]) for m in seen]
    c2 = [float(m["c_loss_fake"]) for m in seen]
    hist = pickle.loads((out / "stats.pickle").read_bytes())
    assert hist["c1_hist"] == pytest.approx([np.mean(c1[0:2]), c1[3], np.mean(c1[4:6])])
    assert hist["c2_hist"] == pytest.approx([np.mean(c2[0:2]), c2[3], np.mean(c2[4:6])])
    assert hist["g_hist"] == pytest.approx([float(seen[i]["g_loss"]) for i in (1, 3, 5)])
    assert resumed.last_epoch_metrics["gan_updates"] == 2
    mgr = ckptlib.CheckpointManager(out / "checkpoints")
    assert mgr.all_epochs() == [1, 2]
    sd = mgr.restore()
    assert int(sd["step"]) == 6 and sd["critic_count"] == 0
    perf = [json.loads(line) for line in (out / "perf.jsonl").read_text().splitlines()]
    assert [p["epoch"] for p in perf] == [1, 2] and perf[0]["device"] == "cpu"
    assert tadam.LAUNCHES == {"adam": 0} and set(tdropout.LAUNCHES.values()) == {0}
    assert set(tin.LAUNCHES.values()) == {0}


@pytest.mark.usefixtures("no_figures")
def test_engine_resident_and_streaming_agree(tmp_path, monkeypatch):
    """Both data paths take the dataset's own permutation: one epoch gives
    the same metrics, weights and preview samples."""
    resident = _engine(tmp_path / "r", n_images=5)
    monkeypatch.setattr(datalib, "resident_budget", lambda device: 0)
    streaming = _engine(tmp_path / "s", n_images=5)
    assert resident.resident and not streaming.resident and resident.num_batches == 2
    for eng in (resident, streaming):
        eng.train(1)
    assert resident.last_epoch_metrics == streaming.last_epoch_metrics
    for a, b in zip(resident.state.critic.parameters(), streaming.state.critic.parameters()):
        assert torch.equal(a, b)
    imgs = resident.generate_fake_samples(3)
    assert imgs.shape == (3, *IMAGE) and imgs.min() >= 0.0 and imgs.max() <= 1.0
    np.testing.assert_array_equal(imgs, streaming.generate_fake_samples(3))


# --------------------------------------------------------------------- CLI
def test_cli_refuses_mesh_and_profile_flags(tmp_path, capsys):
    # data and spatial parallelism are ported (tests/test_torch_dp.py,
    # tests/test_torch_spatial.py), and --profile (test_cli_accepts_profile);
    # what stays refused: a spatial axis without a data axis, host sharding
    # without ranks, and more ranks than visible cards, which is never shrunk
    for flags, says in ((["--mesh-spatial", "2"], "needs --mesh-data >= 1"),
                        (["--host-sharded-data"], "needs --mesh-data")):
        with pytest.raises(SystemExit):
            wgan_trainer.main(["1", "1", "-d", str(tmp_path), *flags])
        assert says in capsys.readouterr().err
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="need 2 cards"):
            wgan_trainer.main(["1", "1", "-d", str(tmp_path), "--mesh-data", "2"])
    args = wgan_trainer.build_parser().parse_args(["4", "2", "-ct", "--gp", "10"])
    assert args.continue_ and args.gp_lambda == 10.0 and args.data == "bilderNeuro"
    assert (args.height, args.width, args.n_critic, args.device) == (144, 256, 5, "cuda")


def test_cli_trains_an_image_folder_on_the_cpu(tmp_path):
    from PIL import Image

    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(9)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)).save(
            data / f"i{i}.png")
    out = tmp_path / "out"
    wgan_trainer.main(["2", "1", "-x", str(data), "-d", str(out), "--height", "16",
                       "--width", "24", "--n-critic", "1", "--device", "cpu"])
    hist = pickle.loads((out / "stats.pickle").read_bytes())
    assert len(hist["g_hist"]) == 2 and np.isfinite(hist["c1_hist"]).all()
    assert ckptlib.CheckpointManager(out / "checkpoints").all_epochs() == [1]
    # the figures (matplotlib is installed here) and the params-only exports
    assert (out / "samples" / "generated_plot_0001.jpg").exists()
    assert (out / "plot_line_plot_loss_1.png").exists()
    assert [p.name for p in (out / "g_models").iterdir()] == ["model_0001.msgpack"]
    assert [p.name for p in (out / "c_models").iterdir()] == ["model_0001.msgpack"]


def test_cli_accepts_profile(tmp_path, monkeypatch):
    """--profile reaches the engine (whose trace test_engine_profile_traces_
    the_second_epoch holds)."""
    seen = {}

    class Engine:
        def __init__(self, *args, **kwargs):
            seen["profile"] = kwargs["profile"]

        def train(self, epochs):
            seen["epochs"] = epochs

    monkeypatch.setattr(wgan_engine, "WGANEngine", Engine)
    wgan_trainer.main(["2", "2", "-d", str(tmp_path), "--device", "cpu", "--profile"])
    assert seen == {"profile": True, "epochs": 2}
    wgan_trainer.main(["2", "2", "-d", str(tmp_path), "--device", "cpu"])
    assert seen == {"profile": False, "epochs": 2}


@pytest.mark.usefixtures("no_figures")
def test_engine_profile_traces_the_second_epoch(tmp_path):
    """Epochs count from 1: profile=True traces epoch 2 of a fresh run into
    <path>/traces, one file; a resumed run traces its own second epoch."""
    eng = wgan_engine.WGANEngine(
        datalib.SyntheticImageDataset(2, IMAGE[:2]), IMAGE, B, critic_learn_iterations=1,
        path_like=str(tmp_path / "w"), device=torch.device("cpu"), base_width=16,
        profile=True)
    eng.train(2)
    traces = sorted(p.name for p in (tmp_path / "w" / "traces").iterdir())
    assert traces == ["epoch_2.rank0.json"]
    events = json.loads((tmp_path / "w" / "traces" / traces[0]).read_text())["traceEvents"]
    assert any(e.get("ph") == "X" and e.get("cat") == "cpu_op" for e in events)
    resumed = wgan_engine.WGANEngine(
        datalib.SyntheticImageDataset(2, IMAGE[:2]), IMAGE, B, critic_learn_iterations=1,
        path_like=str(tmp_path / "w"), load=True, device=torch.device("cpu"),
        base_width=16, profile=True)
    resumed.train(4)  # epochs 3 and 4
    traces = sorted(p.name for p in (tmp_path / "w" / "traces").iterdir())
    assert traces == ["epoch_2.rank0.json", "epoch_4.rank0.json"]


LR_OTHER = 1e-3


@pytest.mark.usefixtures("no_figures")
def test_engine_learning_rate_reaches_the_step_and_matches_jax(tmp_path):
    """The engine's learning_rate is RMSprop's in its step (the reference's
    5e-5 by default): one float64 step at 1e-3 with a gan update (n_critic
    1), from the JAX state, against the JAX step at 1e-3."""
    default = _engine(tmp_path / "d")
    assert default.cfg.learning_rate == LR
    eng = wgan_engine.WGANEngine(
        datalib.SyntheticImageDataset(2, IMAGE[:2]), IMAGE, B, critic_learn_iterations=1,
        path_like=str(tmp_path / "w"), device=torch.device("cpu"), base_width=16,
        learning_rate=LR_OTHER, dtype=torch.float64)
    assert eng.cfg.learning_rate == LR_OTHER
    old_x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        cfg = jstep.WGANTrainConfig(
            model=JaxModelConfig(**MODEL, dtype=jax.numpy.float64), batch_size=B,
            n_critic=1, learning_rate=LR_OTHER)
        states, metrics = _jax_steps(cfg, 1, seed_gan_nu=True)
    finally:
        jax.config.update("jax_enable_x64", old_x64)
    assert metrics[0]["did_gan_update"] == 1.0
    batches, z_fake, z_gan = _inputs(1)
    state = _port_state(eng.cfg, states[0])
    state, m = tstep.make_train_step(eng.cfg)(
        state, torch.from_numpy(batches[0]), torch.from_numpy(z_fake[0]),
        torch.from_numpy(z_gan[0]))
    for k, v in metrics[0].items():
        assert float(m[k]) == pytest.approx(v, rel=1e-4, abs=1e-6), k
    got, want = bridge.jax_wgan_state(state), states[1]
    flip = 2 * np.sqrt(10.0) * LR_OTHER
    _check_params(got["c_params"], want["c_params"], "c_params",
                  lambda w: 2 + ("_bn" in w), flip)
    _check_params(got["g_params"], want["g_params"], "g_params", lambda w: 1, flip)
    for key in ("g_batch_stats", "c_batch_stats"):
        _check_stats(got[key], want[key], key)
    _check_nu(got["c_opt"]["nu"], want["c_opt"]["nu"], "c_nu", True)
    _check_nu(got["gan_opt"]["nu"], want["gan_opt"]["nu"], "gan_nu", False)
    # the step moved the weights by the larger rate: RMSprop's first steps
    # move an entry by ~sqrt(10) * lr
    moved = max(np.abs(np.asarray(a) - np.asarray(b)).max() for a, b in zip(
        jax.tree.leaves(want["g_params"]), jax.tree.leaves(states[0]["g_params"])))
    assert moved > 10 * np.sqrt(10.0) * LR
