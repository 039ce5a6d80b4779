"""The ported SNDCGAN train step vs the JAX step, three steps from one state.

Both sides start from the same weights (the JAX `init_state`, bridged),
take the same uint8 batches and latents (numpy, seeded) and the same
dropout key words: the JAX dropout is fed a fixed (21, 2) key table by
monkeypatching `bitdropout.hash_dropout` here, in site order (G pass 0-6,
D-real 7-13, D-fake 14-20). The JAX step uses `fused_adam="interpret"`, so
its conv5/conv6 leaves (>= 1M elements) go through the Pallas Adam kernel;
the port runs the plain versions of its kernels on the CPU.

Tolerances, float32 throughout:
- metrics: rtol 1e-4. Both sides compute the same expressions; convs and
  reductions sum in different orders (a few ulp per op), and the
  differences compound through three steps of updates.
- parameters: 1e-5 (abs + rel) on all but a bounded set of coordinates.
  Adam moves each coordinate by about lr * sign(g) whatever |g| is
  (m / (sqrt(v) + eps)), so a gradient that is ~0 on both sides can flip
  sign under ulp noise and move that coordinate by up to 2 * lr per step.
  Such outliers are allowed only up to 2 * lr * steps in size and on 0.5%
  of a leaf's coordinates.
- BN running statistics and spectral-norm `u`: 1e-5 (abs + rel).
- Adam moments: 3e-3 of the leaf's largest magnitude. The moments are
  gradient averages, and the generator's gradients pass through BatchNorm
  over a batch of 2, whose 1/sqrt(var + eps) amplifies reassociation noise
  to ~1e-3 of the gradient scale (measured up to 1.1e-3); a wrong update
  order, label or key word moves them by O(1) of the scale.
- count and step: exact.

With `opt_moments="bf16"` both sides store m and v in bfloat16 and update
them in float32; each moment is then within one bfloat16 ulp of JAX's or,
failing that, within the float32 moment bound above: those are moments
near 0 (a gradient that is ~0 on both sides), where the float32 noise of
~1e-3 of the leaf's scale is many bfloat16 ulps of the value. The rest is
held to the bounds above.
With `remat_d=True` (D on the fake batch recomputed in the backward) the
port's state is bit-equal to its own run without it, and within the
bounds above of JAX's remat_d step.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from imagegeneration_tpu.models.sndcgan import SNDCGANConfig as JaxModelConfig
from imagegeneration_tpu.ops import bitdropout
from imagegeneration_tpu.train import sndcgan_step as jstep
from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.models.sndcgan import SNDCGANConfig
from imagegeneration_tpu_torch.parallel import dp
from imagegeneration_tpu_torch.train import sndcgan_step as tstep

torch.set_num_threads(1)

STEPS = 3
BATCH = 2
IMAGE = (16, 16, 3)
LR = 2e-4
KW = np.random.default_rng(2024).integers(0, 2**32, (tstep.N_SITES, 2), dtype=np.uint64)


def _inputs():
    rng = np.random.default_rng(7)
    batches = rng.integers(0, 256, (STEPS, BATCH, *IMAGE), dtype=np.uint8)
    zs = rng.uniform(-1, 1, (STEPS, BATCH, 128)).astype(np.float32)
    return batches, zs


def _jax_run(loss, d_updates, spectral_norm, monkeypatch, **opts):
    calls = []

    def fixed_kw_dropout(key, x, rate, rounds=2):
        site = len(calls) % tstep.N_SITES
        calls.append(site)
        return bitdropout._hash_dropout_vjp(
            jax.numpy.asarray(KW[site].astype(np.uint32)), x, rate, rounds
        )

    monkeypatch.setattr(bitdropout, "hash_dropout", fixed_kw_dropout)
    cfg = jstep.SNDCGANTrainConfig(
        model=JaxModelConfig(image_size=IMAGE, base_width=16,
                             spectral_norm=spectral_norm),
        batch_size=BATCH, loss=loss, d_updates=d_updates, seed=62,
        fused_adam="interpret", **opts,
    )
    state0 = jstep.init_state(cfg)
    step = jax.jit(jstep.make_train_step(cfg))
    batches, zs = _inputs()
    state, metrics = state0, []
    for i in range(STEPS):
        state, m = step(state, batches[i], zs[i])
        metrics.append({k: float(v) for k, v in m.items()})
    assert calls == list(range(tstep.N_SITES)), "dropout sites traced out of order"
    return jax.device_get(state0), jax.device_get(state), metrics


def _port_run(loss, d_updates, spectral_norm, jax_state0, steps=STEPS, **opts):
    cfg = tstep.SNDCGANTrainConfig(
        model=SNDCGANConfig(image_size=IMAGE, base_width=16,
                            spectral_norm=spectral_norm),
        batch_size=BATCH, loss=loss, d_updates=d_updates, seed=62, **opts,
    )
    state = tstep.init_state(cfg, "cpu")
    bridge.load_jax_train_state(state, _as_dict(jax_state0))
    step = tstep.make_train_step(cfg)
    kw = torch.from_numpy(KW.astype(np.int64))
    batches, zs = _inputs()
    metrics = []
    for i in range(steps):
        state, m = step(state, torch.from_numpy(batches[i]),
                        torch.from_numpy(zs[i]), kw)
        metrics.append({k: float(v) for k, v in m.items()})
    return bridge.jax_train_state(state), metrics


def _as_dict(s):
    opt = lambda o: {"count": o.count, "mu": o.mu, "nu": o.nu}  # noqa: E731
    return {
        "step": s.step, "g_params": s.g_params, "g_batch_stats": s.g_batch_stats,
        "g_opt": opt(s.g_opt), "d_params": s.d_params, "d_spectral": s.d_spectral,
        "d_opt": opt(s.d_opt),
    }


def _bf16_ulps(a, b):
    """Per element, how many bfloat16 values lie between a and b (both
    bfloat16 arrays), counted on the ordered bit patterns."""
    def key(x):
        i = np.asarray(x).view(np.uint16).astype(np.int64)
        return np.where(i & 0x8000, -(i & 0x7FFF), i)

    return np.abs(key(a) - key(b))


def _check_tree(got, want, name, kind):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w], name
    for (path, a_raw), (_, b_raw) in zip(flat_g, flat_w):
        a, b = np.asarray(a_raw, np.float64), np.asarray(b_raw, np.float64)
        where = f"{name}{jax.tree_util.keystr(path)}"
        assert a.shape == b.shape, where
        err = np.abs(a - b)
        out = err > 1e-5 + 1e-5 * np.abs(b)
        if kind == "params":
            assert err.max(initial=0) <= 2 * LR * STEPS + 1e-5, where
            assert out.mean() <= 0.005, f"{where}: {out.mean():.4%} outliers"
        elif kind == "bf16_moments":
            ulps = _bf16_ulps(a_raw, b_raw)
            far = ulps > 1
            bound = 3e-3 * np.abs(b).max(initial=0)
            assert err[far].max(initial=0) <= bound, f"{where}: {err[far].max()} > {bound}"
        elif kind == "moments":
            bound = 3e-3 * np.abs(b).max(initial=0)
            assert err.max(initial=0) <= bound, f"{where}: {err.max()} > {bound}"
        else:
            assert not out.any(), f"{where}: max err {err.max()}"


@pytest.mark.parametrize(
    "loss,d_updates,spectral_norm", [("hinge", 2, True), ("bce", 1, False)],
)
def test_three_step_trajectory_matches_jax(loss, d_updates, spectral_norm, monkeypatch):
    jax_state0, jax_state, jax_metrics = _jax_run(loss, d_updates, spectral_norm, monkeypatch)
    port_state, port_metrics = _port_run(loss, d_updates, spectral_norm, jax_state0)
    for i, (mp, mj) in enumerate(zip(port_metrics, jax_metrics)):
        for k in mj:
            assert mp[k] == pytest.approx(mj[k], rel=1e-4, abs=1e-6), f"step {i} {k}"
    want = _as_dict(jax_state)
    assert int(port_state["step"]) == int(want["step"]) == STEPS
    for key in ("g_opt", "d_opt"):
        assert int(port_state[key]["count"]) == int(want[key]["count"])
    for key in ("g_params", "d_params"):
        _check_tree(port_state[key], want[key], key, "params")
    for key in ("g_batch_stats", "d_spectral"):
        _check_tree(port_state[key], want[key], key, "stats")
    for key in ("g_opt", "d_opt"):
        for m in ("mu", "nu"):
            _check_tree(port_state[key][m], want[key][m], f"{key}.{m}", "moments")


def _check_state(port_state, want, moments="moments"):
    assert int(port_state["step"]) == int(want["step"]) == STEPS
    for key in ("g_opt", "d_opt"):
        assert int(port_state[key]["count"]) == int(want[key]["count"])
    for key in ("g_params", "d_params"):
        _check_tree(port_state[key], want[key], key, "params")
    for key in ("g_batch_stats", "d_spectral"):
        _check_tree(port_state[key], want[key], key, "stats")
    for key in ("g_opt", "d_opt"):
        for m in ("mu", "nu"):
            _check_tree(port_state[key][m], want[key][m], f"{key}.{m}", moments)


def _check_metrics(port_metrics, jax_metrics):
    for i, (mp, mj) in enumerate(zip(port_metrics, jax_metrics)):
        for k in mj:
            assert mp[k] == pytest.approx(mj[k], rel=1e-4, abs=1e-6), f"step {i} {k}"


def test_bf16_moments_match_jax(monkeypatch):
    """opt_moments="bf16": both sides keep bfloat16 m and v; three steps."""
    jax_state0, jax_state, jax_metrics = _jax_run("hinge", 2, True, monkeypatch,
                                                  opt_moments="bf16")
    want = _as_dict(jax_state)
    assert {np.asarray(x).dtype.name for x in jax.tree.leaves(want["g_opt"]["mu"])} == {
        "bfloat16"}
    port_state, port_metrics = _port_run("hinge", 2, True, jax_state0, opt_moments="bf16")
    _check_metrics(port_metrics, jax_metrics)
    _check_state(port_state, want, moments="bf16_moments")


def test_opt_moments_values():
    cfg = tstep.SNDCGANTrainConfig(
        model=SNDCGANConfig(image_size=IMAGE, base_width=16), opt_moments="bf16")
    state = tstep.init_state(cfg, "cpu")
    for opt, model in ((state.g_opt, state.gen), (state.d_opt, state.disc)):
        for p, m, v in zip(model.parameters(), opt.mu, opt.nu, strict=True):
            assert m.dtype == v.dtype == torch.bfloat16 and p.dtype == torch.float32
            assert m.stride() == v.stride() == p.stride()
    assert tstep.SNDCGANTrainConfig().opt_moments == "f32"
    with pytest.raises(ValueError, match="opt_moments"):
        tstep.SNDCGANTrainConfig(opt_moments="fp8")


@pytest.mark.parametrize("d_updates", [2, 1])
def test_remat_d_is_bit_equal_to_no_remat(d_updates, monkeypatch):
    """remat_d recomputes D's activations on the fake batch in the backward:
    the same masks (from the key words passed in), no `u` written, so the
    state and the metrics are bit-equal to the run without it; the dropout
    forward runs once more per site of each recomputed pass."""
    from imagegeneration_tpu_torch.ops import dropout as tdropout

    cfg = tstep.SNDCGANTrainConfig(
        model=SNDCGANConfig(image_size=IMAGE, base_width=16, spectral_norm=True),
        batch_size=BATCH, loss="hinge", d_updates=d_updates, seed=62)
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = tdropout.fwd, tdropout.bwd

    def counting(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(tdropout, "fwd", counting("fwd", real_fwd))
    monkeypatch.setattr(tdropout, "bwd", counting("bwd", real_bwd))
    batches, zs = _inputs()
    kw = torch.from_numpy(KW.astype(np.int64))
    runs = []
    for remat in (False, True):
        state = tstep.init_state(dataclasses.replace(cfg, remat_d=remat), "cpu")
        step = tstep.make_train_step(dataclasses.replace(cfg, remat_d=remat))
        calls.update(fwd=0, bwd=0)
        metrics = []
        for i in range(2):
            state, m = step(state, torch.from_numpy(batches[i]), torch.from_numpy(zs[i]), kw)
            metrics.append(m)
        runs.append((dp.state_digest(state), metrics, dict(calls)))
    (digest0, m0, c0), (digest1, m1, c1) = runs
    n = tstep.N_SITES // 3
    extra = 2 * n if d_updates == 2 else n  # the G pass's D, and the D-fake pass's
    assert c0 == {"fwd": 2 * 3 * n, "bwd": 2 * 3 * n}
    assert c1 == {"fwd": 2 * (3 * n + extra), "bwd": 2 * 3 * n}
    for a, b in zip(m0, m1):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert digest0 == digest1  # sha256 of every tensor of the state


def test_remat_d_matches_jax_remat_d(monkeypatch):
    jax_state0, jax_state, jax_metrics = _jax_run("hinge", 2, True, monkeypatch,
                                                  remat_d=True)
    port_state, port_metrics = _port_run("hinge", 2, True, jax_state0, remat_d=True)
    _check_metrics(port_metrics, jax_metrics)
    _check_state(port_state, _as_dict(jax_state))
