"""The CycleGAN `--bf16` step against the JAX package on the CPU.

One seeded initial state (the port's `init_state`, bridged into a JAX
`CycleGANState`) and the same numpy-seeded uint8 batches go through three
steps, STEPS times each, at the tiny configuration of
tests/test_torch_cyclegan_step.py (96x96, base_width 8, 2 res blocks,
batch 1, per-channel norm):

- the JAX step with `dtype=jnp.bfloat16` (x64 off);
- the JAX step in float64 (x64 on for its fixture only), the reference, as
  tests/test_torch_cyclegan_step.py runs it;
- the port's step with `CycleGANConfig(dtype=torch.bfloat16)`.

Each JAX step is built and run once per module. The initial state is made
by the port, not by the JAX `init_state`: its eager flax init costs ~30 s
on the CPU, and which seeded state both sides start from does not matter.

Exact: the step and the optimizer counts; float32 parameters, Adam moments
and metrics; the InstanceNorm statistics float32 for a bfloat16 input
(`ops/instance_norm.in_fwd`, watched during the step).

bf16 noise is large next to any one rounding, so the numbers are held as
the WGAN `--bf16` gate holds them (tests/test_torch_wgan_step.py): against
the float64 step, the port's bf16 distance at most BOUND times the JAX bf16
step's distance.
- metrics: each of the nine, |bf16 - float64| summed over the steps.
  Readings: the port 0.43-1.57 of JAX. The cycle and identity losses sit at
  1.52-1.57 (1.6 in each step alone): the JAX step's L1 takes the real image from the
  fused normalize in float32 (XLA's excess precision inside a fusion; the
  bf16 value it hands the generators is bit-equal to the port's), while
  the port's L1 reads the bf16-rounded image.
- parameters: each model's update, the L2 norm of (bf16 - float64) over all
  its leaves. Readings: 0.81-1.05 of JAX. Leaf by leaf the ratio is the
  luck of Adam's sign flips on near-zero gradients (0.27-2.01 of 112
  leaves here; up to 5.1 for a port variant whose metrics and model
  updates both come closer to float64), so no leaf is held alone.

The gate is shown to catch two faults planted in the port's bf16 step
(`FAULTS`; readings of the largest ratio, against BOUND = 2):
- "bf16_loss": the BCE of the patch logits taken in bfloat16 and cast to
  float32 after (a lost cast before the loss): the adversarial and disc
  losses 17-32x JAX's distance, the largest over 10 x BOUND.
- "bf16_master_weights": the parameters rounded to bfloat16 after every
  Adam apply, kept in float32 tensors (the float32 master weights lost):
  the generators' updates 4.1-4.6x JAX's distance. The metrics cannot see
  it: bf16 compute rounds the weights at every use anyway.
InstanceNorm statistics rounded to bfloat16, or summed in a bfloat16
accumulator of 32 lanes, stay inside the gate (read from a JAX-made start:
metrics 0.54-1.61, updates 0.70-1.02): this bf16 noise hides them, as the WGAN gate notes of one extra rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from imagegeneration_tpu.models.cyclegan import CycleGANConfig as JaxModelConfig
from imagegeneration_tpu.train import cyclegan_step as jstep
from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.models.cyclegan import CycleGANConfig
from imagegeneration_tpu_torch.ops import instance_norm as tin
from imagegeneration_tpu_torch.train import common as tcommon
from imagegeneration_tpu_torch.train import cyclegan_step as tstep

torch.set_num_threads(1)

STEPS = 2
IMAGE = (96, 96, 3)
MODEL = dict(image_size=IMAGE, base_width=8, n_res_blocks=2)
MODELS = ("gg", "gf", "dx", "dy")
BOUND = 2.0


def _batches():
    rng = np.random.default_rng(11)
    return rng.integers(0, 256, (STEPS, 2, 1, *IMAGE), dtype=np.uint8)


def _as_dict(s):
    out = {"step": s.step}
    for key in MODELS:
        o = getattr(s, f"{key}_opt")
        out[f"{key}_params"] = getattr(s, f"{key}_params")
        out[f"{key}_opt"] = {"count": o.count, "mu": o.mu, "nu": o.nu}
    return out


@pytest.fixture(scope="module")
def start():
    """The port's seeded initial state as JAX-shaped numpy trees."""
    cfg = tstep.CycleGANTrainConfig(model=CycleGANConfig(**MODEL), batch_size=1)
    return bridge.jax_cyclegan_state(tstep.init_state(cfg, "cpu"))


def _jax_run(start, dtype, x64):
    """(state after STEPS steps, metrics per step) of the JAX step."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", x64)
    try:
        cfg = jstep.CycleGANTrainConfig(model=JaxModelConfig(**MODEL, dtype=dtype),
                                        batch_size=1)
        txs = jstep.build(cfg)[4:]
        params = {key: jax.tree.map(jnp.asarray, start[f"{key}_params"]) for key in MODELS}
        state = jstep.CycleGANState(
            step=jnp.zeros((), jnp.int32),
            **{f"{key}_params": params[key] for key in MODELS},
            **{f"{key}_opt": tx.init(params[key]) for key, tx in zip(MODELS, txs)})
        step = jax.jit(jstep.make_train_step(cfg))
        metrics = []
        for bx, by in _batches():
            state, m = step(state, bx, by)
            metrics.append({k: float(v) for k, v in m.items()})
        return _as_dict(jax.device_get(state)), metrics
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def jax_runs(start):
    return {"bf16": _jax_run(start, jnp.bfloat16, False),
            "f64": _jax_run(start, jnp.float64, True)}


def _bf16_master_weights(mp):
    apply = tcommon.adam_apply

    def rounded(params, *args, **kwargs):
        apply(params, *args, **kwargs)
        with torch.no_grad():
            for p in params:
                p.copy_(p.to(torch.bfloat16))

    mp.setattr(tcommon, "adam_apply", rounded)


def _bf16_loss(mp):
    def bce(labels, logits):
        x = logits.to(torch.bfloat16)
        z = labels.to(x.dtype)
        return torch.mean(-z * F.logsigmoid(x) - (1.0 - z) * F.logsigmoid(-x)).float()

    mp.setattr(tcommon, "bce_logits_mean", bce)


FAULTS = {"bf16_loss": _bf16_loss, "bf16_master_weights": _bf16_master_weights}


def _port_run(start, fault=None):
    """(state tree, metrics per step, metric dtypes, (x, mean, rstd) dtypes
    of every InstanceNorm forward) of the port's bf16 step, with `fault`
    planted for the run."""
    seen = set()
    in_fwd = tin.in_fwd

    def watched(x, *args):
        y, mean, rstd = in_fwd(x, *args)
        seen.add((x.dtype, mean.dtype, rstd.dtype))
        return y, mean, rstd

    cfg = tstep.CycleGANTrainConfig(
        model=CycleGANConfig(**MODEL, dtype=torch.bfloat16), batch_size=1)
    state = tstep.init_state(cfg, "cpu")
    bridge.load_jax_cyclegan_state(state, start)
    metrics, dtypes = [], set()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tin, "in_fwd", watched)
        if fault is not None:
            FAULTS[fault](mp)
        step = tstep.make_train_step(cfg)
        for bx, by in _batches():
            state, m = step(state, torch.from_numpy(bx), torch.from_numpy(by))
            dtypes |= {v.dtype for v in m.values()}
            metrics.append({k: float(v) for k, v in m.items()})
    return bridge.jax_cyclegan_state(state), metrics, dtypes, seen


@pytest.fixture(scope="module")
def port_run(start):
    return _port_run(start)


def _ratios(port, jax_runs):
    """Per metric and per model: the port's bf16 distance from the float64
    step over the JAX bf16 step's."""
    (state_b, metrics_b), (state_f, metrics_f) = jax_runs["bf16"], jax_runs["f64"]
    state_p, metrics_p = port[:2]

    def metric_distance(metrics, key):
        return sum(abs(m[key] - t[key]) for m, t in zip(metrics, metrics_f))

    def update_distance(state, key):
        pairs = zip(jax.tree.leaves(state[f"{key}_params"]),
                    jax.tree.leaves(state_f[f"{key}_params"]))
        return np.sqrt(sum(np.sum((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
                           for a, b in pairs))

    return ({k: metric_distance(metrics_p, k) / metric_distance(metrics_b, k)
             for k in tstep.METRIC_KEYS},
            {key: update_distance(state_p, key) / update_distance(state_b, key)
             for key in MODELS})


def test_bf16_step_counts_and_dtypes(port_run, jax_runs):
    state, metrics, dtypes, seen = port_run
    assert int(state["step"]) == int(jax_runs["bf16"][0]["step"]) == STEPS
    for key in MODELS:
        opt = state[f"{key}_opt"]
        assert int(opt["count"]) == int(jax_runs["bf16"][0][f"{key}_opt"]["count"]) == STEPS
        for tree in (state[f"{key}_params"], opt["mu"], opt["nu"]):
            assert {np.asarray(v).dtype for v in jax.tree.leaves(tree)} == {np.dtype(np.float32)}, key
    assert dtypes == {torch.float32}
    assert set(metrics[0]) == set(jax_runs["bf16"][1][0]) == set(tstep.METRIC_KEYS)
    assert all(np.isfinite(v) for m in metrics for v in m.values())
    # every InstanceNorm of the bf16 step: a bf16 input, float32 statistics
    assert seen == {(torch.bfloat16, torch.float32, torch.float32)}


@pytest.mark.parametrize("key", tstep.METRIC_KEYS)
def test_bf16_metric_within_twice_jax(port_run, jax_runs, key):
    ratio = _ratios(port_run, jax_runs)[0][key]
    assert ratio <= BOUND, f"{key}: {ratio:.3f} x the JAX bf16 step's distance"


@pytest.mark.parametrize("key", MODELS)
def test_bf16_model_update_within_twice_jax(port_run, jax_runs, key):
    ratio = _ratios(port_run, jax_runs)[1][key]
    assert ratio <= BOUND, f"{key}: {ratio:.3f} x the JAX bf16 step's distance"


def test_planted_bf16_loss_fails_the_gate_tenfold(start, jax_runs):
    metric, _ = _ratios(_port_run(start, "bf16_loss"), jax_runs)
    worst = max(metric, key=metric.get)
    assert metric[worst] >= 10 * BOUND, (worst, metric[worst])


def test_planted_bf16_master_weights_fail_the_update_gate(start, jax_runs):
    _, update = _ratios(_port_run(start, "bf16_master_weights"), jax_runs)
    assert max(update[k] for k in ("gg", "gf")) > BOUND, update
