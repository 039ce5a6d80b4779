"""The ported CycleGAN train step vs the JAX step, and the engine on CPU.

Both steps start from one state (the JAX `init_state`, bridged) and take
the same uint8 batches (numpy, seeded), at the tiny configuration of
tests/test_cyclegan.py (96x96, base_width 8, 2 res blocks, batch 1). The
JAX step is built and run once per module (a module-scoped fixture); its
InstanceNorm resolves to the XLA path on the CPU, as in the JAX package's
own tests, and the port runs the plain versions of its kernels.

The JAX step computes in float64 here (its f64 path, with x64 enabled for
the fixture only, as tests/test_parallel.py runs it; parameters and Adam
state stay float32), and the port in float32. In float32 the JAX step's
XLA:CPU instance norms are the less exact side: against the same first
pull in float64 its gradients are up to 6.7e-3 of a leaf's largest value
off (D_y's conv0 bias 0.108), the port's within 7e-6, so a float32
reference would hold the port to the reference's own rounding.

Tolerances:
- metrics: rtol 1e-4 over three steps; a wrong loss, pull or update order
  moves them by O(1).
- parameters after three steps: 1e-5 (abs + rel). The conv biases that
  feed a per-channel instance norm have an exact gradient of 0, so each
  side moves them by Adam on rounding noise (about lr * sign(noise) per
  step); for those only the bound 2 * lr * steps holds.
- Adam moments after the first step (the three pulls' gradients): 1e-4 of
  the leaf's largest magnitude. For the zero-gradient biases, whose values
  are rounding noise on both sides, the noise must stay below 1e-6 of the
  model's largest mu (1e-12 of its largest nu, ~ g^2).
- counts and step: exact.

Every test runs twice, with the per-channel norm and with `quirk_axis1`
(the reference's tfa `axis=1` norm on NHWC: each image row normalized over
(W, C) with per-row parameters, the form that imported reference weights
take). A conv bias before a per-row norm is not in the norm's null space:
only the mean of its gradient over the channels is 0, so under the quirk
no leaf is exempt and every bias is held to the bounds above.
"""

import json
import pickle
import re

import jax
import numpy as np
import pytest
import torch

from imagegeneration_tpu.models.cyclegan import CycleGANConfig as JaxModelConfig
from imagegeneration_tpu.train import cyclegan_step as jstep
from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.cli import cyclegan_trainer
from imagegeneration_tpu_torch.core import checkpoint as ckptlib
from imagegeneration_tpu_torch.core import data as datalib
from imagegeneration_tpu_torch.core import preview as tpreview
from imagegeneration_tpu_torch.models.cyclegan import CycleGANConfig
from imagegeneration_tpu_torch.ops import adam as tadam
from imagegeneration_tpu_torch.ops import instance_norm as tin
from imagegeneration_tpu_torch.train import cyclegan_engine
from imagegeneration_tpu_torch.train import cyclegan_step as tstep

torch.set_num_threads(1)

STEPS = 3
IMAGE = (96, 96, 3)
LR = 2e-4
MODEL = dict(image_size=IMAGE, base_width=8, n_res_blocks=2)


def _batches():
    rng = np.random.default_rng(11)
    return rng.integers(0, 256, (STEPS, 2, 1, *IMAGE), dtype=np.uint8)


def _as_dict(s):
    out = {"step": s.step}
    for key in ("gg", "gf", "dx", "dy"):
        o = getattr(s, f"{key}_opt")
        out[f"{key}_params"] = getattr(s, f"{key}_params")
        out[f"{key}_opt"] = {"count": o.count, "mu": o.mu, "nu": o.nu}
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["per_channel", "quirk_axis1"])
def quirk(request):
    return request.param


@pytest.fixture(scope="module")
def jax_run(quirk):
    """(state before, state after step 1, state after the last step,
    metrics per step) of the JAX step in float64, as numpy trees."""
    old_x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        cfg = jstep.CycleGANTrainConfig(
            model=JaxModelConfig(**MODEL, quirk_axis1=quirk, dtype=jax.numpy.float64),
            batch_size=1)
        state0 = jstep.init_state(cfg)
        step = jax.jit(jstep.make_train_step(cfg))
        state, states, metrics = state0, [], []
        for bx, by in _batches():
            state, m = step(state, bx, by)
            states.append(_as_dict(jax.device_get(state)))
            metrics.append({k: float(v) for k, v in m.items()})
        return _as_dict(jax.device_get(state0)), states[0], states[-1], metrics
    finally:
        jax.config.update("jax_enable_x64", old_x64)


@pytest.fixture(scope="module")
def port_run(jax_run, quirk):
    """The port's counterpart of `jax_run`, from the bridged initial state."""
    cfg = tstep.CycleGANTrainConfig(model=CycleGANConfig(**MODEL, quirk_axis1=quirk),
                                    batch_size=1)
    state = tstep.init_state(cfg, "cpu")
    bridge.load_jax_cyclegan_state(state, jax_run[0])
    step = tstep.make_train_step(cfg)
    states, metrics = [], []
    for bx, by in _batches():
        state, m = step(state, torch.from_numpy(bx), torch.from_numpy(by))
        states.append(bridge.jax_cyclegan_state(state))
        metrics.append({k: float(v) for k, v in m.items()})
    return states[0], states[-1], metrics


def _leaves(got, want, name):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w], name
    for (path, a), (_, b) in zip(flat_g, flat_w):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        where = f"{name}{jax.tree_util.keystr(path)}"
        assert a.shape == b.shape, where
        yield where, np.abs(a - b), b


def _feeds_norm(where: str, quirk: bool) -> bool:
    """A conv bias followed by a per-channel instance norm (exact gradient
    0): in the generators stem_conv, down*, up*, to_rgb and the res blocks'
    conv1; in the discriminators (dx, dy) conv1-3. None under the quirk,
    whose per-row norm passes a per-channel bias's gradient on."""
    if quirk or not where.endswith("_0']['bias']"):
        return False
    if where.startswith("d"):
        return re.search(r"\['conv[123]'\]", where) is not None
    return re.search(r"\['(stem_conv|down\d|up\d|to_rgb|conv1)'\]", where) is not None


def _check_params(got, want, name, quirk):
    for where, err, b in _leaves(got, want, name):
        assert err.max(initial=0) <= 2 * LR * STEPS + 1e-5, where
        if not _feeds_norm(where, quirk):
            bad = err > 1e-5 + 1e-5 * np.abs(b)
            assert not bad.any(), f"{where}: {bad.sum()} of {bad.size} off, max {err.max()}"


def _check_moments(got, want, name, noise, quirk):
    tree_max = max(np.abs(np.asarray(b)).max() for b in jax.tree.leaves(want))
    for where, err, b in _leaves(got, want, name):
        bound = noise * tree_max if _feeds_norm(where, quirk) else 1e-4 * np.abs(b).max()
        assert err.max(initial=0) <= bound, f"{where}: {err.max()} > {bound}"


def test_three_step_metrics_match_jax(jax_run, port_run):
    jax_metrics, port_metrics = jax_run[-1], port_run[-1]
    assert set(port_metrics[0]) == set(jax_metrics[0]) == set(tstep.METRIC_KEYS)
    for i, (mp, mj) in enumerate(zip(port_metrics, jax_metrics)):
        for k in mj:
            assert mp[k] == pytest.approx(mj[k], rel=1e-4, abs=1e-6), f"step {i} {k}"


@pytest.mark.parametrize("key", ["gg", "gf", "dx", "dy"])
def test_three_step_params_match_jax(jax_run, port_run, quirk, key):
    want, got = jax_run[2], port_run[1]
    assert int(got["step"]) == int(want["step"]) == STEPS
    assert int(got[f"{key}_opt"]["count"]) == int(want[f"{key}_opt"]["count"]) == STEPS
    _check_params(got[f"{key}_params"], want[f"{key}_params"], f"{key}_params", quirk)


@pytest.mark.parametrize("key", ["gg", "gf", "dx", "dy"])
def test_first_step_moments_match_jax(jax_run, port_run, quirk, key):
    """The moments after one step are the three pulls' gradients: each of
    the four models gets its own (pull 3 gives both discriminators')."""
    want, got = jax_run[1][f"{key}_opt"], port_run[0][f"{key}_opt"]
    _check_moments(got["mu"], want["mu"], f"{key}_opt.mu", 1e-6, quirk)
    _check_moments(got["nu"], want["nu"], f"{key}_opt.nu", 1e-12, quirk)


# ------------------------------------------------------------------ engine
@pytest.fixture()
def no_figures(monkeypatch):
    """The engine as on a machine without matplotlib: the figures are held to
    the JAX package in tests/test_torch_preview.py."""
    monkeypatch.setattr(tpreview, "matplotlib_available", lambda skipped: False)


def _datasets():
    return (datalib.SyntheticImageDataset(3, IMAGE[:2], seed=1),
            datalib.SyntheticImageDataset(2, IMAGE[:2], seed=2))


def _engine(out):
    return cyclegan_engine.CycleGANEngine(
        *_datasets(), str(out), 1, IMAGE[:2], device=torch.device("cpu"),
        base_width=8, n_res_blocks=2)


@pytest.mark.usefixtures("no_figures")
def test_engine_auto_resumes_and_keeps_history(tmp_path):
    eng = _engine(tmp_path / "run")
    assert eng.resident and eng.epoch == 0 and eng.num_batches == 2  # min(3, 2)
    assert (tmp_path / "run" / "models" / "generator_f").is_dir()
    eng.train(1)
    # A new engine on the same directory resumes without being asked.
    eng = _engine(tmp_path / "run")
    assert eng.epoch == 1 and int(eng.state.step) == 2
    eng.train(1)
    hist = pickle.loads((tmp_path / "run" / "losses.pickle").read_bytes())
    assert set(hist) == set(cyclegan_engine.LOSS_KEYS) and len(hist) == 7
    assert all(len(v) == 2 and np.isfinite(v).all() for v in hist.values())
    perf = [json.loads(line) for line in (tmp_path / "run" / "perf.jsonl").read_text().splitlines()]
    assert [p["epoch"] for p in perf] == [0, 1] and perf[0]["device"] == "cpu"
    mgr = ckptlib.CheckpointManager(tmp_path / "run" / "checkpoints")
    assert mgr.all_epochs() == [1, 2]
    sd = mgr.restore()
    assert int(sd["step"]) == 4 and all(int(sd[k]["count"]) == 4
                                        for k in ("gg_opt", "gf_opt", "dx_opt", "dy_opt"))
    assert tin.LAUNCHES == {"instance_norm_fwd": 0, "instance_norm_bwd": 0}
    assert tadam.LAUNCHES == {"adam": 0}


@pytest.mark.usefixtures("no_figures")
def test_engine_resident_and_streaming_agree(tmp_path, monkeypatch):
    """Both data paths take each domain's own permutation: one epoch gives
    the same metrics and weights."""
    resident = _engine(tmp_path / "r")
    monkeypatch.setattr(datalib, "resident_budget", lambda device: 0)
    streaming = _engine(tmp_path / "s")
    assert resident.resident and not streaming.resident
    for eng in (resident, streaming):
        eng.train(1)
    assert resident.last_epoch_metrics == streaming.last_epoch_metrics
    for a, b in zip(resident.state.gen_g.parameters(), streaming.state.gen_g.parameters()):
        assert torch.equal(a, b)
    out = resident.translate_g(resident.state, torch.zeros(2, *IMAGE))
    assert out.shape == (2, *IMAGE) and out.abs().max() <= 1.0


def test_cli_refuses_mesh_and_profile_flags(tmp_path, capsys):
    # data and spatial parallelism are ported (tests/test_torch_dp.py,
    # tests/test_torch_spatial_cyclegan.py), and --profile
    # (test_cli_accepts_profile); what stays refused: a spatial partition
    # the guard refuses (16 rows: 1 row per shard of 4 at H/4), host
    # sharding without ranks, and more ranks than visible cards, which is
    # never shrunk
    for flags, says in ((["--mesh-spatial", "4", "--height", "16"], "WRONG below 2"),
                        (["--host-sharded-data"], "needs --mesh-data")):
        with pytest.raises(SystemExit):
            cyclegan_trainer.main(["1", "1", "-d", str(tmp_path), *flags])
        assert says in capsys.readouterr().err
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="need 2 cards"):
            cyclegan_trainer.main(["1", "1", "-d", str(tmp_path), "--mesh-data", "2"])
    args = cyclegan_trainer.build_parser().parse_args(["4", "2", "-ct"])
    assert args.continue_ and (args.height, args.width, args.device) == (128, 128, "cuda")


def test_cli_accepts_profile(tmp_path, monkeypatch):
    """--profile reaches the engine (whose trace test_engine_profile_traces_
    the_second_epoch holds)."""
    seen = {}

    class Engine:
        def __init__(self, *args, **kwargs):
            seen["profile"] = kwargs["profile"]

        def train(self, epochs, checkpoint_frequency):
            seen["epochs"] = epochs

    monkeypatch.setattr(cyclegan_engine, "CycleGANEngine", Engine)
    cyclegan_trainer.main(["2", "2", "-d", str(tmp_path), "--device", "cpu", "--profile"])
    assert seen == {"profile": True, "epochs": 2}
    cyclegan_trainer.main(["2", "2", "-d", str(tmp_path), "--device", "cpu"])
    assert seen == {"profile": False, "epochs": 2}


@pytest.mark.usefixtures("no_figures")
def test_engine_profile_traces_the_second_epoch(tmp_path):
    """profile=True traces the second epoch of the train() call (the JAX
    engine's maybe_start(i, 1)), named by its epoch, into <path>/traces; a
    train() of one epoch writes none."""
    eng = cyclegan_engine.CycleGANEngine(
        *_datasets(), str(tmp_path / "run"), 1, IMAGE[:2], device=torch.device("cpu"),
        base_width=8, n_res_blocks=1, profile=True)
    eng.train(1)
    assert not (tmp_path / "run" / "traces").exists()
    eng.train(2)  # epochs 1 and 2: traces epoch 2
    traces = sorted(p.name for p in (tmp_path / "run" / "traces").iterdir())
    assert traces == ["epoch_2.rank0.json"]
    events = json.loads((tmp_path / "run" / "traces" / traces[0]).read_text())["traceEvents"]
    assert any(e.get("ph") == "X" and e.get("cat") == "cpu_op" for e in events)
