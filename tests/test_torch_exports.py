"""Params-only msgpack exports: the port against the JAX package.

- The port's `export_params` writes the bytes the JAX package's writes
  (flax.serialization.to_bytes) for the same tree, and flax's
  `msgpack_restore` reads the port's file as the JAX tree leaf by leaf
  (keys, shapes, dtypes, values: exact). The trees come from flax-initialized
  SNDCGAN models, with and without spectral norm, bridged into the port.
- The port loads a JAX export into fresh models, and `bridge.export_variables`
  gives the same tree back (exact).
- Arrays over MAX_CHUNK_SIZE bytes are chunked as flax chunks them (both
  sides' limit patched to 4 KB): same bytes, and each side reads the other's.
- `find_epoch_files` lists what the JAX function lists.
- Engines: each port engine, on a tiny CPU config, writes exactly the export
  files (names and collection/leaf structure) and asks for the same figures
  as the JAX engine's own train loop for the same epochs and intervals:
  SNDCGAN's `checkpoint_frequency`, WGAN's pruning off `save_interval` (the
  trainer's `-c`) and CycleGAN's `checkpoint_frequency`. The JAX loops run
  on instances made without `__init__` (no JAX train state: compiling one
  costs tens of seconds on the CPU), with the train step, sampling and the
  figures replaced by recorders on both sides; their exports hold the port
  engine's final trees, so the collections each JAX loop picks are what is
  compared, and the leaf structure. The figures themselves are held to the
  JAX functions in tests/test_torch_preview.py.
"""

import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from imagegeneration_tpu.core import checkpoint as jckpt
from imagegeneration_tpu.core import data as jdata
from imagegeneration_tpu.core import metrics as jmetrics
from imagegeneration_tpu.core import preview as jpreview
from imagegeneration_tpu.core import rng as jrng
from imagegeneration_tpu.models import sndcgan as jmodels
from imagegeneration_tpu.train import cyclegan_engine as jcyc
from imagegeneration_tpu.train import sndcgan_engine as jsnd
from imagegeneration_tpu.train import wgan_engine as jwgan
from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.core import checkpoint as tckpt
from imagegeneration_tpu_torch.core import data as tdata
from imagegeneration_tpu_torch.core import preview as tpreview
from imagegeneration_tpu_torch.models import sndcgan as tmodels
from imagegeneration_tpu_torch.train import cyclegan_engine as tcyc
from imagegeneration_tpu_torch.train import sndcgan_engine as tsnd
from imagegeneration_tpu_torch.train import wgan_engine as twgan

torch.set_num_threads(1)
IMAGE = (16, 24, 3)
CPU = torch.device("cpu")


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x))
            for p, x in jax.tree_util.tree_leaves_with_path(tree)]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        np.testing.assert_array_equal(x, y, err_msg=p)


def _structure(tree):
    return [(p, x.shape, x.dtype) for p, x in _leaves(tree)]


@pytest.fixture(scope="module", params=[True, False], ids=["sn", "no_sn"])
def jax_export_trees(request):
    """The JAX engine's export trees of flax-initialized models:
    G {params, batch_stats}, D {params, spectral}."""
    cfg = jmodels.SNDCGANConfig(image_size=IMAGE, base_width=16,
                                spectral_norm=request.param)
    # jitted: one compile each, where an eager init compiles op by op
    g = jax.device_get(jax.jit(lambda k: jmodels.Generator(cfg).init(
        {"params": k}, jnp.zeros((1, 128)), train=False))(jax.random.key(0)))
    d = jax.device_get(jax.jit(lambda k: jmodels.Discriminator(cfg).init(
        {"params": k}, jnp.zeros((1, *IMAGE)), train=False))(jax.random.key(1)))
    # batch statistics away from their init, so that mean and var differ
    g["batch_stats"] = jax.tree.map(lambda x: np.asarray(x) + 0.25, g["batch_stats"])
    tcfg = tmodels.SNDCGANConfig(image_size=IMAGE, base_width=16,
                                 spectral_norm=request.param)
    return {
        "gen": ({"params": g["params"], "batch_stats": g["batch_stats"]},
                tmodels.Generator(tcfg)),
        "disc": ({"params": d["params"], "spectral": d.get("spectral", {})},
                 tmodels.Discriminator(tcfg)),
    }


@pytest.mark.parametrize("which", ["gen", "disc"])
def test_port_export_is_the_jax_export(jax_export_trees, which, tmp_path):
    tree, model = jax_export_trees[which]
    bridge.load_flax_variables(model, tree)
    tckpt.export_params(tmp_path / "port.msgpack", bridge.export_variables(model))
    jckpt.export_params(tmp_path / "jax.msgpack", tree)
    port_bytes = (tmp_path / "port.msgpack").read_bytes()
    assert port_bytes == (tmp_path / "jax.msgpack").read_bytes()
    _assert_trees_equal(serialization.msgpack_restore(port_bytes), tree)


@pytest.mark.parametrize("which", ["gen", "disc"])
def test_port_loads_a_jax_export(jax_export_trees, which, tmp_path):
    tree, model = jax_export_trees[which]
    jckpt.export_params(tmp_path / "jax.msgpack", tree)
    fresh = type(model)(model.cfg)
    bridge.load_flax_variables(fresh, tckpt.load_params(tmp_path / "jax.msgpack"))
    _assert_trees_equal(bridge.export_variables(fresh), tree)
    _assert_trees_equal(tckpt.load_params(tmp_path / "jax.msgpack"),
                        jckpt.load_params(tmp_path / "jax.msgpack"))


def test_chunked_arrays_match_flax(monkeypatch, tmp_path):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
    monkeypatch.setattr(tckpt, "MAX_CHUNK_SIZE", 4096)
    rng = np.random.default_rng(0)
    tree = {"params": {"big": rng.standard_normal((37, 101)).astype(np.float32),
                       "edge": rng.standard_normal(1024).astype(np.float32),  # 4096 B
                       "over": rng.integers(0, 9, 4097, dtype=np.uint8),
                       "small": np.arange(5, dtype=np.int32)},
            "count": np.asarray(7, np.int32)}
    tckpt.export_params(tmp_path / "port.msgpack", tree)
    jckpt.export_params(tmp_path / "jax.msgpack", tree)
    port_bytes = (tmp_path / "port.msgpack").read_bytes()
    assert port_bytes == (tmp_path / "jax.msgpack").read_bytes()
    assert b"__msgpack_chunked_array__" in port_bytes
    _assert_trees_equal(serialization.msgpack_restore(port_bytes), tree)
    _assert_trees_equal(tckpt.load_params(tmp_path / "jax.msgpack"), tree)


def test_find_epoch_files_matches_jax(tmp_path):
    for name in ("gen_model-10.msgpack", "gen_model-2.msgpack", "gen_model-0.msgpack",
                 "gen_model-x.msgpack", "gen_model-3.msgpack.tmp", "disc_model-1.msgpack",
                 "agen_model-4.msgpack"):
        (tmp_path / name).write_bytes(b"")
    (tmp_path / "gen_model-7.msgpack").mkdir()
    for pattern in ("gen_model-{epoch}.msgpack", "model_{epoch}.msgpack"):
        ours = tckpt.find_epoch_files(tmp_path, pattern)
        assert ours == jckpt.find_epoch_files(tmp_path, pattern)
    assert [e for e, _ in tckpt.find_epoch_files(tmp_path, "gen_model-{epoch}.msgpack")] \
        == [0, 2, 7, 10]
    assert tckpt.find_epoch_files(tmp_path / "missing", "gen_model-{epoch}.msgpack") == []


# ----------------------------------------------------------------- engines
class _Recorder:
    """Stands in for a figure function or a checkpoint manager: records the
    output path (the last positional argument) or the saved epoch."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args, **kwargs):
        self.calls.append(str(args[-1]))

    def save(self, epoch, state, force=False):
        self.calls.append(epoch)


def _figures(monkeypatch, module, names):
    recorders = {}
    for name in names:
        recorders[name] = _Recorder()
        monkeypatch.setattr(module, name, recorders[name])
    return recorders


def _written(root):
    """{relative path: leaf structure} of every export under `root`."""
    return {str(p.relative_to(root)): _structure(tckpt.load_params(p))
            for p in sorted(Path(root).rglob("*.msgpack"))}


def _relative(calls, root):
    return [str(Path(c).relative_to(root)) for c in calls]


def _stand_in(cls, **attrs):
    """A JAX engine made without __init__: its own train loop and artifact
    methods over the given attributes."""
    eng = cls.__new__(cls)
    eng.__dict__.update(profile=False, is_main=True, resident=True, mesh=None, state=None,
                        **attrs)
    return eng


def test_sndcgan_engine_exports_as_jax(tmp_path, monkeypatch):
    epochs, freq, batch = 3, 2, 4
    ds = tdata.SyntheticImageDataset(4, (16, 16), seed=0)
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    port_figs = _figures(monkeypatch, tpreview, ["live_preview"])
    eng = tsnd.SNDCGANEngine(str(port_root / "run"), ds, batch, image_size=(16, 16, 3),
                             z_size=8, base_width=16, device=CPU,
                             live_output=str(port_root / "live"))
    port_plots = _Recorder()
    eng.plot_history = lambda: port_plots(eng.dir_path)
    eng.train(epochs, freq)

    g = bridge.export_variables(eng.state.gen)
    d = bridge.export_variables(eng.state.disc)
    jax_figs = _figures(monkeypatch, jpreview, ["live_preview"])
    jax_plots = _Recorder()
    jeng = _stand_in(
        jsnd.SNDCGANEngine, dir_path=str(jax_root / "run"), start_epoch=0,
        batch_size=batch, preview_frequency=1, chain=jrng.KeyChain(62), z_size=8,
        live_preview_file=str(jax_root / "live") + ".pdf", ckpt_manager=_Recorder(),
        losses=jmetrics.LossHistory(jax_root / "run" / "losses.pickle", jsnd.LOSS_KEYS),
    )
    jeng._run_epoch_resident = lambda epoch: (dict.fromkeys(
        ("g_loss", "d_loss", "d_loss_real", "d_loss_fake"), 0.0), 1)
    jeng.sample = lambda z: np.zeros((3, 16, 16, 3), np.float32)
    jeng._local_state = lambda: types.SimpleNamespace(
        g_params=g["params"], g_batch_stats=g["batch_stats"],
        d_params=d["params"], d_spectral=d["spectral"])
    jeng.plot_history = lambda: jax_plots(jeng.dir_path)
    jeng.train(epochs, freq)

    assert eng.ckpt_manager.all_epochs() == jeng.ckpt_manager.calls[-2:] == [0, 2]
    assert _written(port_root) == _written(jax_root)
    assert sorted(_written(port_root)) == [
        "run/models/discriminator/disc_model-0.msgpack",
        "run/models/discriminator/disc_model-2.msgpack",
        "run/models/generator/gen_model-0.msgpack",
        "run/models/generator/gen_model-2.msgpack"]
    assert _relative(port_figs["live_preview"].calls, port_root) \
        == _relative(jax_figs["live_preview"].calls, jax_root) == ["live.pdf"] * epochs
    assert _relative(port_plots.calls, port_root) == _relative(jax_plots.calls, jax_root) \
        == ["run", "run"]


@pytest.mark.parametrize("save_interval", [1, 2])
def test_wgan_engine_exports_and_prunes_as_jax(tmp_path, monkeypatch, save_interval):
    """4 epochs of one step; epoch e's export is removed at epoch e + 1
    unless e is a multiple of save_interval: the last one always stays."""
    epochs, batch, n_critic = 4, 4, 2
    ds = tdata.SyntheticImageDataset(4, (16, 16), seed=0)
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    port_figs = _figures(monkeypatch, tpreview, ["sample_grid"])
    eng = twgan.WGANEngine(ds, (16, 16, 3), batch, n_critic, path_like=str(port_root),
                           save_interval=save_interval, device=CPU, base_width=16)
    port_plots = _Recorder()
    eng.plot_history = lambda: port_plots(f"plot_line_plot_loss_{eng.epoch}.png")
    eng.train(epochs)

    g = bridge.export_variables(eng.state.gen)
    c = bridge.export_variables(eng.state.critic)
    jax_figs = _figures(monkeypatch, jpreview, ["sample_grid"])
    jax_plots = _Recorder()
    jds = jdata.SyntheticImageDataset(4, (16, 16), seed=0)
    jeng = _stand_in(
        jwgan.WGANEngine, path=str(jax_root), epoch=0, save_interval=save_interval,
        dataset=jds, batch_size=batch, chain=jrng.KeyChain(62), _resident_images=object(),
        ckpt_manager=_Recorder(),
        loss_hist=jmetrics.LossHistory(jax_root / "stats.pickle", twgan.HIST_KEYS),
    )
    jeng._epoch_runner = lambda state, images, perm: (None, {
        "c_loss_real": np.zeros(1), "c_loss_fake": np.zeros(1), "g_loss": np.zeros(1),
        "did_gan_update": np.asarray([jeng.epoch % n_critic == 0], np.float32)})
    jeng.generate_fake_samples = lambda n: np.zeros((n, 16, 16, 3), np.float32)
    jeng._local_state = lambda: types.SimpleNamespace(
        g_params=g["params"], g_batch_stats=g["batch_stats"],
        c_params=c["params"], c_batch_stats=c["batch_stats"])
    jeng.plot_history = lambda: jax_plots(f"plot_line_plot_loss_{jeng.epoch}.png")
    jeng.train(epochs)

    kept = sorted({e for e in range(1, epochs) if e % save_interval == 0} | {epochs})
    assert _written(port_root) == _written(jax_root)
    assert sorted(_written(port_root)) == sorted(
        f"{d}/model_{e:04d}.msgpack" for d in ("c_models", "g_models") for e in kept)
    assert eng.ckpt_manager.all_epochs() == [epochs - 1, epochs]
    assert jeng.ckpt_manager.calls == list(range(1, epochs + 1))
    assert _relative(port_figs["sample_grid"].calls, port_root) \
        == _relative(jax_figs["sample_grid"].calls, jax_root) \
        == [f"samples/generated_plot_{e:04d}.jpg" for e in range(1, epochs + 1)]
    assert port_plots.calls == jax_plots.calls == [f"plot_line_plot_loss_{epochs}.png"]


def test_cyclegan_engine_exports_as_jax(tmp_path, monkeypatch):
    """Epochs 0-2 with checkpoint_frequency 2, then a second engine that
    auto-resumes for epoch 3 with frequency 3."""
    size, batch = 96, 1
    dss = [tdata.SyntheticImageDataset(1, (size, size), seed=s) for s in (1, 2)]
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    port_figs = _figures(monkeypatch, tpreview, ["translation_sheet"])
    port_plots = _Recorder()
    for epochs, freq in ((3, 2), (1, 3)):
        eng = tcyc.CycleGANEngine(*dss, str(port_root), batch, (size, size), device=CPU,
                                  base_width=8, n_res_blocks=2)
        eng.plot_history = lambda: port_plots(eng.path)
        eng.train(epochs, freq)

    gf = bridge.export_variables(eng.state.gen_f)
    gg = bridge.export_variables(eng.state.gen_g)
    jax_figs = _figures(monkeypatch, jpreview, ["translation_sheet"])
    jax_plots = _Recorder()
    jdss = [jdata.SyntheticImageDataset(1, (size, size), seed=s) for s in (1, 2)]
    jeng = _stand_in(
        jcyc.CycleGANEngine, path=str(jax_root), epoch=0, batch_size=batch,
        loader=jdata.PairedDataset(*jdss), _resident=(None, None), ckpt_manager=_Recorder(),
        preview_output=str(jax_root / "preview"),
        losses=jmetrics.LossHistory(jax_root / "losses.pickle", jcyc.LOSS_KEYS),
    )
    jeng._epoch_runner = lambda state, *args: (None, {k: np.zeros(1) for k in jcyc.LOSS_KEYS})
    jeng._local_state = lambda: types.SimpleNamespace(gf_params=gf["params"],
                                                      gg_params=gg["params"])
    jeng._translate_g = jeng._translate_f = lambda state, x: x
    jeng.plot_history = lambda: jax_plots(jeng.path)
    jeng.train(3, 2)
    jeng.epoch = 3  # the JAX engine's auto-resume from checkpoint 3
    jeng.train(1, 3)

    assert _written(port_root) == _written(jax_root)
    assert sorted(_written(port_root)) == [
        f"models/generator_{n}/gen_weights_{n}-{e}.msgpack"
        for n in ("f", "g") for e in (0, 2, 3)]
    assert eng.ckpt_manager.all_epochs() == jeng.ckpt_manager.calls == [1, 2, 3, 4]
    assert _relative(port_figs["translation_sheet"].calls, port_root) \
        == _relative(jax_figs["translation_sheet"].calls, jax_root) == ["preview.pdf"] * 4
    assert _relative(port_plots.calls, port_root) == _relative(jax_plots.calls, jax_root) \
        == [".", "."]


def test_engines_skip_figures_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Without matplotlib (the GPU machine) an engine prints one line naming
    what it does not draw, draws nothing and still writes its exports."""
    monkeypatch.setattr(tpreview.importlib.util, "find_spec",
                        lambda name: None if name == "matplotlib" else object())
    ds = tdata.SyntheticImageDataset(4, (16, 16), seed=0)
    eng = tsnd.SNDCGANEngine(str(tmp_path / "run"), ds, 4, image_size=(16, 16, 3),
                             z_size=8, base_width=16, device=CPU,
                             live_output=str(tmp_path / "live"))
    eng.train(1, 1)
    out = capsys.readouterr().out
    assert out.count("matplotlib is not installed") == 1
    assert "live.pdf" in out and "plot_line_plot_loss.png" in out
    assert not (tmp_path / "live.pdf").exists()
    assert not (tmp_path / "run" / "plot_line_plot_loss.png").exists()
    assert (tmp_path / "run" / "models" / "generator" / "gen_model-0.msgpack").exists()


def test_trainer_c_flags_pace_the_exports(monkeypatch, tmp_path):
    """`-c` reaches the WGAN engine as `save_interval` and the CycleGAN
    engine's train() as `checkpoint_frequency`, as in the JAX trainers."""
    from imagegeneration_tpu_torch.cli import cyclegan_trainer, wgan_trainer

    seen = {}

    class WGAN:
        def __init__(self, *args, **kwargs):
            seen["save_interval"] = kwargs["save_interval"]

        def train(self, epochs):
            seen["wgan_epochs"] = epochs

    class CycleGAN:
        def __init__(self, *args, **kwargs):
            pass

        def train(self, epochs, checkpoint_frequency):
            seen["checkpoint_frequency"] = checkpoint_frequency

    monkeypatch.setattr(twgan, "WGANEngine", WGAN)
    monkeypatch.setattr(tcyc, "CycleGANEngine", CycleGAN)
    wgan_trainer.main(["2", "4", "-c", "3", "-d", str(tmp_path), "--device", "cpu"])
    cyclegan_trainer.main(["2", "4", "-c", "7", "-d", str(tmp_path), "--device", "cpu"])
    assert seen == {"save_interval": 3, "wgan_epochs": 4, "checkpoint_frequency": 7}
