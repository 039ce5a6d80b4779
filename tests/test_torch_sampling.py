"""The sampling CLI (cli/generator_output.py): the port against the JAX package.

- `create_samples` from the same JAX-made export (flax-initialized
  generator, 16x24, base 16, written by the JAX package's export_params)
  and the same z, passed explicitly, equals the JAX function's output to
  1e-5 absolute (float32 convolutions in another summation order).
- `output_results_models` picks the epochs the JAX function picks, for a
  grid of (start, every): the files present, >= start, then every
  `every`-th. The JAX side runs with its sampler and grid replaced by
  recorders (only its epoch choice is compared); the port samples for real.
- Exports and checkpoints of one port training run (base width 16, read
  from the files) give the same epochs and bit-equal samples, in [0, 1],
  and the CLI writes the epoch-grid PDF.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegeneration_tpu.cli import generator_output as jout
from imagegeneration_tpu.core import checkpoint as jckpt
from imagegeneration_tpu.core import preview as jpreview
from imagegeneration_tpu.models import sndcgan as jmodels
from imagegeneration_tpu_torch.cli import generator_output as tout
from imagegeneration_tpu_torch.core import checkpoint as tckpt
from imagegeneration_tpu_torch.core import data as tdata
from imagegeneration_tpu_torch.core import preview as tpreview
from imagegeneration_tpu_torch.models import sndcgan as tmodels
from imagegeneration_tpu_torch.train import sndcgan_engine as tsnd

torch.set_num_threads(1)
IMAGE = (16, 24, 3)
BASE, BATCH = 16, 3
CPU = torch.device("cpu")
EPOCHS = (0, 1, 2, 3, 5, 8, 10)


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    """A JAX generator export, and the JAX module that made it."""
    cfg = jmodels.SNDCGANConfig(image_size=IMAGE, base_width=BASE)
    gen = jmodels.Generator(cfg)
    variables = jax.device_get(jax.jit(lambda k: gen.init(
        {"params": k}, jnp.zeros((1, 128)), train=False))(jax.random.key(3)))
    # batch statistics away from their init, as after training
    variables["batch_stats"] = jax.tree.map(
        lambda x: np.asarray(x) * 0.5 + 0.1, variables["batch_stats"])
    path = tmp_path_factory.mktemp("sampling") / "gen_model-0.msgpack"
    jckpt.export_params(path, variables)
    return path, gen


def test_create_samples_matches_jax(jax_export):
    path, jgen = jax_export
    z = np.random.default_rng(0).uniform(-1, 1, (BATCH, 128)).astype(np.float32)
    want = jout.create_samples(jgen, jckpt.load_params(path), jnp.asarray(z), BATCH, IMAGE)
    tgen = tmodels.Generator(tmodels.SNDCGANConfig(image_size=IMAGE, base_width=BASE))
    got = tout.create_samples(tgen, tckpt.load_params(path), z, BATCH, IMAGE)
    assert got.shape == want.shape == (BATCH, *IMAGE) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


class _Grid:
    def __init__(self):
        self.calls = []

    def __call__(self, epoch_samples, epochs_used, out_file):
        self.calls.append((list(epochs_used), len(epoch_samples), str(out_file)))


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory, jax_export):
    root = tmp_path_factory.mktemp("run")
    gen_dir = root / "models" / "generator"
    gen_dir.mkdir(parents=True)
    data = jax_export[0].read_bytes()
    for e in EPOCHS:
        (gen_dir / f"gen_model-{e}.msgpack").write_bytes(data)
    (gen_dir / "gen_model-4.msgpack.tmp").write_bytes(b"")
    return root


@pytest.mark.parametrize("start,every", [(0, 1), (0, 2), (1, 3), (3, 1), (4, 2), (9, 5)])
def test_output_results_models_picks_the_jax_epochs(export_dir, monkeypatch, start, every):
    jax_grid, port_grid = _Grid(), _Grid()
    monkeypatch.setattr(jout, "create_samples",
                        lambda gen, v, z, b, size: np.zeros((b, *size), np.float32))
    monkeypatch.setattr(jckpt, "load_params", lambda path: None)
    monkeypatch.setattr(jpreview, "epoch_grid", jax_grid)
    monkeypatch.setattr(tpreview, "epoch_grid", port_grid)
    args = (BATCH, str(export_dir), every, "grid", start, IMAGE, 128, 62)
    want = jout.output_results_models(*args)
    got, samples = tout.output_results_models(*args, device=CPU, return_samples=True)
    assert got == want == [e for e in EPOCHS if e >= start][::every]
    assert port_grid.calls == jax_grid.calls
    assert len(samples) == len(got) and all(s.shape == (BATCH, *IMAGE) for s in samples)
    # the same export at every epoch and one fixed z: the same samples
    assert all(np.array_equal(s, samples[0]) for s in samples)


def test_no_epoch_left_raises_as_jax(export_dir, monkeypatch):
    monkeypatch.setattr(jckpt, "load_params", lambda path: None)
    args = (BATCH, str(export_dir), 1, "grid", 11, IMAGE, 128, 62)
    with pytest.raises(FileNotFoundError):
        jout.output_results_models(*args)
    with pytest.raises(FileNotFoundError):
        tout.output_results_models(*args, device=CPU)


def test_exports_and_checkpoints_give_the_same_samples(tmp_path):
    """Two epochs of the port's engine (a checkpoint and exports each), then
    both variants of the CLI over them."""
    run = tmp_path / "run"
    eng = tsnd.SNDCGANEngine(str(run), tdata.SyntheticImageDataset(4, (16, 16)), 4,
                             image_size=(16, 16, 3), base_width=BASE, device=CPU,
                             live_output=str(tmp_path / "live"))
    eng.plots = False  # the engine's own figures are not what is tested here
    eng.train(2, 1)
    args = (BATCH, str(run), 1, "grid", 0, (16, 16, 3), 128, 62)
    kw = dict(device=CPU, return_samples=True)
    epochs_m, from_models = tout.output_results_models(*args, **kw)
    epochs_c, from_ckpts = tout.output_results_ckpts(*args, **kw)
    assert epochs_m == epochs_c == [0, 1]
    for a, b in zip(from_models, from_ckpts):
        np.testing.assert_array_equal(a, b)
        assert a.shape == (BATCH, 16, 16, 3) and 0.0 <= a.min() and a.max() <= 1.0
    assert not np.array_equal(from_models[0], from_models[1])
    (run / "grid.pdf").unlink()
    tout.main(["1", "-d", str(run), "-o", "cli_grid", "--height", "16", "--width", "16",
               "--device", "cpu", "--from-checkpoints"])
    assert (run / "cli_grid.pdf").stat().st_size > 0
