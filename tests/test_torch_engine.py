"""Port engine and CLI end to end on the CPU, and the package's imports.

- The CLI trains on a tiny PNG folder for 2 epochs (the reference's
  `epochs + 1` quirk: `epochs=1`), then resumes with `-ct` for one more
  epoch. Artifacts: losses.pickle with the reference keys, perf.jsonl one
  line per epoch, at most 2 checkpoints, and the resumed state continues
  the step counter.
- Importing every module of the port leaves jax and flax out of
  sys.modules (a fresh interpreter), and matplotlib, PIL and cv2 too: the
  GPU machine lacks matplotlib, so the port imports these only inside the
  functions that draw or decode.
- On the CPU no kernel is launched: the launch counters stay 0.
"""

import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from imagegeneration_tpu_torch.cli import sndcgan_trainer
from imagegeneration_tpu_torch.core import checkpoint as ckptlib
from imagegeneration_tpu_torch.core import data as datalib
from imagegeneration_tpu_torch.ops import adam as tadam
from imagegeneration_tpu_torch.ops import dropout as tdrop
from imagegeneration_tpu_torch.train import sndcgan_engine

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def png_folder(tmp_path):
    rng = np.random.default_rng(3)
    d = tmp_path / "data" / "landscape"
    d.mkdir(parents=True)
    for i in range(5):
        h, w = rng.integers(20, 40), rng.integers(20, 50)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(d / f"i{i}.png")
    return tmp_path / "data"


def _cli(out, data, epochs, *extra):
    sndcgan_trainer.main([
        "2", str(epochs), "-cf", "1", "-d", str(out), "-x", str(data),
        "-lo", str(out.parent / "live"),
        "--height", "16", "--width", "16", "--spectral-norm", "--loss", "hinge",
        "--device", "cpu", *extra,
    ])


def test_cli_train_and_resume(tmp_path, png_folder):
    out = tmp_path / "train"
    _cli(out, png_folder, 1)  # epochs + 1 = 2 epochs: 0 and 1
    hist = pickle.loads((out / "losses.pickle").read_bytes())
    assert set(hist) == set(sndcgan_engine.LOSS_KEYS)
    assert hist["epoch"] == [0, 1]
    assert all(np.isfinite(hist[k]).all() for k in hist)
    perf = [json.loads(line) for line in (out / "perf.jsonl").read_text().splitlines()]
    assert [p["epoch"] for p in perf] == [0, 1]
    assert perf[0]["device"] == "cpu" and perf[0]["steps_per_sec"] > 0
    mgr = ckptlib.CheckpointManager(out / "checkpoints")
    assert mgr.all_epochs() == [0, 1]
    # 5 images at batch 2: 2 steps per epoch
    assert int(mgr.restore()["step"]) == 4
    # the figures (matplotlib is installed here) and the params-only exports
    assert (tmp_path / "live.pdf").exists() and (out / "plot_line_plot_loss.png").exists()
    assert sorted(p.name for p in (out / "models" / "generator").iterdir()) == [
        "gen_model-0.msgpack", "gen_model-1.msgpack"]
    assert sorted(p.name for p in (out / "models" / "discriminator").iterdir()) == [
        "disc_model-0.msgpack", "disc_model-1.msgpack"]

    _cli(out, png_folder, 2, "-ct")  # resumes at epoch 2, trains epoch 2
    hist = pickle.loads((out / "losses.pickle").read_bytes())
    assert hist["epoch"] == [0, 1, 2]
    assert mgr.all_epochs() == [1, 2]  # max_to_keep=2
    state = mgr.restore()
    assert int(state["step"]) == 6
    assert int(state["g_opt"]["count"]) == 6 and int(state["d_opt"]["count"]) == 12
    assert (tdrop.LAUNCHES, tadam.LAUNCHES) == (
        {"leaky_relu_dropout_fwd": 0, "leaky_relu_dropout_bwd": 0}, {"adam": 0})


def test_streaming_engine_and_sampler(tmp_path, monkeypatch):
    # A budget of 0 bytes sends every dataset through the streaming path.
    monkeypatch.setattr(datalib, "resident_budget", lambda device: 0)
    ds = datalib.SyntheticImageDataset(4, (16, 16))
    eng = sndcgan_engine.SNDCGANEngine(
        str(tmp_path / "s"), ds, 2, image_size=(16, 16, 3), base_width=16,
        device=torch.device("cpu"), d_updates=1, live_output=str(tmp_path / "live"),
    )
    assert not eng.resident
    eng.train(1, 1)
    assert np.isfinite(list(eng.last_epoch_metrics.values())).all()
    imgs = eng.sample(torch.zeros(3, 128))
    assert imgs.shape == (3, 16, 16, 3) and imgs.min() >= 0.0 and imgs.max() <= 1.0


def test_cli_refuses_mesh_flags(tmp_path, capsys):
    # data and spatial parallelism are ported (tests/test_torch_dp.py,
    # tests/test_torch_spatial.py); a spatial axis without a data axis is
    # refused, and more ranks than visible cards are refused, not shrunk
    with pytest.raises(SystemExit):
        sndcgan_trainer.main(["2", "1", "-d", str(tmp_path), "--mesh-spatial", "2"])
    assert "needs --mesh-data >= 1" in capsys.readouterr().err
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="need 2 cards"):
            sndcgan_trainer.main(["2", "1", "-d", str(tmp_path), "--mesh-data", "2"])


def test_importing_the_port_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import imagegeneration_tpu_torch as p\n"
        "mods = list(pkgutil.walk_packages(p.__path__, p.__name__ + '.'))\n"
        "for m in mods:\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'imagegeneration_tpu', "
        "'matplotlib', 'PIL', 'cv2', 'h5py'))\n"
        "print(len(mods), bad)\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 15  # every module was imported


def test_training_entry_points_hold_cudnn_to_deterministic_algorithms(monkeypatch):
    """Every entry point's device choice (resolve_device, require_cuda)
    pins float32 numerics and keeps cuDNN to deterministic algorithms, with
    no algorithm chosen by timing: the JAX steps are bit-stable run to run."""
    from imagegeneration_tpu_torch.core import platform

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert platform.resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    assert not torch.backends.cudnn.allow_tf32
    assert platform.configure_numerics() == {
        "cudnn.allow_tf32": False, "cuda.matmul.allow_tf32": False,
        "cudnn.deterministic": True, "cudnn.benchmark": False}


def _one_trace(run_dir, epoch):
    """The run's traces: exactly one, of `epoch`, with events in it."""
    traces = sorted(p.name for p in (Path(run_dir) / "traces").iterdir())
    assert traces == [f"epoch_{epoch}.rank0.json"]
    events = json.loads((Path(run_dir) / "traces" / traces[0]).read_text())["traceEvents"]
    assert any(e.get("ph") == "X" and e.get("cat") == "cpu_op" for e in events)


def test_engine_profile_traces_the_second_epoch(tmp_path, monkeypatch):
    """profile=True: one torch.profiler trace, of the run's second epoch,
    under <dir>/traces (CPU activity here); a resumed run traces its own
    second epoch; one epoch writes none."""
    ds = datalib.SyntheticImageDataset(4, (16, 16))
    kwargs = dict(image_size=(16, 16, 3), base_width=16, device=torch.device("cpu"),
                  live_output=str(tmp_path / "live"), profile=True)
    monkeypatch.setattr(sndcgan_engine.previewlib, "matplotlib_available", lambda s: False)
    eng = sndcgan_engine.SNDCGANEngine(str(tmp_path / "p"), ds, 2, **kwargs)
    eng.train(2, 1)
    _one_trace(tmp_path / "p", 1)
    resumed = sndcgan_engine.SNDCGANEngine(str(tmp_path / "p"), ds, 2, continue_=True, **kwargs)
    (tmp_path / "p" / "traces" / "epoch_1.rank0.json").unlink()
    resumed.train(4, 1)  # epochs 2 and 3: the run's second is 3
    _one_trace(tmp_path / "p", 3)
    one = sndcgan_engine.SNDCGANEngine(str(tmp_path / "q"), ds, 2, **kwargs)
    one.train(1, 1)
    assert not (tmp_path / "q" / "traces").exists()


def test_preview_frequency_draws_every_nth_epoch(tmp_path, monkeypatch):
    """preview_frequency=2 draws the live preview at epochs 0 and 2 only
    (epoch % 2 == 0, as the JAX engine); 0 or less is 1, every epoch."""
    drawn = []
    monkeypatch.setattr(sndcgan_engine.previewlib, "matplotlib_available", lambda s: True)
    monkeypatch.setattr(sndcgan_engine.previewlib, "live_preview",
                        lambda samples, text, out: drawn.append((samples.shape, out)))
    monkeypatch.setattr(sndcgan_engine.SNDCGANEngine, "plot_history", lambda self: None)
    ds = datalib.SyntheticImageDataset(2, (16, 16))
    live = str(tmp_path / "live")
    for freq, want in ((2, [0, 2]), (0, [0, 1, 2, 3])):
        drawn.clear()
        eng = sndcgan_engine.SNDCGANEngine(
            str(tmp_path / f"f{freq}"), ds, 2, image_size=(16, 16, 3), base_width=16,
            device=torch.device("cpu"), live_output=live, preview_frequency=freq)
        eng.train(4, 10)
        assert len(drawn) == len(want) and eng.preview_frequency == max(1, freq)
        assert all(d == ((3, 16, 16, 3), live + ".pdf") for d in drawn)
    args = sndcgan_trainer.build_parser().parse_args(["2", "1"])
    assert args.preview_every == 1 and not args.profile


def test_cli_profile_and_preview_every(tmp_path, png_folder, monkeypatch):
    """--profile and --preview-every reach the engine: a 2-epoch CLI run
    writes the second epoch's trace."""
    seen = {}
    real = sndcgan_engine.SNDCGANEngine

    def engine(*args, **kwargs):
        seen.update(profile=kwargs["profile"], preview=kwargs["preview_frequency"])
        return real(*args, **kwargs)

    monkeypatch.setattr(sndcgan_engine, "SNDCGANEngine", engine)
    out = tmp_path / "train"
    _cli(out, png_folder, 1, "--profile", "--preview-every", "3")
    assert seen == {"profile": True, "preview": 3}
    _one_trace(out, 1)
