"""The CycleGAN perception-distance CLI (cli/cyclegan_evaluation.py): the port
against the JAX package.

A folder of 3 PNG images (32x32) and two generator exports of one
directory, `gen_weights_g-1` and `gen_weights_g-3`: port-initialized
CycleGAN generators at the CLI's defaults (base 64, 9 res blocks), written
by the JAX package's `export_params`; one VGG16 h5 (Keras-2 layout) written
from variables with the JAX module's leaves (tests/test_torch_pd.py). Both
packages' `main_eval` score every export on the whole folder (`-s` = the
folder's size: the packages shuffle differently, so a smaller sample would
take other images), and each epoch's sorted PDs agree within 1e-4 relative.

Also: the exports `gen_weights_f-*` come before `gen_weights_g-*` in one
directory, and a directory with neither raises FileNotFoundError; the two
figures are written where matplotlib is installed, and without it one line
is printed; the CLI's default device is the CUDA card, and it raises
without one.
"""

import sys

import cv2
import numpy as np
import pytest
import torch

from imagegeneration_tpu.cli import cyclegan_evaluation as jcli
from imagegeneration_tpu.core import checkpoint as jckpt
from imagegeneration_tpu.evalx import pd as jpd
from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.cli import cyclegan_evaluation as tcli
from imagegeneration_tpu_torch.models.cyclegan import CycleGANConfig, Generator
from test_torch_pd import random_like_init, write_keras_h5

torch.set_num_threads(1)
SIZE, N_IMAGES = 32, 3
RTOL = 1e-4


def _export(directory, name: str, epoch: int, seed: int) -> None:
    gen = Generator(CycleGANConfig(image_size=(SIZE, SIZE, 3)),
                    torch.Generator().manual_seed(seed))
    jckpt.export_params(directory / f"gen_weights_{name}-{epoch}.msgpack",
                        bridge.export_variables(gen))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("pd")
    samples = root / "samples"
    samples.mkdir()
    rng = np.random.default_rng(9)
    for i in range(N_IMAGES):
        cv2.imwrite(str(samples / f"s{i}.png"),
                    rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8))
    gens = root / "models" / "generator_g"
    gens.mkdir(parents=True)
    for epoch, seed in ((1, 21), (3, 23)):
        _export(gens, "g", epoch, seed)
    variables = random_like_init(jpd.VGG16Features(), (1, 32, 32, 3), seed=7)
    h5 = root / "vgg16.h5"
    write_keras_h5(h5, {n: {"kernel:0": p["kernel"], "bias:0": p["bias"]}
                        for n, p in variables["params"].items()})
    return root, variables


def test_main_eval_matches_jax(setup, tmp_path, monkeypatch):
    root, variables = setup
    args = (str(root / "samples"), str(root / "models" / "generator_g"), N_IMAGES)
    dim = (SIZE, SIZE, 3)
    # The JAX loader's flax init (seconds of eager compiles on the CPU) is
    # replaced by the variables: the file overwrites every leaf.
    monkeypatch.setattr(jpd.VGG16Features, "init", lambda self, key, x: variables)
    (tmp_path / "jax").mkdir()
    want_epochs, want = jcli.main_eval(*args, str(tmp_path / "jax"), dim, str(root / "vgg16.h5"))
    out = tmp_path / "port"
    out.mkdir()
    epochs, got, seconds = tcli.main_eval(*args, str(out), dim, str(root / "vgg16.h5"),
                                          device=torch.device("cpu"))
    assert epochs == want_epochs == [1, 3]
    assert len(seconds) == 2 and all(s["features"] > 0 and s["math"] >= 0 for s in seconds)
    for g, w in zip(got, want):
        assert len(g) == len(w) == N_IMAGES and min(g) > 0
        np.testing.assert_allclose(sorted(g), sorted(w), rtol=RTOL, atol=0)
    assert (out / "plot_boxplot_fids.pdf").exists() and (out / "plot_line_plot_fids.pdf").exists()


def test_cli_reads_one_directory_f_first(setup, tmp_path, capsys):
    root, _ = setup
    both = tmp_path / "both"
    both.mkdir()
    _export(both, "g", 1, 31)
    _export(both, "f", 2, 32)
    argv = [str(both), str(root / "samples"), "-s", "1", "-o", str(tmp_path),
            "--height", str(SIZE), "--width", str(SIZE), "--device", "cpu"]
    epochs, pds, _ = tcli.main(argv)
    assert epochs == [2, 1] and [len(p) for p in pds] == [1, 1]
    assert "epoch 2: PD mean" in capsys.readouterr().out
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        tcli.main([str(empty), *argv[1:]])


def test_plots_skipped_without_matplotlib(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    tcli.plot_pd([1, 0], [[0.5, 0.25], [0.75, 1.0]], str(tmp_path))
    assert capsys.readouterr().out.strip() == (
        "matplotlib is not installed: not writing plot_boxplot_fids.pdf and "
        "plot_line_plot_fids.pdf")
    assert not list(tmp_path.iterdir())


def test_default_device_is_the_card(setup, monkeypatch):
    root, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([str(root / "models" / "generator_g"), str(root / "samples")])
