"""Preview sheets (core/preview.py): the port against the JAX package.

Each figure function of the port hands matplotlib the same images (every
array that reaches `Axes.imshow`, exact, in order), the same titles and the
same file names as the JAX function on the same input, and writes its file.
`plot_image`'s double denormalisation is part of what is compared: samples
in [0, 1] reach imshow in [0.5, 1].
"""

import matplotlib

matplotlib.use("Agg")
import numpy as np
import pytest
from matplotlib.axes import Axes
from matplotlib.figure import Figure

from imagegeneration_tpu.core import preview as jpreview
from imagegeneration_tpu_torch.core import preview as tpreview


@pytest.fixture()
def drawn(monkeypatch):
    """What reaches imshow, set_title, suptitle and savefig, in order."""
    calls = []
    imshow, savefig = Axes.imshow, Figure.savefig
    set_title, suptitle = Axes.set_title, Figure.suptitle

    def rec(kind, orig, transform=lambda a: a):
        def wrapper(self, arg, *args, **kwargs):
            calls.append((kind, transform(arg)))
            return orig(self, arg, *args, **kwargs)
        return wrapper

    monkeypatch.setattr(Axes, "imshow", rec("imshow", imshow, np.array))
    monkeypatch.setattr(Axes, "set_title", rec("title", set_title))
    monkeypatch.setattr(Figure, "suptitle", rec("suptitle", suptitle))
    monkeypatch.setattr(Figure, "savefig", rec("savefig", savefig, lambda p: p.name))
    return calls


def _images(n, seed, low=0.0):
    return np.random.default_rng(seed).uniform(low, 1.0, (n, 12, 20, 3)).astype(np.float32)


CASES = {
    "live_preview": lambda out: ((_images(3, 0), "Epoch 0007 | info", out / "live.pdf"), {}),
    "sample_grid": lambda out: ((_images(6, 1), 2, 3, out / "samples" / "g.jpg"),
                                {"figsize": (6, 4)}),
    "epoch_grid": lambda out: (([_images(2, 2), _images(2, 3)], [4, 9], out / "grid.pdf"), {}),
    "translation_sheet": lambda out: (
        (_images(2, 4, -1.0), _images(2, 5, -1.0), _images(2, 6, -1.0),
         _images(2, 7, -1.0), 12, out / "preview.pdf"), {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_figures_match_jax(name, drawn, tmp_path):
    results = []
    for module, sub in ((jpreview, "jax"), (tpreview, "port")):
        args, kwargs = CASES[name](tmp_path / sub)
        drawn.clear()
        getattr(module, name)(*args, **kwargs)
        results.append(list(drawn))
        assert args[-1].stat().st_size > 0
    want, got = results
    assert [k for k, _ in got] == [k for k, _ in want]
    assert sum(k == "imshow" for k, _ in got) == {
        "live_preview": 3, "sample_grid": 6, "epoch_grid": 4, "translation_sheet": 8}[name]
    for (kind, a), (_, b) in zip(got, want):
        if kind == "imshow":
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_plot_image_denormalises_twice(drawn):
    fig = Figure()
    tpreview.plot_image(fig.add_subplot(), np.array([[[0.0, 0.5, 1.0]]]))
    np.testing.assert_array_equal(drawn[0][1], [[[0.5, 0.75, 1.0]]])


def test_matplotlib_available_names_what_it_skips(monkeypatch, capsys):
    assert tpreview.matplotlib_available("x.pdf") and capsys.readouterr().out == ""
    monkeypatch.setattr(tpreview.importlib.util, "find_spec", lambda name: None)
    assert not tpreview.matplotlib_available("x.pdf and y.png")
    assert capsys.readouterr().out == "matplotlib is not installed: not writing x.pdf and y.png\n"
