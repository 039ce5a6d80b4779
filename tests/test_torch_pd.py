"""CycleGAN perception distance (evalx/pd.py): the port against the JAX package.

The JAX VGG16Features variables have the leaves of a flax init (their
shapes from `jax.eval_shape`, which compiles nothing) with values drawn
from a numpy seed, biases included; the port's VGG16Features takes them
through `bridge.load_jax_vgg16`. Inputs are uniform in [-1, 1] from a numpy
seed.

- The trunk at (2, 32, 32, 3) and (2, 224, 224, 3): max abs error within
  1e-4 of the largest feature.
- `nearest_resize_224` is bit-equal to `jax.image.resize(method="nearest")`
  at 128x128, 144x256, 288x512 and 64x72 (torch's `nearest` mode is not).
- `make_pd_fn` on 4 pairs at 128x128: within 1e-4 relative per pair;
  PD(x, x) is exactly 0; `calculate_pd` gives a pair's value.
- The h5 loaders: a Keras-2 `save_weights` h5 (`<layer>/<layer>/kernel:0`,
  `bias:0`) written from the variables loads into both packages as the
  same arrays. An explicitly named missing file raises FileNotFoundError
  (the JAX loader returns its random init there, a known fault of the
  reference); no file at all gives the port's fixed-seed init, the same
  every call; a named file without h5py raises ImportError.
"""

import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from imagegeneration_tpu.evalx import pd as jpd
from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.evalx import pd as tpd

torch.set_num_threads(1)
RTOL = 1e-4


def write_keras_h5(path, layers: dict[str, dict[str, np.ndarray]]) -> None:
    """A Keras-2 `save_weights` h5: `model_weights/<layer>/<layer>/<name>`
    per dataset, e.g. {"block1_conv1": {"kernel:0": k, "bias:0": b}}."""
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights")
        for name, datasets in layers.items():
            inner = root.create_group(name).create_group(name)
            for key, a in datasets.items():
                inner.create_dataset(key, data=a)


def random_like_init(module, shape, seed: int) -> dict:
    """The variables of `module.init` at input `shape`, drawn from a numpy
    seed: conv kernels N(0, 1/fan_in), other leaves N(0, 0.1)."""
    abstract = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros(shape))
    rng = np.random.default_rng(seed)

    def draw(leaf):
        if len(leaf.shape) == 4:
            fan_in = int(np.prod(leaf.shape[:3]))
            return rng.normal(0, fan_in**-0.5, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.1, leaf.shape).astype(np.float32)

    return jax.tree.map(draw, abstract)


def assert_close_to_max(got, want, rtol=RTOL):
    """max |got - want| <= rtol * max |want|."""
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def variables():
    return random_like_init(jpd.VGG16Features(), (1, 32, 32, 3), seed=3)


@pytest.fixture(scope="module")
def model(variables):
    m = tpd.VGG16Features().eval()
    bridge.load_jax_vgg16(m, variables)
    return m


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("size", [32, 224])
def test_vgg_features_match_jax(variables, model, size):
    x = _images((2, size, size, 3), size)
    want = np.asarray(jax.jit(jpd.VGG16Features().apply)(variables, x))
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, size // 16, size // 16, 512)
    assert_close_to_max(got, want)


@pytest.mark.parametrize("hw", [(128, 128), (144, 256), (288, 512), (64, 72)])
def test_nearest_resize_is_bit_equal_to_jax(hw):
    x = _images((2, *hw, 3), sum(hw))
    want = np.asarray(jpd.nearest_resize_224(jnp.asarray(x)))
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tpd.nearest_resize_224(t).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    # torch's "nearest" rounds pixel positions down: another image
    other = F.interpolate(t, size=(224, 224), mode="nearest").permute(0, 2, 3, 1).numpy()
    assert not np.array_equal(other, want)


def test_pd_matches_jax(variables, model):
    a, b = _images((4, 128, 128, 3), 1), _images((4, 128, 128, 3), 2)
    jfn = jpd.make_pd_fn(variables)
    want = np.asarray(jfn(a, b))
    pd = tpd.make_pd_fn(model)
    got = pd(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (4,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert (pd(torch.from_numpy(a), torch.from_numpy(a)).numpy() == 0).all()
    assert (np.asarray(jfn(a, a)) == 0).all()
    single = tpd.calculate_pd(pd, a[1], b[1])
    assert single == pytest.approx(jpd.calculate_pd(jfn, a[1], b[1]), rel=RTOL)


def test_h5_loaders_give_equal_arrays(variables, tmp_path, monkeypatch):
    params = variables["params"]
    h5 = tmp_path / "vgg16.h5"
    write_keras_h5(h5, {n: {"kernel:0": p["kernel"], "bias:0": p["bias"]}
                        for n, p in params.items()})
    # Every leaf the JAX loader returns comes from the file; its flax init
    # (seconds of eager compiles on the CPU) is replaced by the variables.
    monkeypatch.setattr(jpd.VGG16Features, "init", lambda self, key, x: variables)
    want = jax.tree.map(np.asarray, jpd.load_vgg16_params(str(h5)))
    got = tpd.load_vgg16_params(str(h5))
    convs = dict(got.named_children())
    assert sorted(convs) == sorted(want["params"]) and len(convs) == 11
    for name, conv in convs.items():
        np.testing.assert_array_equal(conv.bias.detach().numpy(), want["params"][name]["bias"])
        np.testing.assert_array_equal(
            conv.weight.detach().numpy(),
            bridge.to_torch_layout("conv", want["params"][name]["kernel"]))
    # the same file through the variable
    monkeypatch.setenv(tpd.WEIGHTS_ENV, str(h5))
    from_env = tpd.load_vgg16_params()
    assert torch.equal(from_env.block5_conv1.weight, got.block5_conv1.weight)


def test_loader_without_a_file(tmp_path, monkeypatch):
    monkeypatch.delenv(tpd.WEIGHTS_ENV, raising=False)
    missing = str(tmp_path / "missing.h5")
    with pytest.raises(FileNotFoundError):
        tpd.load_vgg16_params(missing)
    monkeypatch.setenv(tpd.WEIGHTS_ENV, missing)
    with pytest.raises(FileNotFoundError):
        tpd.load_vgg16_params()
    monkeypatch.delenv(tpd.WEIGHTS_ENV)
    a, b = tpd.load_vgg16_params(), tpd.load_vgg16_params()
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    # flax's lecun_normal: std sqrt(1 / fan_in), truncated at 2 std; zero bias
    w = a.block3_conv2.weight.detach()
    std = (9 * 256) ** -0.5
    assert abs(w.std().item() / std - 1) < 0.02 and w.abs().max().item() <= 2 * std / 0.8796
    assert not a.block3_conv2.bias.detach().any()


def test_named_file_needs_h5py(tmp_path, monkeypatch):
    h5 = tmp_path / "vgg16.h5"
    h5.write_bytes(b"")
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="needs h5py"):
        tpd.load_vgg16_params(str(h5))
