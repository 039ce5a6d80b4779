"""InceptionV3 pool features (evalx/inception.py): the port against the JAX package.

The JAX InceptionV3Features variables have the leaves of a flax init at
75x75, the smallest input the trunk takes (the leaves do not depend on the
input size; their shapes from `jax.eval_shape`), with values drawn from a
numpy seed: the batch norms' beta, moving mean and moving variance are not
the init's 0, 0 and 1, so the statistics are exercised. The port takes them
through `bridge.load_jax_inception`.

- The layer names: 94 `conv2d*` / `batch_normalization*` pairs, the JAX
  module's, in its creation order (the bridge copies leaf by leaf and
  checks every shape).
- The trunk at (2, 75, 75, 3), and one 299x299 image through
  `make_feature_fn`: max abs error within 1e-4 of the largest feature.
- `prepare_images` against `jax.image.resize(method="bilinear")` to 299 at
  128x128, 144x256, 288x512 and 512x512: within 1e-5 (images in [-1, 1]).
- The h5 loaders: a Keras-2 `save_weights` h5 written from the variables
  loads into both packages as the same arrays. An explicitly named missing
  file raises FileNotFoundError; no file at all prints the JAX package's
  line and gives the port's fixed-seed init (moving mean 0, variance 1),
  the same every call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegeneration_tpu.evalx import inception as jinc
from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.evalx import inception as tinc
from test_torch_pd import assert_close_to_max, random_like_init, write_keras_h5

torch.set_num_threads(1)
N_PAIRS = 94


@pytest.fixture(scope="module")
def variables():
    v = random_like_init(jinc.InceptionV3Features(), (1, 75, 75, 3), seed=4)
    rng = np.random.default_rng(5)
    v["batch_stats"] = jax.tree.map(lambda a: a * 2.0, v["batch_stats"])
    for stats in v["batch_stats"].values():
        stats["var"] = rng.uniform(0.5, 1.5, stats["var"].shape).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def model(variables):
    m = tinc.InceptionV3Features().eval()
    bridge.load_jax_inception(m, variables)
    return m


def test_layer_names_are_the_jax_modules(variables, model):
    names = [n for n, _ in model.named_children()]
    convs = [n for n in names if n.startswith("conv2d")]
    assert len(convs) == len(names) - len(convs) == N_PAIRS
    assert convs == ["conv2d"] + [f"conv2d_{i}" for i in range(1, N_PAIRS)]
    assert sorted(names) == sorted(variables["params"])
    assert sorted(variables["batch_stats"]) == sorted(n for n in names if n not in convs)


def test_features_match_jax_at_75(variables, model):
    x = np.random.default_rng(0).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jinc.InceptionV3Features().apply)(variables, x))
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 2048)
    assert_close_to_max(got, want)


def test_feature_fn_matches_jax_at_299(variables, model):
    x = np.random.default_rng(1).uniform(-1, 1, (1, 299, 299, 3)).astype(np.float32)
    want = np.asarray(jinc.make_feature_fn(variables)(jnp.asarray(x)))
    got = tinc.make_feature_fn(model)(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 2048)
    assert_close_to_max(got, want)


@pytest.mark.parametrize("hw", [(128, 128), (144, 256), (288, 512), (512, 512)])
def test_prepare_images_matches_jax(hw):
    x = np.random.default_rng(sum(hw)).uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jinc.prepare_images(jnp.asarray(x)))
    got = tinc.prepare_images(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_h5_loaders_give_equal_arrays(variables, tmp_path, monkeypatch):
    params, stats = variables["params"], variables["batch_stats"]
    layers = {n: {"kernel:0": p["kernel"]} for n, p in params.items() if "kernel" in p}
    layers.update({n: {"beta:0": params[n]["bias"], "moving_mean:0": s["mean"],
                       "moving_variance:0": s["var"]} for n, s in stats.items()})
    h5 = tmp_path / "inception.h5"
    write_keras_h5(h5, layers)
    # Every leaf the JAX loader returns comes from the file; its flax init
    # at 299x299 (~25 s of eager compiles on the CPU) is replaced by the
    # variables.
    monkeypatch.setattr(jinc.InceptionV3Features, "init", lambda self, key, x: variables)
    want = jax.tree.map(np.asarray, jinc.load_inception_params(str(h5)))
    got = tinc.load_inception_params(str(h5))
    children = dict(got.named_children())
    assert sorted(children) == sorted(want["params"])
    for name, layer in children.items():
        if name.startswith("conv2d"):
            np.testing.assert_array_equal(
                layer.weight.detach().numpy(),
                bridge.to_torch_layout("conv", want["params"][name]["kernel"]))
            continue
        np.testing.assert_array_equal(layer.bias.detach().numpy(), want["params"][name]["bias"])
        for key in ("mean", "var"):
            np.testing.assert_array_equal(getattr(layer, key).numpy(),
                                          want["batch_stats"][name][key])


def test_loader_without_a_file(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv(tinc.WEIGHTS_ENV, raising=False)
    with pytest.raises(FileNotFoundError):
        tinc.load_inception_params(str(tmp_path / "missing.h5"))
    a, b = tinc.load_inception_params(), tinc.load_inception_params()
    assert capsys.readouterr().out.count("[inception] no weights available") == 2
    for (name, ta), (_, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(ta, tb), name
    bn = a.batch_normalization_93
    assert not bn.bias.detach().any() and not bn.mean.any() and (bn.var == 1).all()
