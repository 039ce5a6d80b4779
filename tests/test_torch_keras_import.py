"""The reference-weights migration (compat/keras_import.py): the port against
the JAX importer and against Keras.

- Trees: for the six kinds, from .h5 files written here with h5py at tiny
  widths from a numpy seed, in every layout the JAX readers take (a
  Keras-2 full model: `model_weights`, ':0' names; a Keras-3 full model:
  nested `<layer>/sequential/<layer>` groups; a Keras-2 `save_weights`
  file; no `layer_names`, h5py's key order, with names that sort in model
  order and with Keras's names, which do not; CycleGAN's `save_weights`
  with per-channel and per-H norms, at the root or under `model_weights`),
  the port's tree equals the JAX importer's: keys in order, shapes, dtypes,
  memory order and bytes, or both raise the same error.
- CLI: the port's file equals the JAX CLI's byte for byte, for each kind,
  and prints the same line.
- Errors: a wrong layer or weight count gives the JAX `ValueError`; a
  Keras-3 `.weights.h5` for CycleGAN a `ValueError`; without h5py both
  readers raise an `ImportError` that names it.
- Models: each tree loads into the port's model of its kind and comes back
  bit-equal (`bridge.flax_variables`); a per-H tree does not load into a
  per-channel model, nor the reverse.
- Keras ground truth: the reference architectures built in TF (the
  SNDCGAN and WGAN builders of tests/test_keras_import.py; the CycleGAN
  generator here, as that file builds it inside its test), saved, imported
  through the port's CLI and loaded from its export: the port's models
  match Keras within the JAX tests' bounds (SNDCGAN G and WGAN G atol
  2e-4, CycleGAN G 5e-4 with per-channel and per-H norms, SNDCGAN D rtol
  = atol = 2e-4), and the port's tree of each real file equals the JAX
  importer's.
- End to end: an imported generator at the reference width (512), exported
  by the port's CLI, sampled by the port's sampling CLI (`load_params`,
  `sndcgan_base_width`) equals the JAX generator's samples on the same z
  within tests/test_torch_sampling.py's 1e-5.
- A fresh interpreter that imports the port's module and converts a file
  holds no jax, flax or imagegeneration_tpu module.
"""

import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from imagegeneration_tpu.compat import keras_import as jki
from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.compat import keras_import as tki
from imagegeneration_tpu_torch.core import checkpoint as tckpt
from imagegeneration_tpu_torch.models import cyclegan as tcyc
from imagegeneration_tpu_torch.models import sndcgan as tsnd
from imagegeneration_tpu_torch.models import wgan as twgan

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
IMAGE, BASE = (16, 24, 3), 16  # SNDCGAN and WGAN
CG_IMAGE, CG_BASE, CG_RES = (96, 96, 3), 8, 2  # the PatchGAN needs >= 94 px
SEQUENTIAL = ("sndcgan-gen", "sndcgan-disc", "wgan-gen", "wgan-critic")
CYCLEGAN = ("cyclegan-gen", "cyclegan-disc")
MODEL_LAYOUTS = ("keras2_model", "keras3_model", "save_weights", "sorted_keys", "keras_keys")
WEIGHTS_LAYOUTS = ("save_weights", "model_weights")


# ---------------------------------------------------------------- fixtures
def _name(base: str, i: int) -> str:
    return base if i == 0 else f"{base}_{i}"


def _kernel(rng, shape, fan_in: int) -> np.ndarray:
    return rng.normal(0, fan_in**-0.5, shape).astype(np.float32)


def _vec(rng, n: int, scale: float = 0.1) -> np.ndarray:
    return rng.normal(0, scale, n).astype(np.float32)


def _bn(rng, c: int) -> dict:
    return {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32), "beta": _vec(rng, c),
            "moving_mean": _vec(rng, c),
            "moving_variance": rng.uniform(0.5, 1.5, c).astype(np.float32)}


def _generator_layers(rng, family: str, image=IMAGE, base=BASE) -> list:
    """A Keras generator's layers, [(name, {basename: array})] in model
    order (an empty dict for a layer without weights): SNDCGAN (dense, bn,
    (convT, bn) x3, convT; SNDCGAN.py:25-66) or WGAN (dense, (convT, bn) x3,
    conv; WGAN.py:105-134)."""
    h8, w8 = image[0] // 8, image[1] // 8
    stem = base * h8 * w8
    layers = [("dense", {"kernel": _kernel(rng, (128, stem), 128)})]
    if family == "sndcgan":
        layers += [("batch_normalization", _bn(rng, stem)), ("re_lu", {})]
    else:
        layers.append(("leaky_re_lu", {}))
    layers.append(("reshape", {}))
    feats = base
    for i, out in enumerate((base // 2, base // 4, base // 8)):
        bn = i + 1 if family == "sndcgan" else i
        # a 4x4 stride-2 ConvTranspose sums 2x2 taps of each input channel
        layers += [(_name("conv2d_transpose", i), {"kernel": _kernel(rng, (4, 4, out, feats),
                                                                     4 * feats)}),
                   (_name("batch_normalization", bn), _bn(rng, out)), (f"act_{i}", {})]
        feats = out
    last = "conv2d_transpose_3" if family == "sndcgan" else "conv2d"
    shape = (3, 3, 3, feats) if family == "sndcgan" else (3, 3, feats, 3)
    layers.append((last, {"kernel": _kernel(rng, shape, 9 * feats)}))
    return layers


def _discriminator_layers(rng, family: str, image=IMAGE) -> list:
    """The SNDCGAN discriminator's (7 convs + dense head, SNDCGAN.py:69-128)
    or the WGAN critic's ((conv, bn) x7 + dense head, WGAN.py:53-101)."""
    layers, feats = [], image[2]
    for i, (out, k, _) in enumerate(tsnd.DISC_TRUNK):
        fan = k[0] * k[1] * feats
        layers.append((_name("conv2d", i), {"kernel": _kernel(rng, (*k, feats, out), fan),
                                            "bias": _vec(rng, out)}))
        if family == "wgan":
            layers.append((_name("batch_normalization", i), _bn(rng, out)))
        layers += [(_name("leaky_re_lu", i), {}), (_name("dropout", i), {})]
        feats = out
    th, tw = tsnd.trunk_hw(image[:2])
    layers += [("flatten", {}), ("dense", {"kernel": _kernel(rng, (feats * th * tw, 1), feats),
                                           "bias": _vec(rng, 1)})]
    return layers


def _norm(rng, channels: int, height: int, per_h: bool) -> list:
    n = height if per_h else channels
    return [("gamma:0", rng.uniform(0.5, 1.5, n).astype(np.float32)),
            ("beta:0", _vec(rng, n))]


def _conv(rng, k: int, cin: int, cout: int, transpose: bool = False) -> list:
    shape = (k, k, cout, cin) if transpose else (k, k, cin, cout)
    return [("kernel:0", _kernel(rng, shape, k * k * cin)), ("bias:0", _vec(rng, cout))]


def _cyclegan_generator_groups(rng, per_h: bool, image=CG_IMAGE, base=CG_BASE,
                               n_res=CG_RES) -> list:
    """A save_weights file's layer groups, [(layer, [(weight name, array)])]:
    conv_c7_s1, d_conv x2, n_res ResBlocks, u_conv x2, conv_c7_s1
    (CycleGAN.py:161-183), each a conv and an InstanceNorm; per-H norms
    carry one gamma/beta per row of their input."""
    h = image[0]
    specs = [(7, 3, base, h, False), (3, base, 2 * base, h // 2, False),
             (3, 2 * base, 4 * base, h // 4, False)]
    specs += [(3, 4 * base, 4 * base, h // 4, False)] * (2 * n_res)
    specs += [(3, 4 * base, 2 * base, h // 2, True), (3, 2 * base, base, h, True),
              (7, base, 3, h, False)]
    weights = [_conv(rng, k, cin, cout, t) + _norm(rng, cout, hh, per_h)
               for k, cin, cout, hh, t in specs]
    groups = [(_name("sequential", i), w) for i, w in enumerate(weights[:3])]
    groups += [(_name("res_block", i), weights[3 + 2 * i] + weights[4 + 2 * i])
               for i in range(n_res)]
    groups += [(_name("sequential", 3 + i), w) for i, w in enumerate(weights[3 + 2 * n_res:])]
    return groups


def _cyclegan_discriminator_groups(rng, per_h: bool, image=CG_IMAGE) -> list:
    """k_conv(64, no norm), k_conv(128/256/512) each with an InstanceNorm,
    then the 4x4 s1 head (CycleGAN.py:112-126)."""
    h, feats, groups = image[0], image[2], []
    for i, (out, use_norm) in enumerate(tcyc.DISC_TRUNK):
        h = (h - 4) // 2 + 1
        w = _conv(rng, 4, feats, out) + (_norm(rng, out, h, per_h) if use_norm else [])
        groups.append((_name("sequential", i), w))
        feats = out
    return groups + [("conv2d_4", _conv(rng, 4, feats, 1))]


def _layers(kind: str, seed: int, per_h: bool = False):
    rng = np.random.default_rng(seed)
    family = kind.split("-")[0]
    if kind in ("sndcgan-gen", "wgan-gen"):
        return _generator_layers(rng, family)
    if kind in ("sndcgan-disc", "wgan-critic"):
        return _discriminator_layers(rng, family)
    if kind == "cyclegan-gen":
        return _cyclegan_generator_groups(rng, per_h)
    return _cyclegan_discriminator_groups(rng, per_h)


def _strings(names) -> np.ndarray:
    return np.array([n.encode() for n in names], dtype="S")


def write_model_h5(path, layers: list, layout: str) -> None:
    """A full-model .h5 as Keras writes it: "keras2_model"
    (`model_weights/<l>/<l>/<w>:0`), "keras3_model"
    (`model_weights/<l>/sequential/<l>/<w>`), "save_weights" (the Keras-2
    layout at the root). "sorted_keys" and "keras_keys" have no
    `layer_names`: the readers take h5py's key order, which follows the
    names "l00_<l>", ... in model order, and scrambles Keras's own."""
    keras3 = layout == "keras3_model"
    if layout == "sorted_keys":
        layers = [(f"l{i:02d}_{n}", t) for i, (n, t) in enumerate(layers)]
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights") if layout.endswith("_model") else f
        if layout.endswith("_model"):  # a listed layer without a group is skipped
            root.attrs["layer_names"] = _strings(["input_1"] + [n for n, _ in layers])
            root.create_group("top_level_model_weights").attrs["weight_names"] = _strings([])
        elif layout == "save_weights":
            root.attrs["layer_names"] = _strings([n for n, _ in layers])
        for name, tensors in layers:
            g = root.create_group(name)
            inner = g.create_group("sequential").create_group(name) if keras3 else (
                g.create_group(name))
            wnames = []
            for base, a in tensors.items():
                key = base if keras3 else f"{base}:0"
                inner.create_dataset(key, data=a)
                wnames.append(f"sequential/{name}/{key}" if keras3 else f"{name}/{key}")
            g.attrs["weight_names"] = _strings(wnames)


def write_weights_h5(path, groups: list, layout: str) -> None:
    """A Keras-2 save_weights .h5 of nested layers: `layer_names` on the
    root ("save_weights") or on `model_weights` ("model_weights"), each
    group's `weight_names` (e.g. "conv2d_3/kernel:0") naming datasets under
    it; or the Keras-3 `.weights.h5` layout ("keras3_weights":
    `layers/<l>/vars/<i>`, no names)."""
    with h5py.File(path, "w") as f:
        if layout == "keras3_weights":
            for lname, weights in groups:
                g = f.create_group(f"layers/{lname}/vars")
                for i, (_, a) in enumerate(weights):
                    g.create_dataset(str(i), data=a)
            f.create_group("vars")
            return
        root = f.create_group("model_weights") if layout == "model_weights" else f
        root.attrs["layer_names"] = _strings([n for n, _ in groups])
        for li, (lname, weights) in enumerate(groups):
            g = root.create_group(lname)
            wnames = []
            for wi, (wname, a) in enumerate(weights):
                rel = f"var_{li}_{wi // 2}/{wname}"  # unique relative paths
                g.create_dataset(rel, data=a)
                wnames.append(rel)
            g.attrs["weight_names"] = _strings(wnames)


def write_h5(path, kind: str, layout: str, seed: int = 0, per_h: bool = False) -> Path:
    layers = _layers(kind, seed, per_h)
    (write_model_h5 if kind in SEQUENTIAL else write_weights_h5)(path, layers, layout)
    return Path(path)


# ---------------------------------------------------------------- helpers
def assert_same_tree(got, want, at: str = "") -> None:
    """Keys in order, then per leaf type, shape, dtype, memory order, bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict), at
        assert list(got) == list(want), at
        for k in want:
            assert_same_tree(got[k], want[k], f"{at}/{k}")
        return
    assert type(got) is type(want) is np.ndarray, at
    assert got.shape == want.shape and got.dtype == want.dtype, at
    assert got.flags.c_contiguous == want.flags.c_contiguous, at
    assert got.tobytes() == want.tobytes(), at


def flat(tree, at: str = "") -> dict:
    """{"/collection/layer/.../leaf": array}."""
    if not isinstance(tree, dict):
        return {at: tree}
    return {p: a for k, v in tree.items() for p, a in flat(v, f"{at}/{k}").items()}


def assert_same_leaves(got, want) -> None:
    """assert_same_tree on every leaf, whatever the order of the keys (an
    export is read back with its keys sorted)."""
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for path, a in want.items():
        assert_same_tree(got[path], a, path)


def outcome(fn, *args):
    """("tree", tree) or ("error", (exception type, message))."""
    try:
        return "tree", fn(*args)
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        return "error", (type(e), str(e))


def assert_same_outcome(got, want) -> None:
    assert got[0] == want[0], (got, want)
    if want[0] == "tree":
        assert_same_tree(got[1], want[1])
    else:
        assert got[1] == want[1]


def _model(kind: str, per_h: bool = False):
    if kind in ("sndcgan-gen", "sndcgan-disc"):
        cfg = tsnd.SNDCGANConfig(image_size=IMAGE, base_width=BASE)
        return tsnd.Generator(cfg) if kind == "sndcgan-gen" else tsnd.Discriminator(cfg)
    if kind in ("wgan-gen", "wgan-critic"):
        cfg = twgan.WGANConfig(image_size=IMAGE, base_width=BASE)
        return twgan.Generator(cfg) if kind == "wgan-gen" else twgan.Critic(cfg)
    cfg = tcyc.CycleGANConfig(image_size=CG_IMAGE, base_width=CG_BASE, n_res_blocks=CG_RES,
                              quirk_axis1=per_h)
    return tcyc.Generator(cfg) if kind == "cyclegan-gen" else tcyc.Discriminator(cfg)


# ---------------------------------------------------------------- trees
TREE_CASES = (
    [(k, layout, False) for k in SEQUENTIAL for layout in MODEL_LAYOUTS]
    + [(k, layout, per_h) for k in CYCLEGAN for layout in WEIGHTS_LAYOUTS
       for per_h in (False, True)]
)


@pytest.mark.parametrize("kind,layout,per_h", TREE_CASES,
                         ids=[f"{k}-{lo}-{'per_h' if h else 'per_c'}" for k, lo, h in TREE_CASES])
def test_tree_equals_the_jax_importers(tmp_path, kind, layout, per_h):
    path = write_h5(tmp_path / "w.h5", kind, layout, per_h=per_h)
    want = outcome(jki.IMPORTERS[kind], path)
    got = outcome(tki.IMPORTERS[kind], path)
    assert_same_outcome(got, want)
    # Keras's names in h5py's order may scramble the layers (an error in
    # both); every other layout gives a tree
    assert want[0] == "tree" or layout == "keras_keys", want
    if kind in SEQUENTIAL and want[0] == "tree":
        got_layers, want_layers = tki.read_h5_layers(path), jki.read_h5_layers(path)
        assert [n for n, _ in got_layers] == [n for n, _ in want_layers]
        for (_, g), (_, w) in zip(got_layers, want_layers):
            assert_same_tree(g, w)


@pytest.mark.parametrize("shape", [(4, 4, 7, 5), (3, 3, 3, 64), (2, 5, 1, 1)])
def test_convt_kernel_to_flax_equals_the_jax_function(shape):
    k = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    got, want = tki.convt_kernel_to_flax(k), jki.convt_kernel_to_flax(k)
    assert_same_tree(got, want)
    assert got.shape == (shape[0], shape[1], shape[3], shape[2])
    np.testing.assert_array_equal(got[0, 0], k[-1, -1].T)


# ---------------------------------------------------------------- CLI
@pytest.mark.parametrize("kind", SEQUENTIAL + CYCLEGAN)
def test_cli_file_equals_the_jax_clis(tmp_path, capsys, kind):
    layout = "keras2_model" if kind in SEQUENTIAL else "save_weights"
    path = write_h5(tmp_path / "w.h5", kind, layout, seed=7, per_h=kind == "cyclegan-disc")
    jki.main([str(path), str(tmp_path / "jax.msgpack"), "--kind", kind])
    jax_line = capsys.readouterr().out.replace("jax.msgpack", "out.msgpack")
    tki.main([str(path), str(tmp_path / "out.msgpack"), "--kind", kind])
    assert capsys.readouterr().out == jax_line
    data = (tmp_path / "out.msgpack").read_bytes()
    assert data == (tmp_path / "jax.msgpack").read_bytes()
    assert_same_leaves(tckpt.load_params(tmp_path / "out.msgpack"), jki.IMPORTERS[kind](path))


# ---------------------------------------------------------------- errors
COUNT_CASES = [(k, d) for k in SEQUENTIAL for d in ("drop", "extra")] + [
    ("cyclegan-gen", "drop"), ("cyclegan-gen", "short"), ("cyclegan-disc", "drop")]


@pytest.mark.parametrize("kind,change", COUNT_CASES, ids=[f"{k}-{c}" for k, c in COUNT_CASES])
def test_wrong_counts_raise_the_jax_value_error(tmp_path, kind, change):
    layers = _layers(kind, 3)
    if kind in SEQUENTIAL:
        weighted = [i for i, (_, t) in enumerate(layers) if t]
        if change == "drop":
            del layers[weighted[2]]
        else:
            layers.insert(1, ("dense_extra", dict(layers[weighted[0]][1])))
        write_model_h5(tmp_path / "w.h5", layers, "keras2_model")
    else:
        if change == "drop":  # one weight fewer
            layers[-1] = (layers[-1][0], layers[-1][1][:-1])
        else:  # a multiple of 4 under the 24 weights of the fixed layers
            layers = layers[:4]
        write_weights_h5(tmp_path / "w.h5", layers, "save_weights")
    want = outcome(jki.IMPORTERS[kind], tmp_path / "w.h5")
    assert want[0] == "error" and want[1][0] is ValueError, want
    assert_same_outcome(outcome(tki.IMPORTERS[kind], tmp_path / "w.h5"), want)


@pytest.mark.parametrize("kind", CYCLEGAN)
def test_keras3_weights_file_raises_the_jax_value_error(tmp_path, kind):
    path = write_h5(tmp_path / "g.weights.h5", kind, "keras3_weights")
    want = outcome(jki.IMPORTERS[kind], path)
    assert want[0] == "error" and want[1][0] is ValueError
    assert "Keras-3 .weights.h5" in want[1][1]
    assert_same_outcome(outcome(tki.IMPORTERS[kind], path), want)


@pytest.mark.parametrize("kind", ["sndcgan-gen", "cyclegan-gen"])
def test_without_h5py_the_readers_raise_an_import_error_naming_it(tmp_path, monkeypatch, kind):
    path = write_h5(tmp_path / "w.h5", kind, "keras2_model" if kind in SEQUENTIAL
                    else "save_weights")
    monkeypatch.setitem(sys.modules, "h5py", None)  # `import h5py` raises
    with pytest.raises(ImportError, match="needs h5py"):
        tki.IMPORTERS[kind](path)


# ---------------------------------------------------------------- models
LOAD_CASES = [(k, False) for k in SEQUENTIAL + CYCLEGAN] + [(k, True) for k in CYCLEGAN]


@pytest.mark.parametrize("kind,per_h", LOAD_CASES,
                         ids=[f"{k}-{'per_h' if h else 'per_c'}" for k, h in LOAD_CASES])
def test_imported_tree_loads_into_the_ports_model_bit_for_bit(tmp_path, kind, per_h):
    layout = "keras2_model" if kind in SEQUENTIAL else "save_weights"
    tree = tki.IMPORTERS[kind](write_h5(tmp_path / "w.h5", kind, layout, 5, per_h))
    model = _model(kind, per_h)
    bridge.load_flax_variables(model, tree)
    back = bridge.flax_variables(model)
    assert_same_leaves(back, {c: t for c, t in tree.items() if t})  # sndcgan-disc: {} spectral
    if kind == "sndcgan-gen":
        assert bridge.sndcgan_base_width(tree) == BASE
    if kind in CYCLEGAN:  # a per-H tree never fits a per-channel model, nor the reverse
        with pytest.raises(ValueError, match="does not fit"):
            bridge.load_flax_variables(_model(kind, not per_h), tree)


# ---------------------------------------------------------------- Keras
def _keras_cyclegan_generator(tf, keras2, axis: int):
    """The reference CycleGAN generator (cyclegan/CycleGAN.py:60-92,
    161-183) in tf_keras, as tests/test_keras_import.py builds it, with
    GroupNormalization(groups=-1, axis) as the InstanceNorm: axis -1 is the
    per-channel norm, axis 1 tfa's InstanceNormalization(axis=1) (per-H
    parameters, each row normalized over (W, C))."""

    def norm():
        return keras2.layers.GroupNormalization(groups=-1, axis=axis, epsilon=1e-3)

    def conv_c7_s1(filters, use_tanh=False):
        return keras2.Sequential([
            keras2.layers.Conv2D(filters, (7, 7), padding="same"), norm(),
            keras2.layers.Activation("tanh") if use_tanh else keras2.layers.ReLU()])

    def d_conv(filters):
        return keras2.Sequential([
            keras2.layers.Lambda(
                lambda x: tf.pad(x, [[0, 0], [1, 1], [1, 1], [0, 0]], "REFLECT")),
            keras2.layers.Conv2D(filters, (3, 3), strides=(2, 2)), norm(),
            keras2.layers.ReLU()])

    def u_conv(filters):
        return keras2.Sequential([
            keras2.layers.Conv2DTranspose(filters, (3, 3), strides=(2, 2), padding="same"),
            norm(), keras2.layers.ReLU()])

    class ResBlock(keras2.layers.Layer):
        def __init__(self, filters):
            super().__init__()
            self.conv1 = keras2.layers.Conv2D(filters, (3, 3), padding="same")
            self.instance1 = norm()
            self.relu = keras2.layers.ReLU()
            self.conv2 = keras2.layers.Conv2D(filters, (3, 3), padding="same")
            self.instance2 = norm()

        def call(self, x):
            fx = self.relu(self.instance1(self.conv1(x)))
            return self.instance2(self.relu(x + self.conv2(fx)))

    return keras2.Sequential([
        keras2.layers.InputLayer(CG_IMAGE), conv_c7_s1(CG_BASE),
        d_conv(CG_BASE * 2), d_conv(CG_BASE * 4),
        *[ResBlock(CG_BASE * 4) for _ in range(CG_RES)],
        u_conv(CG_BASE * 2), u_conv(CG_BASE), conv_c7_s1(3, use_tanh=True)])


def _through_the_cli(tmp_path, h5, kind: str) -> dict:
    """The port's CLI export of `h5`, read back; its tree equals the JAX
    importer's on this real Keras file."""
    tki.main([str(h5), str(tmp_path / "out.msgpack"), "--kind", kind])
    assert_same_tree(tki.IMPORTERS[kind](h5), jki.IMPORTERS[kind](h5))
    return tckpt.load_params(tmp_path / "out.msgpack")


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@torch.no_grad()
def test_sndcgan_generator_matches_keras(tmp_path):
    tf = pytest.importorskip("tensorflow")
    from test_keras_import import H, W, _keras_generator

    km = _keras_generator()
    for layer in km.layers:  # BN statistics away from their init, as the JAX test sets them
        if isinstance(layer, tf.keras.layers.BatchNormalization):
            layer.moving_mean.assign(
                np.random.default_rng(1).normal(0, 0.1, layer.moving_mean.shape))
            layer.moving_variance.assign(
                np.random.default_rng(2).uniform(0.5, 1.5, layer.moving_variance.shape))
    h5 = tmp_path / "gen_model-0.h5"
    km.save(h5, include_optimizer=False, save_format="h5")
    tree = _through_the_cli(tmp_path, h5, "sndcgan-gen")
    gen = tsnd.Generator(tsnd.SNDCGANConfig(image_size=(H, W, 3),
                                            base_width=bridge.sndcgan_base_width(tree)))
    bridge.load_flax_variables(gen, tree)
    z = np.random.default_rng(3).uniform(-1, 1, (2, 128)).astype(np.float32)
    want = km(z, training=False).numpy()
    got = _nhwc(gen(torch.from_numpy(z), train=False))
    assert got.shape == want.shape == (2, H, W, 3)
    np.testing.assert_allclose(got, want, atol=2e-4)


@torch.no_grad()
def test_wgan_generator_matches_keras(tmp_path):
    pytest.importorskip("tensorflow")
    from test_keras_import import H, W, _keras_wgan_generator

    km = _keras_wgan_generator()
    h5 = tmp_path / "model_0001.h5"
    km.save(h5, include_optimizer=False, save_format="h5")
    tree = _through_the_cli(tmp_path, h5, "wgan-gen")
    gen = twgan.Generator(twgan.WGANConfig(image_size=(H, W, 3)))
    bridge.load_flax_variables(gen, tree)
    z = np.random.default_rng(5).normal(size=(2, 128)).astype(np.float32)
    want = km(z, training=False).numpy()
    got = _nhwc(gen(torch.from_numpy(z), train=False))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4)


@torch.no_grad()
def test_sndcgan_discriminator_matches_keras(tmp_path):
    pytest.importorskip("tensorflow")
    from test_keras_import import H, W, _keras_discriminator

    km = _keras_discriminator()
    h5 = tmp_path / "disc_model-0.h5"
    km.save(h5, include_optimizer=False, save_format="h5")
    tree = _through_the_cli(tmp_path, h5, "sndcgan-disc")
    assert tree["spectral"] == {}
    disc = tsnd.Discriminator(tsnd.SNDCGANConfig(image_size=(H, W, 3), dropout_rate=0.0))
    bridge.load_flax_variables(disc, tree)
    x = np.random.default_rng(4).uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    want = km(x, training=False).numpy()
    got = disc(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.fixture
def keras2():
    """tf_keras, its session cleared after the test: the default layer
    names it counts ("conv2d_1", ...) would otherwise run on into the next
    test of the process, and tests/test_inception.py loads by those names."""
    pytest.importorskip("tensorflow")
    keras2 = pytest.importorskip("tf_keras")
    yield keras2
    keras2.backend.clear_session()


@pytest.mark.parametrize("axis", [-1, 1], ids=["per_channel", "per_h"])
@torch.no_grad()
def test_cyclegan_generator_matches_keras(tmp_path, axis, keras2):
    tf = pytest.importorskip("tensorflow")
    tf.config.set_visible_devices([], "GPU")
    km = _keras_cyclegan_generator(tf, keras2, axis)
    rng = np.random.default_rng(6)
    for w in km.weights:  # norms and biases away from their 1 / 0 init
        name = w.name.split("/")[-1]
        if name.startswith(("gamma", "beta", "bias")):
            base = 1.0 if name.startswith("gamma") else 0.0
            w.assign(base + rng.normal(0, 0.05, w.shape).astype(np.float32))
    x = rng.uniform(-1, 1, (2, *CG_IMAGE)).astype(np.float32)
    want = km(x, training=False).numpy()
    h5 = tmp_path / "gen_weights_g-0.h5"
    km.save_weights(h5, save_format="h5")
    tree = _through_the_cli(tmp_path, h5, "cyclegan-gen")
    per_h = axis == 1
    assert tree["params"]["stem_in"]["scale"].shape == ((CG_IMAGE[0], 1, 1) if per_h
                                                        else (CG_BASE,))
    gen = _model("cyclegan-gen", per_h)
    bridge.load_flax_variables(gen, tree)
    got = _nhwc(gen(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-4)


# ---------------------------------------------------------------- end to end
def test_imported_reference_width_generator_samples_as_jax(tmp_path):
    """A base-512 generator .h5 -> the port's CLI -> models/generator/
    gen_model-0.msgpack -> the port's sampling CLI on the CPU, against the
    JAX generator on the JAX importer's tree and the same z."""
    import jax.numpy as jnp

    from imagegeneration_tpu.cli import generator_output as jout
    from imagegeneration_tpu.models import sndcgan as jmodels
    from imagegeneration_tpu_torch.cli import generator_output as tout

    batch, base = 3, 512
    h5 = tmp_path / "gen_model-95.h5"
    write_model_h5(h5, _generator_layers(np.random.default_rng(9), "sndcgan", IMAGE, base),
                   "keras2_model")
    export = tmp_path / "run" / "models" / "generator" / "gen_model-0.msgpack"
    tki.main([str(h5), str(export), "--kind", "sndcgan-gen"])
    assert bridge.sndcgan_base_width(tckpt.load_params(export)) == base
    epochs, samples = tout.output_results_models(
        batch, str(tmp_path / "run"), 1, "grid", 0, IMAGE, device="cpu", return_samples=True)
    assert epochs == [0]
    z = tout._fixed_z(batch, 128, 62)
    jgen = jmodels.Generator(jmodels.SNDCGANConfig(image_size=IMAGE))
    want = jout.create_samples(jgen, jki.import_sndcgan_generator(h5), jnp.asarray(z),
                               batch, IMAGE)
    got = samples[0]
    assert got.shape == want.shape == (batch, *IMAGE) and got.dtype == np.float32
    assert 0.0 <= got.min() and got.max() <= 1.0 and got.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_a_fresh_interpreter_imports_and_converts_without_jax(tmp_path):
    h5 = write_h5(tmp_path / "disc_model-0.h5", "sndcgan-disc", "keras3_model")
    code = (
        "import sys\n"
        "bad = lambda: sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'imagegeneration_tpu'))\n"
        "from imagegeneration_tpu_torch.compat import keras_import\n"
        "assert not bad(), bad()\n"
        "assert 'h5py' not in sys.modules\n"
        "keras_import.main(sys.argv[1:])\n"
        "assert not bad(), bad()\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code, str(h5), str(tmp_path / "d.msgpack"), "--kind",
         "sndcgan-disc"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"imported sndcgan-disc weights -> {tmp_path / 'd.msgpack'}"
    assert_same_leaves(tckpt.load_params(tmp_path / "d.msgpack"),
                       jki.import_sndcgan_discriminator(h5))
