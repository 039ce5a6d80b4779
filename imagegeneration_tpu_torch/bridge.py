"""JAX (flax) variables <-> the port's modules and train state.

Takes and returns nested dicts of numpy arrays, so it needs no jax: a test
or an import script pulls the JAX side to numpy (`jax.device_get`) first.
Collections covered: flax `params`, `batch_stats` (BN mean/var), `spectral`
(SN `u`), Adam `mu`/`nu`/`count` (optax.ScaleByAdamState) and RMSprop `nu`
(optax.ScaleByRmsState), whose trees have the params' structure.

Layout rules, per kind of leaf:

- conv kernel: flax HWIO (kh, kw, in, out) <-> torch OIHW;
- dense kernel: flax (in, out) <-> torch (out, in). The generator stem's
  outputs and the discriminator head's inputs are in NHWC order on both
  sides (the port reshapes/flattens channels_last tensors), so no further
  permutation is needed;
- flax ConvTranspose kernel (kh, kw, in, out), unflipped
  (`transpose_kernel=False`) <-> torch ConvTranspose2d (in, out, kh, kw):
  spatial flip;
- the SNDCGAN generator's `to_rgb` is a 3x3 stride-1 ConvTranspose in the
  JAX model, lowered to a plain conv there and stored as `to_rgb/
  ConvTranspose_0/kernel` (HWIO): it bridges as a conv, with no flip. The
  CycleGAN `to_rgb` is a plain `Conv` (`to_rgb/Conv_0`);
- the WGAN generator's `to_rgb` is a plain `Conv` (`to_rgb/Conv_0`), as
  its class is not the SNDCGAN `Generator` that the override names;
- the CycleGAN up-sampling ConvTransposes (3x3 s2) are stored unflipped as
  `upN/ConvTranspose_0/kernel` (kh, kw, in, out) and bridge as convT;
- an InstanceNorm's `scale` and `bias` sit at `N/scale`, `N/bias` (no inner
  module), with the flax shape on both sides ((C,), or (H, 1, 1) for the
  quirk_axis1 form);
- the evaluation trunks (evalx/pd.VGG16Features,
  evalx/inception.InceptionV3Features) name their layers as flax does,
  with no inner module: `block1_conv1/{kernel,bias}`; `conv2d_7/kernel` and
  `batch_normalization_7/bias` (params) with `batch_normalization_7/
  {mean,var}` (batch_stats).

flax path of a layer named N: `N/<inner>/...` for the JAX package's
wrapper modules (`Dense_0`, `Conv_0`, `ConvTranspose_0`, `BatchNorm_0`),
`N/...` for the spectral-norm modules and InstanceNorm; a ResBlock's layers
nest under its name (`res3/conv1/Conv_0/kernel`, `res3/in1/scale`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np
import torch
from torch import nn

from imagegeneration_tpu_torch.models import cyclegan, sndcgan, wgan
from imagegeneration_tpu_torch.models.sndcgan import Generator
from imagegeneration_tpu_torch.nn.layers import (
    BatchNorm,
    Conv,
    ConvTranspose,
    Dense,
    InstanceNorm,
    ResBlock,
)
from imagegeneration_tpu_torch.nn.spectral_norm import (
    SpectralNormConv,
    SpectralNormDense,
)

_INNER = {
    Dense: "Dense_0", Conv: "Conv_0", ConvTranspose: "ConvTranspose_0",
    BatchNorm: "BatchNorm_0", SpectralNormConv: None, SpectralNormDense: None,
    InstanceNorm: None,
}
# (model class, layer name) -> inner flax name, where the default is wrong.
_INNER_OVERRIDES = {(Generator, "to_rgb"): "ConvTranspose_0"}
_WEIGHT_KIND = {
    Dense: "dense", SpectralNormDense: "dense", Conv: "conv",
    SpectralNormConv: "conv", ConvTranspose: "convT",
}


@dataclasses.dataclass(frozen=True)
class Leaf:
    torch_name: str  # e.g. "up0.weight"
    collection: str  # "params" | "batch_stats" | "spectral"
    path: tuple[str, ...]  # flax path inside the collection
    kind: str  # "dense" | "conv" | "convT" | "vec"


def leaves(model: nn.Module, names: tuple[str, ...] = ()) -> list[Leaf]:
    """The model's leaves; `names` prefixes both paths (for nested blocks)."""
    out = []
    for name, layer in model.named_children():
        tname = ".".join((*names, name))
        if isinstance(layer, ResBlock):
            out += leaves(layer, (*names, name))
            continue
        inner = _INNER_OVERRIDES.get((type(model), name), _INNER[type(layer)])
        prefix = (*names, name) if inner is None else (*names, name, inner)
        if isinstance(layer, (BatchNorm, InstanceNorm)):
            out += [
                Leaf(f"{tname}.scale", "params", prefix + ("scale",), "vec"),
                Leaf(f"{tname}.bias", "params", prefix + ("bias",), "vec"),
            ]
            if isinstance(layer, BatchNorm):
                out += [
                    Leaf(f"{tname}.mean", "batch_stats", prefix + ("mean",), "vec"),
                    Leaf(f"{tname}.var", "batch_stats", prefix + ("var",), "vec"),
                ]
            continue
        out.append(Leaf(f"{tname}.weight", "params", prefix + ("kernel",),
                        _WEIGHT_KIND[type(layer)]))
        if layer.bias is not None:
            out.append(Leaf(f"{tname}.bias", "params", prefix + ("bias",), "vec"))
        if isinstance(layer, (SpectralNormConv, SpectralNormDense)):
            out.append(Leaf(f"{tname}.u", "spectral", prefix + ("u",), "vec"))
    return out


def to_torch_layout(kind: str, a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    if kind == "dense":
        a = a.T
    elif kind == "conv":
        a = a.transpose(3, 2, 0, 1)
    elif kind == "convT":
        a = a[::-1, ::-1].transpose(2, 3, 0, 1)
    return np.array(a, order="C")  # a writable copy


def to_flax_layout(kind: str, a: np.ndarray) -> np.ndarray:
    if kind == "dense":
        a = a.T
    elif kind == "conv":
        a = a.transpose(2, 3, 1, 0)
    elif kind == "convT":
        a = a.transpose(2, 3, 0, 1)[::-1, ::-1]
    # Always a copy: the numpy view of a CPU tensor shares its memory, and
    # the state is updated in place by the next step.
    return np.array(a, order="C")


def _get(tree: dict, path: tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: dict, path: tuple[str, ...], value: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _tensors(model: nn.Module) -> dict[str, torch.Tensor]:
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


def _param_leaves(model: nn.Module) -> Iterator[Leaf]:
    by_name = {leaf.torch_name: leaf for leaf in leaves(model)}
    for name, _ in model.named_parameters():
        yield by_name[name]


@torch.no_grad()
def copy_in(dst: torch.Tensor, kind: str, a: np.ndarray) -> None:
    src = torch.from_numpy(to_torch_layout(kind, a))
    if src.shape != dst.shape:
        raise ValueError(f"shape {tuple(src.shape)} does not fit {tuple(dst.shape)}")
    dst.copy_(src)


def _to_numpy(t: torch.Tensor, kind: str) -> np.ndarray:
    return to_flax_layout(kind, t.detach().cpu().numpy())


def load_flax_variables(model: nn.Module, variables: dict[str, dict]) -> None:
    """Copy flax variables ({"params": ..., "batch_stats"/"spectral": ...})
    into the model's parameters and buffers, in place."""
    tensors = _tensors(model)
    for leaf in leaves(model):
        copy_in(tensors[leaf.torch_name], leaf.kind,
                 _get(variables[leaf.collection], leaf.path))


def flax_variables(model: nn.Module) -> dict[str, dict]:
    """The model's state as flax variables (numpy leaves)."""
    tensors = _tensors(model)
    out: dict[str, dict] = {}
    for leaf in leaves(model):
        _set(out.setdefault(leaf.collection, {}), leaf.path,
             _to_numpy(tensors[leaf.torch_name], leaf.kind))
    return out


# The collections of a model's params-only export, as the JAX engines write
# them (train/sndcgan_engine.py:201-227, wgan_engine.py:200-207,
# cyclegan_engine.py:308-322). A collection the model lacks (`spectral`
# without spectral norm) is exported empty, as the JAX state holds it.
EXPORT_COLLECTIONS = {
    sndcgan.Generator: ("params", "batch_stats"),
    sndcgan.Discriminator: ("params", "spectral"),
    wgan.Generator: ("params", "batch_stats"),
    wgan.Critic: ("params", "batch_stats"),
    cyclegan.Generator: ("params",),
}


def sndcgan_base_width(variables: dict) -> int:
    """The base width of an SNDCGAN generator's flax variables (an export
    holds no config): its first ConvTranspose maps base -> base / 2."""
    return int(variables["params"]["up0"]["ConvTranspose_0"]["kernel"].shape[2])


def export_variables(model: nn.Module) -> dict[str, dict]:
    """The model's params-only export tree (core/checkpoint.export_params)."""
    variables = flax_variables(model)
    return {c: variables.get(c, {}) for c in EXPORT_COLLECTIONS[type(model)]}


def load_param_tree(model: nn.Module, tree: dict, dst: list[torch.Tensor]) -> None:
    """Copy a params-shaped flax tree (e.g. Adam mu) into `dst`, a list in
    `model.parameters()` order."""
    for leaf, t in zip(_param_leaves(model), dst, strict=True):
        copy_in(t, leaf.kind, _get(tree, leaf.path))


def param_tree(model: nn.Module, tensors: list[torch.Tensor]) -> dict:
    """Inverse of `load_param_tree`."""
    out: dict = {}
    for leaf, t in zip(_param_leaves(model), tensors, strict=True):
        _set(out, leaf.path, _to_numpy(t, leaf.kind))
    return out


def load_jax_train_state(state, jax_state: dict) -> None:
    """Copy a JAX SNDCGANState (as a dict of numpy trees: step, g_params,
    g_batch_stats, g_opt {count, mu, nu}, d_params, d_spectral, d_opt) into
    a port SNDCGANState, in place."""
    with torch.no_grad():
        state.step.fill_(int(jax_state["step"]))
    load_flax_variables(state.gen, {"params": jax_state["g_params"],
                                    "batch_stats": jax_state["g_batch_stats"]})
    load_flax_variables(state.disc, {"params": jax_state["d_params"],
                                     "spectral": jax_state["d_spectral"]})
    for model, opt, key in ((state.gen, state.g_opt, "g_opt"),
                            (state.disc, state.d_opt, "d_opt")):
        with torch.no_grad():
            opt.count.fill_(int(jax_state[key]["count"]))
        load_param_tree(model, jax_state[key]["mu"], opt.mu)
        load_param_tree(model, jax_state[key]["nu"], opt.nu)


def jax_train_state(state) -> dict:
    """Inverse of `load_jax_train_state` (numpy leaves)."""
    g = flax_variables(state.gen)
    d = flax_variables(state.disc)
    return {
        "step": np.asarray(int(state.step)),
        "g_params": g["params"],
        "g_batch_stats": g.get("batch_stats", {}),
        "g_opt": {"count": np.asarray(int(state.g_opt.count)),
                  "mu": param_tree(state.gen, state.g_opt.mu),
                  "nu": param_tree(state.gen, state.g_opt.nu)},
        "d_params": d["params"],
        "d_spectral": d.get("spectral", {}),
        "d_opt": {"count": np.asarray(int(state.d_opt.count)),
                  "mu": param_tree(state.disc, state.d_opt.mu),
                  "nu": param_tree(state.disc, state.d_opt.nu)},
    }


def load_jax_wgan_state(state, jax_state: dict) -> None:
    """Copy a JAX WGANState (as a dict of numpy trees: step, critic_count,
    g_params, g_batch_stats, c_params, c_batch_stats, c_opt {nu} and gan_opt
    {nu: (g tree, c tree)}, the gan optimizer's state over every generator
    and critic leaf) into a port WGANState, in place."""
    with torch.no_grad():
        state.step.fill_(int(jax_state["step"]))
    state.critic_count = int(jax_state["critic_count"])
    load_flax_variables(state.gen, {"params": jax_state["g_params"],
                                    "batch_stats": jax_state["g_batch_stats"]})
    load_flax_variables(state.critic, {"params": jax_state["c_params"],
                                       "batch_stats": jax_state["c_batch_stats"]})
    load_param_tree(state.critic, jax_state["c_opt"]["nu"], state.c_opt.nu)
    g_nu, c_nu = jax_state["gan_opt"]["nu"]
    n_g = len(list(state.gen.parameters()))
    load_param_tree(state.gen, g_nu, state.gan_opt.nu[:n_g])
    load_param_tree(state.critic, c_nu, state.gan_opt.nu[n_g:])


def jax_wgan_state(state) -> dict:
    """Inverse of `load_jax_wgan_state` (numpy leaves)."""
    g = flax_variables(state.gen)
    c = flax_variables(state.critic)
    n_g = len(list(state.gen.parameters()))
    return {
        "step": np.asarray(int(state.step)),
        "critic_count": np.asarray(state.critic_count),
        "g_params": g["params"],
        "g_batch_stats": g["batch_stats"],
        "c_params": c["params"],
        "c_batch_stats": c["batch_stats"],
        "c_opt": {"nu": param_tree(state.critic, state.c_opt.nu)},
        "gan_opt": {"nu": (param_tree(state.gen, state.gan_opt.nu[:n_g]),
                           param_tree(state.critic, state.gan_opt.nu[n_g:]))},
    }


def load_jax_vgg16(model: nn.Module, variables: dict[str, dict]) -> None:
    """Copy the JAX VGG16Features variables ({"params": {block1_conv1:
    {kernel, bias}, ...}}) into an evalx/pd.VGG16Features, in place."""
    params = variables["params"]
    for name, conv in model.named_children():
        copy_in(conv.weight, "conv", params[name]["kernel"])
        copy_in(conv.bias, "vec", params[name]["bias"])


def load_jax_inception(model: nn.Module, variables: dict[str, dict]) -> None:
    """Copy the JAX InceptionV3Features variables (params: conv2d*/kernel,
    batch_normalization*/bias; batch_stats: batch_normalization*/{mean,
    var}) into an evalx/inception.InceptionV3Features, in place."""
    params, stats = variables["params"], variables["batch_stats"]
    for name, layer in model.named_children():
        if name.startswith("conv2d"):
            copy_in(layer.weight, "conv", params[name]["kernel"])
        else:
            copy_in(layer.bias, "vec", params[name]["bias"])
            copy_in(layer.mean, "vec", stats[name]["mean"])
            copy_in(layer.var, "vec", stats[name]["var"])


_CYCLEGAN_MODELS = (("gen_g", "gg"), ("gen_f", "gf"), ("disc_x", "dx"), ("disc_y", "dy"))


def load_jax_cyclegan_state(state, jax_state: dict) -> None:
    """Copy a JAX CycleGANState (as a dict of numpy trees: step, gg_params,
    gf_params, dx_params, dy_params and gg_opt ... dy_opt {count, mu, nu})
    into a port CycleGANState, in place."""
    with torch.no_grad():
        state.step.fill_(int(jax_state["step"]))
    for attr, key in _CYCLEGAN_MODELS:
        model, opt = getattr(state, attr), getattr(state, f"{key}_opt")
        load_flax_variables(model, {"params": jax_state[f"{key}_params"]})
        with torch.no_grad():
            opt.count.fill_(int(jax_state[f"{key}_opt"]["count"]))
        load_param_tree(model, jax_state[f"{key}_opt"]["mu"], opt.mu)
        load_param_tree(model, jax_state[f"{key}_opt"]["nu"], opt.nu)


def jax_cyclegan_state(state) -> dict:
    """Inverse of `load_jax_cyclegan_state` (numpy leaves)."""
    out = {"step": np.asarray(int(state.step))}
    for attr, key in _CYCLEGAN_MODELS:
        model, opt = getattr(state, attr), getattr(state, f"{key}_opt")
        out[f"{key}_params"] = flax_variables(model)["params"]
        out[f"{key}_opt"] = {"count": np.asarray(int(opt.count)),
                             "mu": param_tree(model, opt.mu),
                             "nu": param_tree(model, opt.nu)}
    return out
