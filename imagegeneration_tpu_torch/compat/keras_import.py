"""Import trained reference Keras .h5 weights into the port's exports.

The counterpart of imagegeneration_tpu/compat/keras_import.py, with the
same names, trees and errors. A user of the reference has trained artifacts
saved as Keras .h5 models (sndcgan/SNDCGAN.py:327-331,
wasserstein_gan/WGAN.py:263-266) or weight files (cyclegan/CycleGAN.py:
414-420). Each importer returns the JAX importer's tree: flax-layout numpy
arrays in nested dicts, which is the params-only export format
(`core/checkpoint.export_params`) and what `bridge.load_flax_variables`
copies into a model.

    python -m imagegeneration_tpu_torch.compat.keras_import gen_model-95.h5 \\
        out.msgpack --kind sndcgan-gen

Reading and mapping are split. Only the readers (`read_h5_layers`,
`_read_save_weights_h5`) need h5py, imported inside them; the mapping
functions (`sndcgan_generator_tree(layers)`, ...) are numpy over what the
readers return, so everything after the read (export, load, bridge,
sampling) also runs where h5py is not installed. `import_<kind>(h5_path)`
is the mapping over the read.

Layouts, as the reference's files hold them:
- Dense / Conv2D kernels carry over unchanged ((in, out) and (kh, kw, in,
  out) on both sides);
- Conv2DTranspose: Keras stores (kh, kw, out, in) and computes the
  gradient of a conv; the flax kernel is rot180 of it with the channel
  axes swapped (`convt_kernel_to_flax`), and `bridge.to_torch_layout` maps
  that onto torch's ConvTranspose2d;
- BatchNorm gamma / beta / moving_mean / moving_variance map 1:1 onto
  scale / bias (params) and mean / var (batch_stats);
- the CycleGAN InstanceNorm gamma / beta: (C,) for the per-channel norm,
  (H, 1, 1) for tfa `InstanceNormalization(axis=1)` artifacts, which carry
  per-height parameters and load only into a `quirk_axis1=True` model.

The readers take the Keras-2 ("<layer>/<layer>/kernel:0") and Keras-3
("<layer>/<model>/<layer>/kernel") layouts of a full-model .h5 and the
Keras-2 `save_weights` layout; a Keras-3 `.weights.h5` is refused.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

Layers = list[tuple[str, dict[str, np.ndarray]]]
Stream = list[tuple[str, np.ndarray]]


def convt_kernel_to_flax(k_keras: np.ndarray) -> np.ndarray:
    """(kh, kw, out, in) gradient-of-conv kernel -> (kh, kw, in, out)
    fractionally-strided-conv kernel: rotate 180 degrees spatially and swap
    the channel axes, as a contiguous copy."""
    return np.ascontiguousarray(np.transpose(k_keras[::-1, ::-1], (0, 1, 3, 2)))


def _h5py(path):
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"reading the Keras weights file {str(path)!r} needs h5py") from e
    return h5py


def _text(x) -> str:
    return x.decode() if isinstance(x, bytes) else str(x)


def read_h5_layers(path: str | Path) -> Layers:
    """[(layer_name, {tensor_basename: array})] in model layer order: the
    root's `layer_names` attribute (under `model_weights` when the file has
    it), else h5py's key order; each layer's datasets found at any depth,
    with Keras-2's ':0' stripped from their names."""
    h5py = _h5py(path)
    out: Layers = []
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        names = [_text(n) for n in root.attrs.get("layer_names", list(root.keys()))]
        for name in names:
            if name not in root:
                continue
            tensors: dict[str, np.ndarray] = {}

            def walk(group):
                for key in group:
                    item = group[key]
                    if isinstance(item, h5py.Dataset):
                        tensors[key.split(":")[0]] = np.asarray(item)
                    else:
                        walk(item)

            walk(root[name])
            out.append((name, tensors))
    return out


def _read_save_weights_h5(path: str | Path) -> Stream:
    """Ordered (weight_path, array) stream from a Keras-2 save_weights h5:
    layer order from the root `layer_names` attribute, intra-layer order
    from each layer group's `weight_names` attribute."""
    h5py = _h5py(path)
    out: Stream = []
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        if "layer_names" not in root.attrs:
            raise ValueError(
                f"{path} is not a Keras-2 save_weights h5 (no layer_names "
                f"attr); Keras-3 .weights.h5 files are not supported"
            )
        for lname in [_text(x) for x in root.attrs["layer_names"]]:
            g = root[lname]
            for wname in [_text(x) for x in g.attrs.get("weight_names", [])]:
                out.append((f"{lname}/{wname}", np.asarray(g[wname])))
    return out


def _weighted(layers: Layers, expect: int, what: str) -> Layers:
    weighted = [(n, t) for n, t in layers if t]
    if len(weighted) != expect:
        raise ValueError(
            f"expected {expect} weighted layers for the {what}, got "
            f"{len(weighted)}: {[n for n, _ in weighted]}"
        )
    return weighted


def _bn(bn: dict[str, np.ndarray]) -> tuple[dict, dict]:
    """A Keras BatchNormalization's (params, batch_stats) entries."""
    return ({"BatchNorm_0": {"scale": bn["gamma"], "bias": bn["beta"]}},
            {"BatchNorm_0": {"mean": bn["moving_mean"], "var": bn["moving_variance"]}})


def sndcgan_generator_tree(layers: Layers) -> dict:
    """Reference make_dcgan_generator layers -> {"params", "batch_stats"}
    for models/sndcgan.Generator. Weighted-layer order (SNDCGAN.py:25-66):
    dense, bn, (convT, bn) x3, convT."""
    it = (t for _, t in _weighted(layers, 1 + 1 + 3 * 2 + 1, "SNDCGAN generator"))
    params: dict = {"stem": {"Dense_0": {"kernel": next(it)["kernel"]}}}
    stats: dict = {}
    params["stem_bn"], stats["stem_bn"] = _bn(next(it))
    for i in range(3):
        params[f"up{i}"] = {
            "ConvTranspose_0": {"kernel": convt_kernel_to_flax(next(it)["kernel"])}}
        params[f"up{i}_bn"], stats[f"up{i}_bn"] = _bn(next(it))
    params["to_rgb"] = {
        "ConvTranspose_0": {"kernel": convt_kernel_to_flax(next(it)["kernel"])}}
    return {"params": params, "batch_stats": stats}


def sndcgan_discriminator_tree(layers: Layers) -> dict:
    """Reference make_dcgan_discriminator layers -> {"params", "spectral"}
    for models/sndcgan.Discriminator (7 convs + dense head, SNDCGAN.py:
    69-128). The reference has no spectral norm, so `spectral` is empty
    (load into a spectral_norm=False config)."""
    weighted = _weighted(layers, 8, "SNDCGAN discriminator")
    params: dict = {
        f"conv{i}": {"Conv_0": {"kernel": t["kernel"], "bias": t["bias"]}}
        for i, (_, t) in enumerate(weighted[:7])
    }
    head = weighted[7][1]
    params["head"] = {"Dense_0": {"kernel": head["kernel"], "bias": head["bias"]}}
    return {"params": params, "spectral": {}}


def wgan_generator_tree(layers: Layers) -> dict:
    """Reference WGAN define_generator layers (WGAN.py:105-134): dense,
    (convT, bn) x3, conv head."""
    it = (t for _, t in _weighted(layers, 1 + 3 * 2 + 1, "WGAN generator"))
    params: dict = {"stem": {"Dense_0": {"kernel": next(it)["kernel"]}}}
    stats: dict = {}
    for i in range(3):
        params[f"up{i}"] = {
            "ConvTranspose_0": {"kernel": convt_kernel_to_flax(next(it)["kernel"])}}
        params[f"up{i}_bn"], stats[f"up{i}_bn"] = _bn(next(it))
    params["to_rgb"] = {"Conv_0": {"kernel": next(it)["kernel"]}}
    return {"params": params, "batch_stats": stats}


def wgan_critic_tree(layers: Layers) -> dict:
    """Reference WGAN define_critic layers (WGAN.py:53-101): (conv, bn) x7
    + dense head."""
    it = (t for _, t in _weighted(layers, 7 * 2 + 1, "WGAN critic"))
    params: dict = {}
    stats: dict = {}
    for i in range(7):
        conv = next(it)
        params[f"conv{i}"] = {"Conv_0": {"kernel": conv["kernel"], "bias": conv["bias"]}}
        params[f"conv{i}_bn"], stats[f"conv{i}_bn"] = _bn(next(it))
    head = next(it)
    params["head"] = {"Dense_0": {"kernel": head["kernel"], "bias": head["bias"]}}
    return {"params": params, "batch_stats": stats}


def _in_params(gamma: np.ndarray, beta: np.ndarray, channels: int) -> dict:
    """IN gamma/beta onto the port's InstanceNorm parameter shapes: (C,)
    for the per-channel norm; per-H tfa axis=1 artifacts get (H, 1, 1) for
    quirk_axis1=True models. Decided by shape."""
    if gamma.size == channels and gamma.ndim == 1:
        return {"scale": gamma, "bias": beta}
    return {"scale": gamma.reshape(-1, 1, 1), "bias": beta.reshape(-1, 1, 1)}


def cyclegan_generator_tree(stream: Stream) -> dict:
    """Reference CycleGAN generator save_weights stream -> {"params"} for
    models/cyclegan.Generator.

    Weighted-layer order (cyclegan/CycleGAN.py:161-183): conv_c7_s1(64),
    d_conv(128), d_conv(256), N x ResBlock(256), u_conv(128), u_conv(64),
    conv_c7_s1(3): each block contributes (conv kernel, conv bias, IN
    gamma, IN beta), and each ResBlock conv1, in1, conv2, in2 (the
    reference ResBlock's attribute order, :62-70)."""
    vals = [a for _, a in stream]
    if len(vals) % 4 != 0 or len(vals) < 6 * 4:
        raise ValueError(f"unexpected weight count {len(vals)} for a CycleGAN generator")
    n_res = (len(vals) - 6 * 4) // 8
    it = iter(vals)

    def block(conv_key: str = "Conv_0", transpose: bool = False) -> tuple[dict, dict]:
        k, b, g, beta = next(it), next(it), next(it), next(it)
        if transpose:
            k = convt_kernel_to_flax(k)
        return {conv_key: {"kernel": k, "bias": b}}, _in_params(g, beta, k.shape[-1])

    params: dict = {}
    for name in ("stem_conv", "down0", "down1"):
        params[name], params[f"{name.removesuffix('_conv')}_in"] = block()
    for i in range(n_res):
        (conv1, in1), (conv2, in2) = block(), block()
        params[f"res{i}"] = {"conv1": conv1, "in1": in1, "conv2": conv2, "in2": in2}
    for name in ("up0", "up1"):
        params[name], params[f"{name}_in"] = block("ConvTranspose_0", transpose=True)
    params["to_rgb"], params["to_rgb_in"] = block()
    return {"params": params}


def cyclegan_discriminator_tree(stream: Stream) -> dict:
    """Reference PatchGAN save_weights stream -> {"params"} for
    models/cyclegan.Discriminator.

    Weighted-layer order (cyclegan/CycleGAN.py:112-126): k_conv(64, no
    norm) -> k_conv(128/256/512, each conv + IN) -> final Conv2D(1, 4x4
    s1); IN gamma/beta map onto conv{i}_in scale/bias ((C,) or (H, 1, 1),
    decided by shape)."""
    vals = [a for _, a in stream]
    if len(vals) != 16:
        raise ValueError(
            f"unexpected weight count {len(vals)} for a CycleGAN "
            f"discriminator (expected 16)"
        )
    it = iter(vals)
    params: dict = {"conv0": {"Conv_0": {"kernel": next(it), "bias": next(it)}}}
    for i in (1, 2, 3):
        k, b, g, beta = next(it), next(it), next(it), next(it)
        params[f"conv{i}"] = {"Conv_0": {"kernel": k, "bias": b}}
        params[f"conv{i}_in"] = _in_params(g, beta, k.shape[-1])
    params["head"] = {"Conv_0": {"kernel": next(it), "bias": next(it)}}
    return {"params": params}


def import_sndcgan_generator(h5_path: str | Path) -> dict:
    return sndcgan_generator_tree(read_h5_layers(h5_path))


def import_sndcgan_discriminator(h5_path: str | Path) -> dict:
    return sndcgan_discriminator_tree(read_h5_layers(h5_path))


def import_wgan_generator(h5_path: str | Path) -> dict:
    return wgan_generator_tree(read_h5_layers(h5_path))


def import_wgan_critic(h5_path: str | Path) -> dict:
    return wgan_critic_tree(read_h5_layers(h5_path))


def import_cyclegan_generator(h5_path: str | Path) -> dict:
    return cyclegan_generator_tree(_read_save_weights_h5(h5_path))


def import_cyclegan_discriminator(h5_path: str | Path) -> dict:
    return cyclegan_discriminator_tree(_read_save_weights_h5(h5_path))


IMPORTERS = {
    "sndcgan-gen": import_sndcgan_generator,
    "sndcgan-disc": import_sndcgan_discriminator,
    "wgan-gen": import_wgan_generator,
    "wgan-critic": import_wgan_critic,
    "cyclegan-gen": import_cyclegan_generator,
    "cyclegan-disc": import_cyclegan_discriminator,
}


def main(argv=None) -> None:
    """Convert one .h5 into a params-only export. The importer's tree is
    written as it stands (never through `bridge.export_variables`: the
    CycleGAN PatchGAN has no export collections of its own)."""
    import argparse

    from imagegeneration_tpu_torch.core.checkpoint import export_params

    parser = argparse.ArgumentParser(
        description="Convert reference Keras .h5 weights to msgpack exports."
    )
    parser.add_argument("h5_path")
    parser.add_argument("out_path", help="destination .msgpack")
    parser.add_argument("--kind", choices=sorted(IMPORTERS), required=True)
    args = parser.parse_args(argv)
    tree = IMPORTERS[args.kind](args.h5_path)
    export_params(args.out_path, tree)
    print(f"imported {args.kind} weights -> {args.out_path}")


if __name__ == "__main__":
    main()
