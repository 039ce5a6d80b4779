"""InceptionV3 pool features for the standard FID (FIDEvaluator's
`feature_source="inception"`).

The counterpart of imagegeneration_tpu/evalx/inception.py: InceptionV3
(Szegedy et al. 2015) up to the global average pool, (B, 2048).

- Layer names: the convolutions are `conv2d`, `conv2d_1`, ... and the
  batch norms `batch_normalization`, `batch_normalization_1`, ..., in the
  creation order of tf.keras.applications.InceptionV3 (94 pairs), so a
  Keras `save_weights` h5 of that model loads by name and the bridge
  (bridge.load_jax_inception) copies the JAX variables leaf by leaf. The
  architecture is written once, in `_trunk`, which both builds the layers
  (on channel counts) and runs them (on tensors), so the two orders
  cannot drift apart.
- Layers: convs without bias, TF-SAME or VALID; batch norm in inference
  with the moving statistics, no scale, epsilon 1e-3, then ReLU (Keras
  applications); max pool 3x3/2 VALID; the branch pool a 3x3/1 SAME
  average that counts only the pixels inside the image.
- `prepare_images` resizes to 299x299 as `jax.image.resize(method=
  "bilinear")` does: half-pixel centres, antialiased on every downscaled
  axis (`F.interpolate(antialias=True)`; without it a 512x288 input is off
  by up to ~1).
- Weights: a Keras-2 `save_weights` h5 (`weights_path` or the
  IMAGEGEN_INCEPTION_WEIGHTS variable); with neither, after one printed
  line, a fixed-seed init (flax's LeCun-normal kernels, zero beta, moving
  mean 0 and variance 1): valid as a relative metric only, and unlike the
  JAX package's random init (the port does not replay threefry). A named
  file that does not exist raises FileNotFoundError.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.evalx.pd import read_h5_layers, weights_file
from imagegeneration_tpu_torch.nn.layers import Conv

INCEPTION_SIZE = 299
INIT_SEED = 1980  # the JAX package's init key
WEIGHTS_ENV = "IMAGEGEN_INCEPTION_WEIGHTS"
BN_EPS = 1e-3


class InferenceBatchNorm(nn.Module):
    """Keras BatchNormalization(scale=False) in inference: (x - mean) /
    sqrt(var + eps) + beta, from the moving statistics."""

    def __init__(self, features: int) -> None:
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.mean, self.var, None, self.bias, False, 0.0, BN_EPS)


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


def _avgpool_same(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


def _cat(xs: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat(xs, dim=1)


def _trunk(x, cbr: Callable, maxpool: Callable, avgpool: Callable, cat: Callable):
    """The InceptionV3 trunk in the JAX module's creation order
    (inception.py:44-133). `cbr(x, filters, kh, kw, strides, padding)` is
    one conv + batch norm + ReLU; on tensors the functions compute, on
    channel counts they build."""
    # stem
    x = cbr(x, 32, 3, 3, (2, 2), "VALID")
    x = cbr(x, 32, 3, 3, padding="VALID")
    x = cbr(x, 64, 3, 3)
    x = maxpool(x)
    x = cbr(x, 80, 1, 1, padding="VALID")
    x = cbr(x, 192, 3, 3, padding="VALID")
    x = maxpool(x)
    # mixed0..2 (35x35)
    for pool_width in (32, 64, 64):
        b1 = cbr(x, 64, 1, 1)
        b5 = cbr(cbr(x, 48, 1, 1), 64, 5, 5)
        b3 = cbr(cbr(cbr(x, 64, 1, 1), 96, 3, 3), 96, 3, 3)
        bp = cbr(avgpool(x), pool_width, 1, 1)
        x = cat([b1, b5, b3, bp])
    # mixed3 (to 17x17)
    b3 = cbr(x, 384, 3, 3, (2, 2), "VALID")
    bd = cbr(cbr(x, 64, 1, 1), 96, 3, 3)
    bd = cbr(bd, 96, 3, 3, (2, 2), "VALID")
    x = cat([b3, bd, maxpool(x)])
    # mixed4..7 (17x17)
    for width in (128, 160, 160, 192):
        b1 = cbr(x, 192, 1, 1)
        b7 = cbr(cbr(cbr(x, width, 1, 1), width, 1, 7), 192, 7, 1)
        bd = cbr(x, width, 1, 1)
        bd = cbr(cbr(bd, width, 7, 1), width, 1, 7)
        bd = cbr(cbr(bd, width, 7, 1), 192, 1, 7)
        bp = cbr(avgpool(x), 192, 1, 1)
        x = cat([b1, b7, bd, bp])
    # mixed8 (to 8x8)
    b3 = cbr(cbr(x, 192, 1, 1), 320, 3, 3, (2, 2), "VALID")
    b7 = cbr(cbr(cbr(x, 192, 1, 1), 192, 1, 7), 192, 7, 1)
    b7 = cbr(b7, 192, 3, 3, (2, 2), "VALID")
    x = cat([b3, b7, maxpool(x)])
    # mixed9..10 (8x8)
    for _ in range(2):
        b1 = cbr(x, 320, 1, 1)
        b3 = cbr(x, 384, 1, 1)
        b3 = cat([cbr(b3, 384, 1, 3), cbr(b3, 384, 3, 1)])
        bd = cbr(cbr(x, 448, 1, 1), 384, 3, 3)
        bd = cat([cbr(bd, 384, 1, 3), cbr(bd, 384, 3, 1)])
        bp = cbr(avgpool(x), 192, 1, 1)
        x = cat([b1, b3, bd, bp])
    return x


def _suffix(i: int) -> str:
    return "" if i == 0 else f"_{i}"


class InceptionV3Features(nn.Module):
    """(B, 3, 299, 299) in [-1, 1] (see `prepare_images`) -> (B, 2048)
    float32 pool features."""

    def __init__(self, generator: torch.Generator | None = None) -> None:
        super().__init__()
        i = 0

        def build(cin, filters, kh, kw, strides=(1, 1), padding="SAME"):
            nonlocal i
            s = _suffix(i)
            i += 1
            self.add_module(f"conv2d{s}", Conv(
                cin, filters, (kh, kw), strides, padding, use_bias=False,
                generator=generator, kernel_init="lecun_normal"))
            self.add_module(f"batch_normalization{s}", InferenceBatchNorm(filters))
            return filters

        _trunk(3, build, lambda c: c, lambda c: c, sum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        i = 0

        def cbr(x, filters, kh, kw, strides=(1, 1), padding="SAME"):
            nonlocal i
            s = _suffix(i)
            i += 1
            x = self.get_submodule(f"conv2d{s}")(x)
            return torch.relu_(self.get_submodule(f"batch_normalization{s}")(x))

        x = x.float().contiguous(memory_format=torch.channels_last)
        x = _trunk(x, cbr, _maxpool, _avgpool_same, _cat)
        return x.mean(dim=(2, 3))


def prepare_images(images: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) in [-1, 1], any H x W -> (B, 3, 299, 299), bilinear
    with antialiasing (`jax.image.resize(method="bilinear")`)."""
    return F.interpolate(images, size=(INCEPTION_SIZE, INCEPTION_SIZE), mode="bilinear",
                         align_corners=False, antialias=True)


def load_inception_params(
    weights_path: str | None = None, device: torch.device | str = "cpu",
) -> InceptionV3Features:
    """An InceptionV3Features in eval mode on `device`: the h5's weights
    where a file is named, else the fixed-seed init."""
    model = InceptionV3Features(torch.Generator().manual_seed(INIT_SEED))
    path = weights_file(weights_path, WEIGHTS_ENV)
    if path is None:
        print("[inception] no weights available — using fixed-seed random init "
              "(valid as a RELATIVE metric only)", flush=True)
    else:
        names = [n for n, _ in model.named_children()]
        convs = read_h5_layers(path, [n for n in names if n.startswith("conv2d")],
                               {"kernel": "kernel:0"})
        norms = read_h5_layers(
            path, [n for n in names if n.startswith("batch_normalization")],
            {"bias": "beta:0", "mean": "moving_mean:0", "var": "moving_variance:0"})
        bridge.load_jax_inception(model, {
            "params": {**convs, **{n: {"bias": v["bias"]} for n, v in norms.items()}},
            "batch_stats": {n: {"mean": v["mean"], "var": v["var"]}
                            for n, v in norms.items()}})
    return model.to(device).eval()


def make_feature_fn(model: InceptionV3Features):
    """features(images): (B, H, W, 3) in [-1, 1] on the model's device ->
    (B, 2048)."""

    @torch.inference_mode()
    def features(images: torch.Tensor) -> torch.Tensor:
        return model(prepare_images(images.permute(0, 3, 1, 2)))

    return features
