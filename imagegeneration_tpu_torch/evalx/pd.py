"""CycleGAN "perception distance": the MSE of VGG16 features per image pair.

The counterpart of imagegeneration_tpu/evalx/pd.py, after
cyclegan/generator_evaluation.py:

- the features are VGG16's up to `layers[15]`, the ReLU output of
  block5_conv1 (:124-125): 3x3 SAME convs with bias and ReLU, 64,64 |
  128,128 | 256,256,256 | 512,512,512 | 512, with a 2x2/2 max pool
  between blocks. The convs carry the Keras layer names
  (`block{b}_conv{c}`), so an h5 and the bridge find each by name;
- the reference downloads the imagenet weights. Here they come from a
  Keras-2 `save_weights` h5 (`weights_path`, or the IMAGEGEN_VGG16_WEIGHTS
  variable); with neither, from a fixed-seed init (flax's LeCun-normal
  kernels, zero biases). The port cannot replay JAX's threefry draws, so
  its random-init PDs differ from the JAX package's (a documented delta).
  A named file that does not exist raises: the JAX loader falls back to
  the random init there;
- the PD of a pair is the mean squared difference of the two feature maps
  (:38-45), batched on the device;
- the reference's quirks are kept: the images stay in [-1, 1] (no caffe
  preprocessing, :126,137) and are resized to 224x224 with NEAREST
  (`skimage.resize(image, shape, 0)`, :48-50). `nearest-exact` is
  `jax.image.resize(method="nearest")`'s rule (pixel centres); torch's
  `nearest` is another.

The trunk runs in float32 on channels_last activations (TF32 off, see
core/platform.configure_numerics) and returns NHWC float32.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imagegeneration_tpu_torch import bridge
from imagegeneration_tpu_torch.nn.layers import Conv

# Conv widths up to block5_conv1 (Keras VGG16 layers[1..15]).
VGG_PLAN = (
    (64, 64),
    (128, 128),
    (256, 256, 256),
    (512, 512, 512),
    (512,),  # block5_conv1 only: the layers[15] cutoff
)
VGG_SIZE = 224
INIT_SEED = 1715  # the JAX package's init key
WEIGHTS_ENV = "IMAGEGEN_VGG16_WEIGHTS"


class VGG16Features(nn.Module):
    """VGG16 up to block5_conv1 (inclusive): (B, 3, H, W) -> NHWC float32
    (B, H/16, W/16, 512)."""

    def __init__(self, generator: torch.Generator | None = None) -> None:
        super().__init__()
        cin = 3
        for b, widths in enumerate(VGG_PLAN):
            for c, width in enumerate(widths):
                self.add_module(f"block{b + 1}_conv{c + 1}", Conv(
                    cin, width, (3, 3), generator=generator, kernel_init="lecun_normal"))
                cin = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().contiguous(memory_format=torch.channels_last)
        for b, widths in enumerate(VGG_PLAN):
            for c in range(len(widths)):
                x = torch.relu_(self.get_submodule(f"block{b + 1}_conv{c + 1}")(x))
            if b < len(VGG_PLAN) - 1:
                x = F.max_pool2d(x, 2, 2)
        return x.permute(0, 2, 3, 1)


def weights_file(weights_path: str | None, env: str) -> str | None:
    """The weights file named by `weights_path` or the variable `env`
    (None: neither names one). A named file must exist."""
    weights_path = weights_path or os.environ.get(env)
    if weights_path and not os.path.exists(weights_path):
        raise FileNotFoundError(f"weights file not found: {weights_path!r}")
    return weights_path or None


def read_h5_layers(weights_path: str, names: list[str], datasets: dict[str, str]) -> dict:
    """{layer: {key: array}} from a Keras-2 `save_weights` h5
    (`[model_weights/]<layer>/<layer>/<dataset>`), where `datasets` maps
    each key to its dataset name (e.g. "kernel" -> "kernel:0"). A layer
    missing from the file raises KeyError (the JAX VGG loader keeps its
    random init for it)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"reading the weights file {weights_path!r} needs h5py") from e
    out = {}
    with h5py.File(weights_path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        missing = [name for name in names if name not in root]
        if missing:
            raise KeyError(f"{weights_path!r} has no layers {missing}")
        for name in names:
            g = root[name]
            inner = g[name] if name in g else g
            out[name] = {k: np.asarray(inner[d]) for k, d in datasets.items()}
    return out


def load_vgg16_params(
    weights_path: str | None = None, device: torch.device | str = "cpu",
) -> VGG16Features:
    """A VGG16Features in eval mode on `device`: the h5's weights where a
    file is named, else the fixed-seed init."""
    model = VGG16Features(torch.Generator().manual_seed(INIT_SEED))
    path = weights_file(weights_path, WEIGHTS_ENV)
    if path is not None:
        names = [n for n, _ in model.named_children()]
        layers = read_h5_layers(path, names, {"kernel": "kernel:0", "bias": "bias:0"})
        bridge.load_jax_vgg16(model, {"params": layers})
    return model.to(device).eval()


def nearest_resize_224(images: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 224, 224), nearest by pixel centres
    (`jax.image.resize(method="nearest")`, skimage order 0)."""
    return F.interpolate(images, size=(VGG_SIZE, VGG_SIZE), mode="nearest-exact")


def vgg_features(model: VGG16Features, images: torch.Tensor) -> torch.Tensor:
    """Features of (B, H, W, 3) images in [-1, 1], at 224x224."""
    return model(nearest_resize_224(images.permute(0, 3, 1, 2)))


def pd_from_features(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) mean squared difference of two feature batches."""
    diff = (a - b).reshape(a.shape[0], -1)
    return torch.mean(diff * diff, dim=-1)


def make_pd_fn(model: VGG16Features):
    """pd(inputs, outputs): (B, H, W, 3) image batches in [-1, 1] on the
    model's device -> (B,) PDs."""

    @torch.inference_mode()
    def pd(inputs: torch.Tensor, outputs: torch.Tensor) -> torch.Tensor:
        return pd_from_features(vgg_features(model, inputs), vgg_features(model, outputs))

    return pd


def calculate_pd(pd_fn, image_input: np.ndarray, image_output: np.ndarray,
                 device: torch.device | str = "cpu") -> float:
    """Single-pair API, after the reference's calculate_pd (:38-45):
    (H, W, 3) images in [-1, 1]."""
    def batch(a):
        return torch.from_numpy(np.asarray(a, np.float32)[None]).to(device)

    return float(pd_fn(batch(image_input), batch(image_output))[0])
