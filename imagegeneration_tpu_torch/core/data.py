"""Host-side image datasets and the on-device uint8 -> float rescale.

The counterpart of imagegeneration_tpu/core/data.py, re-implemented because
that module imports jax (through its PRNG streams) and PIL at module top,
and the GPU machine has neither. Semantics kept:

- an image folder is decoded once into one contiguous uint8 (N, H, W, 3)
  array: center crop to the target aspect ratio, then bilinear resize
  (keras `image_dataset_from_directory(crop_to_aspect_ratio=True)`);
- each epoch reshuffles images (not batches) from a seeded stream
  (`permutation`); the engines' feed (train/feed.py) drops the remainder,
  so every batch has the static batch size;
- batches leave the host as uint8 and are rescaled on the device by
  `normalize` (x / 127.5 - 1);
- `PairedDataset` zips two unpaired domains per batch (CycleGAN), each
  with its own shuffle stream.

`resident_budget` decides, for the engines, whether a dataset is kept on
the device as uint8 or streamed from the host.

Host-sharded mode (`ImageFolderDataset(shard=(i, n))`, the trainers'
`--host-sharded-data`): data-parallel rank i of n decodes only its
contiguous block of the sorted files (the JAX package's bounds,
linspace(0, files, n + 1)) and shuffles it with its own per-(epoch, rank)
stream. Every rank knows every shard's size (`shard_sizes`), so all ranks
reach the same batch count (train/feed.py) without a collective.

The decoders are imported only when a folder is read: cv2, then PIL for
what cv2 cannot read (GIF) or where cv2 is missing. A file that no
decoder can read raises an error naming the file and the decoders tried;
`ImageFolderDataset.decoders` counts the files each decoder read. (The
GPU machine has cv2 4.13 and PIL, and no libjpeg headers: PERF.md §4.)
Shuffles come from the port's own numpy generator (core/rng.py); they are
stable for a seed but differ from the JAX package's batch order.
"""

from __future__ import annotations

import queue
import sys
import threading
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from imagegeneration_tpu_torch.core.rng import DEFAULT_DATA_SEED, KeyChain

# Extensions accepted by keras.utils.image_dataset_from_directory.
ALLOWED_EXTENSIONS = (".bmp", ".gif", ".jpeg", ".jpg", ".png")
RESIDENT_SHARE = 0.5


def resident_budget(device: torch.device) -> int:
    """Bytes of uint8 images an engine keeps on `device`.

    On a card: half of the memory free once the train state is placed; the
    step's own activations take the other half (PERF.md gives the headline
    steps' measured peaks). On the CPU the images already live in host
    memory and `torch.from_numpy` shares them, so every dataset fits."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(free * RESIDENT_SHARE)
    return sys.maxsize


def list_image_files(
    root: str | Path, labeled: bool = True, follow_links: bool = False
) -> tuple[list[Path], list[int], list[str]]:
    """Enumerate image files the way image_dataset_from_directory does.

    labeled=True: each subdirectory of `root` is one class; labeled=False:
    all images under root, recursively. Deterministically sorted."""
    root = Path(root)
    if not root.exists():
        raise FileNotFoundError(f"dataset directory not found: {root}")

    def _walk(d: Path) -> list[Path]:
        return [
            p for p in sorted(d.rglob("*"))
            if p.is_file() and p.suffix.lower() in ALLOWED_EXTENSIONS
            and (follow_links or not p.is_symlink())
        ]

    if labeled:
        class_dirs = sorted(p for p in root.iterdir() if p.is_dir())
        files: list[Path] = []
        labels: list[int] = []
        for idx, d in enumerate(class_dirs):
            fs = _walk(d)
            files.extend(fs)
            labels.extend([idx] * len(fs))
        if not files:
            raise FileNotFoundError(f"no images under class dirs of {root}")
        return files, labels, [d.name for d in class_dirs]
    files = _walk(root)
    if not files:
        raise FileNotFoundError(f"no images under {root}")
    return files, [0] * len(files), []


def _decode_rgb(path: Path) -> tuple[np.ndarray, str]:
    """(H, W, 3) uint8 RGB and the name of the decoder that read it."""
    tried = []
    try:
        import cv2
    except ImportError:
        tried.append("cv2 (not installed)")
    else:
        img = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if img is not None:
            return cv2.cvtColor(img, cv2.COLOR_BGR2RGB), "cv2"
        tried.append("cv2 (cannot read it)")
    try:
        from PIL import Image
    except ImportError:
        tried.append("PIL (not installed)")
    else:
        try:
            with Image.open(path) as im:
                return np.asarray(im.convert("RGB")), "PIL"
        except OSError as e:  # PIL's UnidentifiedImageError is an OSError
            tried.append(f"PIL ({e})")
    raise ValueError(f"cannot decode {path}: tried {'; '.join(tried)}")


def _resize(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        from PIL import Image

        return np.asarray(Image.fromarray(img).resize((tw, th), Image.BILINEAR))
    return cv2.resize(img, (tw, th), interpolation=cv2.INTER_LINEAR)


def _load(
    path: str | Path, image_size: tuple[int, int], crop_to_aspect_ratio: bool = True
) -> tuple[np.ndarray, str]:
    th, tw = image_size
    img, decoder = _decode_rgb(Path(path))
    h, w = img.shape[:2]
    if crop_to_aspect_ratio and h * tw != w * th:
        if h * tw > w * th:  # too tall -> crop height
            ch = (w * th) // tw
            top = (h - ch) // 2
            img = img[top:top + ch]
        else:  # too wide -> crop width
            cw = (h * tw) // th
            left = (w - cw) // 2
            img = img[:, left:left + cw]
    if img.shape[:2] != (th, tw):
        img = _resize(img, th, tw)
    return np.ascontiguousarray(img, dtype=np.uint8), decoder


def load_image(
    path: str | Path, image_size: tuple[int, int], crop_to_aspect_ratio: bool = True
) -> np.ndarray:
    """Decode one image to uint8 (H, W, 3): largest centered crop with the
    target aspect ratio, then bilinear resize."""
    return _load(path, image_size, crop_to_aspect_ratio)[0]


class _ShuffledImages:
    """An in-memory uint8 image array, reshuffled per epoch."""

    _images: np.ndarray
    _chain: KeyChain

    def __len__(self) -> int:
        return self._images.shape[0]

    @property
    def images(self) -> np.ndarray:
        return self._images

    def num_batches(self, batch_size: int) -> int:
        """Full batches only: an epoch drops the remainder."""
        return len(self) // batch_size

    shard: tuple[int, int] | None = None

    def permutation(self, epoch: int) -> np.ndarray:
        """The epoch's image order, from the dataset's own "data" stream
        (a shard's: its own stream per rank)."""
        if self.shard is None:
            return self._chain.numpy_rng("data", epoch).permutation(len(self))
        seed = self._chain.seed
        rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, epoch, 1 + self.shard[0]])
        return rng.permutation(len(self))


class ImageFolderDataset(_ShuffledImages):
    """Decoded-and-cached image folder; with `shard=(i, n)` only the i-th
    of n contiguous blocks of its sorted files (`shard_sizes`: every
    block's size)."""

    def __init__(
        self,
        root: str | Path,
        image_size: tuple[int, int],
        labeled: bool = True,
        follow_links: bool = False,
        seed: int = DEFAULT_DATA_SEED,
        shard: tuple[int, int] | None = None,
    ) -> None:
        self.files, self.labels, self.class_names = list_image_files(
            root, labeled, follow_links
        )
        if shard is not None:
            i, n = shard
            if not 0 <= i < n:
                raise ValueError(f"bad shard {shard}")
            bounds = np.linspace(0, len(self.files), n + 1).astype(int)
            self.shard_sizes = np.diff(bounds)
            self.files = self.files[bounds[i]:bounds[i + 1]]
            self.labels = self.labels[bounds[i]:bounds[i + 1]]
            self.shard = (i, n)
        h, w = image_size
        self._images = np.empty((len(self.files), h, w, 3), dtype=np.uint8)
        self.decoders: dict[str, int] = {}  # files read by each decoder
        for i, f in enumerate(self.files):
            self._images[i], decoder = _load(f, image_size)
            self.decoders[decoder] = self.decoders.get(decoder, 0) + 1
        self._chain = KeyChain(seed)


class SyntheticImageDataset(_ShuffledImages):
    """Deterministic random-image dataset (tests, smoke runs; no disk I/O)."""

    def __init__(
        self, num_images: int, image_size: tuple[int, int],
        seed: int = DEFAULT_DATA_SEED,
    ) -> None:
        h, w = image_size
        self._images = np.random.default_rng(seed).integers(
            0, 256, size=(num_images, h, w, 3), dtype=np.uint8
        )
        self._chain = KeyChain(seed)


class PairedDataset:
    """Two unpaired domains zipped per batch (cyclegan/data_loader.py:5-41).
    An epoch is the fewer full batches of the two; each domain reshuffles
    from its own stream."""

    def __init__(self, ds_x: _ShuffledImages, ds_y: _ShuffledImages) -> None:
        self.ds_x = ds_x
        self.ds_y = ds_y

    def num_batches(self, batch_size: int) -> int:
        return min(self.ds_x.num_batches(batch_size), self.ds_y.num_batches(batch_size))


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Yield from `iterator`, filled ahead by one background thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    error: list[Exception] = []

    def _worker() -> None:
        try:
            for item in iterator:
                q.put(item)
        except Exception as e:  # handed to the consumer, re-raised there
            error.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=_worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            t.join()
            if error:
                raise error[0]
            return
        yield item


def normalize(x_u8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The Rescaling(1/127.5, -1) layer, on the tensor's device."""
    return x_u8.to(dtype) / 127.5 - 1.0
