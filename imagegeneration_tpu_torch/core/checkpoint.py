"""Whole-train-state checkpoints over torch.save / torch.load.

The counterpart of imagegeneration_tpu/core/checkpoint.py's
`CheckpointManager` (orbax there): epoch-numbered saves of the full train
state, `max_to_keep` newest kept, restore of the latest. A save writes
`<dir>/<epoch>/state.pt` through a temporary file and a rename, so a save
cut short never leaves a half-written checkpoint under an epoch's name.

Loading uses `weights_only=True`: a checkpoint holds tensors, numbers and
containers only, and nothing in it can run code.

Params-only exports (`export_params` / `load_params`, the reference's .h5
role) are written in flax's msgpack format, byte for byte what the JAX
package's `flax.serialization.to_bytes` writes, with plain `msgpack`, so the
two packages read each other's files (flax/serialization.py, 0.12):

- a dict is a msgpack map with string keys (sorted, as a JAX pytree
  flattens them), a list or tuple a map keyed "0", "1", ...;
- an ndarray is ext type 1 holding `msgpack((shape, dtype name, C-order
  bytes))`; a numpy scalar is written as a 0-d array (the JAX package's
  `jax.device_get` makes it one) and read from ext type 3 as well;
- an array of more than MAX_CHUNK_SIZE bytes becomes a
  `{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}`
  map of flat pieces (msgpack holds at most 2**31 - 1 bytes per object).

The trees come from `bridge.export_variables`; `load_params` returns the
dict tree of numpy arrays, which `bridge.load_flax_variables` copies into a
model.
"""

from __future__ import annotations

import os
import re
import shutil
from pathlib import Path
from typing import Any

import msgpack
import numpy as np
import torch

_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str | Path, max_to_keep: int = 2):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def all_epochs(self) -> list[int]:
        return sorted(
            int(p.name) for p in self._dir.iterdir()
            if p.name.isdigit() and (p / _FILE).exists()
        )

    def latest_epoch(self) -> int | None:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def save(self, epoch: int, state: dict[str, Any]) -> None:
        d = self._dir / str(epoch)
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / f"{_FILE}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, d / _FILE)
        for old in self.all_epochs()[: -self.max_to_keep]:
            shutil.rmtree(self._dir / str(old))

    def restore(
        self, epoch: int | None = None, map_location: torch.device | str = "cpu"
    ) -> dict[str, Any]:
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {self._dir}")
        return torch.load(
            self._dir / str(epoch) / _FILE, map_location=map_location,
            weights_only=True,
        )


# ------------------------------------------------ flax msgpack exports
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2**30  # flax's margin under msgpack's 2**31 - 1 limit
_CHUNKED = "__msgpack_chunked_array__"


def _ndarray_to_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be exported")
    return msgpack.packb((a.shape, a.dtype.name, a.tobytes("C")), use_bin_type=True)


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, name, buffer = msgpack.unpackb(data, raw=True)
    if name == b"bfloat16":
        import ml_dtypes  # the one dtype numpy lacks; flax maps it the same way

        dtype = np.dtype(ml_dtypes.bfloat16)
    else:
        dtype = np.dtype(name.decode())
    return np.frombuffer(buffer, dtype=dtype).reshape(shape, order="C")


def _ext_pack(x: Any) -> msgpack.ExtType:
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
    raise TypeError(f"cannot export a leaf of type {type(x).__name__}")


def _ext_unpack(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _state_dict(tree: Any) -> Any:
    """flax's `to_state_dict` on plain containers, with MAX_CHUNK_SIZE
    chunking; tensors and numpy scalars become numpy arrays, as
    `jax.device_get` makes them before the JAX package exports."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(tree[k]) for k in sorted(tree, key=str)}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    elif isinstance(tree, np.generic):
        tree = np.asarray(tree)
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        size = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        return {
            _CHUNKED: True,
            "shape": {str(i): int(n) for i, n in enumerate(tree.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, flat.size, size))},
        }
    return tree


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def export_params(path: str | Path, tree: Any) -> None:
    """Write a params-only export (nested dicts of arrays) in flax's
    msgpack format, through a temporary file and a rename."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = msgpack.packb(_state_dict(tree), default=_ext_pack, strict_types=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def load_params(path: str | Path) -> Any:
    """Read a params-only export (the port's or the JAX package's) as the
    dict tree of numpy arrays, as `flax.serialization.msgpack_restore`
    returns it."""
    data = Path(path).read_bytes()
    return _unchunk(msgpack.unpackb(data, ext_hook=_ext_unpack, raw=False))


def find_epoch_files(directory: str | Path, pattern: str) -> list[tuple[int, Path]]:
    """(epoch, path) of the files named by a `{epoch}`-templated pattern,
    sorted by epoch (the reference's glob-and-parse, generator_output.py:
    55-59)."""
    directory = Path(directory)
    rx = re.compile("^" + re.escape(pattern).replace(re.escape("{epoch}"), r"(\d+)") + "$")
    out = []
    if directory.exists():
        for p in directory.iterdir():
            m = rx.match(p.name)
            if m:
                out.append((int(m.group(1)), p))
    return sorted(out)
