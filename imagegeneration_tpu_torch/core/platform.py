"""Device selection and the facts printed beside every measured number.

The port's main path runs on CUDA cards and never falls back to the CPU:
`require_cuda()` raises when no card is visible. A process takes the card
of its local rank (`LOCAL_RANK`, torchrun's variable; 0 when unset), so that
each data-parallel rank on a host has its own card, and raises when that
card does not exist. The CPU runs only where a caller asks for it by name
(tests, debugging), and there every kernel takes its plain PyTorch version.

Float32 numerics are pinned, not left to defaults: cuDNN runs float32
convolutions in TF32 unless told otherwise, which keeps about three decimal
digits. The JAX reference computes float32 convolutions in full float32, so
`configure_numerics()` turns TF32 off for both cuDNN and cuBLAS and returns
the setting so that callers can print it. bfloat16 compute is unaffected.
It also keeps cuDNN to deterministic algorithms, for training and the
offline tools alike: some of cuDNN's convolution algorithms (the backward
passes' among them) accumulate with atomics, so one float32 CycleGAN step
run twice from the same state differed by up to 2e-4 of a collection's
scale; the JAX step, and its samples, are bitwise stable from run to run.
`cudnn.benchmark` stays off: with it, the algorithm is chosen by timing,
so two processes could take different (each deterministic) algorithms.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import torch


def configure_numerics() -> dict[str, bool]:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return {
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.deterministic": torch.backends.cudnn.deterministic,
        "cudnn.benchmark": torch.backends.cudnn.benchmark,
    }


def local_rank() -> int:
    """This process's rank on its host (`LOCAL_RANK`; 0 when unset)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def require_cuda() -> torch.device:
    """The CUDA card of this process's local rank, made the current one;
    raises without a card, and when the rank's card does not exist."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device visible: the port's main path needs an NVIDIA "
            "GPU and has no CPU fallback"
        )
    index, count = local_rank(), torch.cuda.device_count()
    if index >= count:
        raise RuntimeError(
            f"local rank {index} needs card {index}, but {count} card(s) are "
            "visible: one card per data-parallel rank on a host"
        )
    configure_numerics()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def resolve_device(name: str) -> torch.device:
    """'cuda' -> require_cuda(); 'cpu' -> the CPU (plain kernel versions)."""
    if name == "cuda":
        return require_cuda()
    if name == "cpu":
        configure_numerics()
        return torch.device("cpu")
    raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")


def device_name(device: torch.device) -> str:
    """The card's name for a CUDA device, else 'cpu'."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def card_description() -> str:
    """`name, power.limit` of the first card as nvidia-smi reports it."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()
