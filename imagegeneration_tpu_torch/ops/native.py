"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface (raw pointers, sizes and
the CUDA stream; every entry point returns `cudaGetLastError()`). It is
compiled on first use by `nvcc` straight into a shared library and loaded
with `ctypes`, so the build needs neither ninja nor PyTorch's C++ headers
(`build_all` starts one nvcc per source at once):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o csrc/build/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded. Nothing here runs at
import time: the CPU-only test environment has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def _start(name: str) -> tuple[Path, Path, list[str], subprocess.Popen, float] | None:
    """Start nvcc for `csrc/<name>.cu` unless its hashed library exists."""
    out = library_path(name)
    if out.exists():
        BUILD_LOG.setdefault(name, {"seconds": 0.0, "log": "", "cached": True})
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, tmp, cmd, proc, time.perf_counter()


def _finish(name: str, started) -> str | None:
    """Wait for one nvcc; the error report if it failed."""
    out, tmp, cmd, proc, t0 = started
    log, _ = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        return f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{' '.join(cmd)}\n{log}"
    os.replace(tmp, out)
    BUILD_LOG[name] = {"seconds": seconds, "log": log, "cached": False}
    return None


def build_all(names: list[str]) -> None:
    """Compile several sources at once: one nvcc process each, all started
    together, then waited for."""
    started = {name: _start(name) for name in names}
    errors = [e for name, s in started.items() if s is not None
              for e in [_finish(name, s)] if e is not None]
    if errors:
        raise RuntimeError("\n\n".join(errors))


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its hashed library already exists."""
    build_all([name])
    return library_path(name)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu` once per process."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, error_fn: str, rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if rc != 0:
        fn = getattr(lib, error_fn)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {rc}: {fn(rc).decode()}")


_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def tickets(device: torch.device, stream: torch.cuda.Stream, n: int) -> torch.Tensor:
    """The ticket counters of the kernels whose last CTA of a block adds
    the others' partials (InstanceNorm's backward, BatchNorm's statistics
    and reduce passes), one buffer per stream. They start at 0 and every
    launch leaves them at 0 (atomicInc wraps at the number of CTAs that
    take a ticket), so one zeroed buffer serves every call on the stream."""
    key = (device.index, stream.cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
    return t


H100_SXM_SMS = 132  # a launch plan's SM count where no card is given (tools, tests)


@functools.cache
def sm_count(index: int) -> int:
    """The SMs of CUDA device `index`, read once per device (the dropout and
    BatchNorm launch plans)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
