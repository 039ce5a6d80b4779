"""Initial weights made from the run's seed, on the device, in two draws.

Every leaf a reference names in its `param_specs` gets its values here, and
the same tensors go to the program (copied into its parameters) and to the
reference (which clones them): the program's own initialisation is
overwritten, so the two sides start from one state. One uniform draw and
one normal draw on a device generator cover all the leaves; each leaf is a
slice of them, scaled by its rule:

- ("glorot", fan_in, fan_out): U(-limit, limit), limit = sqrt(6 / (fan_in + fan_out));
- "uniform005": U(-0.05, 0.05) (Keras's random_uniform);
- "unit": a normal vector scaled to length 1 (a spectral-norm vector);
- "ones", "zeros": constants.
"""

from __future__ import annotations

import math

import torch

_UNIFORM = ("glorot", "uniform005")


def _kind(init) -> str:
    return init[0] if isinstance(init, tuple) else init


def make(specs: list[tuple], seed: int, device) -> dict[str, torch.Tensor]:
    """{name: float32 tensor} for (name, shape, init, trainable) specs."""
    device = torch.device(device)
    sizes = {name: math.prod(shape) for name, shape, _, _ in specs}
    n_uniform = sum(sizes[n] for n, _, init, _ in specs if _kind(init) in _UNIFORM)
    n_normal = sum(sizes[n] for n, _, init, _ in specs if _kind(init) == "unit")
    if device.type == "meta":
        return {name: torch.empty(shape, device=device) for name, shape, _, _ in specs}
    gen = torch.Generator(device=device).manual_seed(seed)
    uniform = torch.rand(n_uniform, generator=gen, device=device).mul_(2.0).sub_(1.0)
    normal = torch.randn(n_normal, generator=gen, device=device)
    out, iu, inn = {}, 0, 0
    for name, shape, init, _ in specs:
        n, kind = sizes[name], _kind(init)
        if kind == "glorot":
            out[name] = uniform[iu:iu + n].view(shape) * math.sqrt(6.0 / (init[1] + init[2]))
            iu += n
        elif kind == "uniform005":
            out[name] = uniform[iu:iu + n].view(shape) * 0.05
            iu += n
        elif kind == "unit":
            v = normal[inn:inn + n]
            out[name] = (v / torch.linalg.vector_norm(v)).view(shape)
            inn += n
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
    return out
