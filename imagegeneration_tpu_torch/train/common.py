"""Keras-form Adam state and the GAN losses.

The counterpart of imagegeneration_tpu/train/common.py. The Adam here is
tf.keras's, not `torch.optim.Adam`: eps sits outside the sqrt and the bias
correction rides in alpha = lr*sqrt(1-b2^t)/(1-b1^t), computed in float32
on the device from the step counter (ops/adam.py, whose CUDA kernel applies
every leaf of an apply in one launch). The moments share each parameter's
layout (channels_last for conv weights). Losses reduce in at least
float32. RMSprop waits for the WGAN slice.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from imagegeneration_tpu_torch.ops import adam as adam_op


@dataclasses.dataclass
class AdamState:
    """optax.ScaleByAdamState's fields: step count and the two moments, one
    float32 tensor per parameter, in the order of the parameter list."""

    count: torch.Tensor
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    # The Adam kernel's leaf table, built at the first apply on the card
    # (ops/adam.LeafTable); not part of the saved state.
    table: adam_op.LeafTable | None = dataclasses.field(default=None, repr=False,
                                                        compare=False)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, sd: dict) -> None:
        with torch.no_grad():
            self.count.copy_(sd["count"])
            for dst, src in zip(self.mu + self.nu, list(sd["mu"]) + list(sd["nu"])):
                dst.copy_(src)


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    device = params[0].device
    return AdamState(
        count=torch.zeros((), dtype=torch.int64, device=device),
        mu=[torch.zeros_like(p, memory_format=torch.preserve_format) for p in params],
        nu=[torch.zeros_like(p, memory_format=torch.preserve_format) for p in params],
    )


def adam_apply(
    params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
    state: AdamState, lr: float, b1: float = 0.9, b2: float = 0.999,
) -> None:
    """One Keras-form Adam step, in place on params and state: on the card
    one kernel launch over every leaf."""
    if state.table is None and params[0].device.type == "cuda":
        state.table = adam_op.LeafTable(params, state.mu, state.nu)
    adam_op.adam_apply(params, grads, state.mu, state.nu, state.count, lr, b1, b2,
                       table=state.table)


def _loss_dtype(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def bce_logits_mean(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Keras BinaryCrossentropy(from_logits=True), mean reduction, in the
    form of optax.sigmoid_binary_cross_entropy."""
    x = _loss_dtype(logits)
    z = labels.to(x.dtype)
    return torch.mean(-z * F.logsigmoid(x) - (1.0 - z) * F.logsigmoid(-x))


def hinge_d_loss_real(logits_real: torch.Tensor) -> torch.Tensor:
    """Real half of the SN-GAN hinge discriminator loss."""
    return torch.mean(torch.relu(1.0 - _loss_dtype(logits_real)))


def hinge_d_loss_fake(logits_fake: torch.Tensor) -> torch.Tensor:
    """Fake half of the SN-GAN hinge discriminator loss."""
    return torch.mean(torch.relu(1.0 + _loss_dtype(logits_fake)))


def hinge_g_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    return -torch.mean(_loss_dtype(logits_fake))
