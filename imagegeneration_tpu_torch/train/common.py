"""Keras-form Adam and RMSprop states and the GAN losses.

The counterpart of imagegeneration_tpu/train/common.py. The Adam here is
tf.keras's, not `torch.optim.Adam`: eps sits outside the sqrt and the bias
correction rides in alpha = lr*sqrt(1-b2^t)/(1-b1^t), computed in float32
on the device from the step counter (ops/adam.py, whose CUDA kernel applies
every leaf of an apply in one launch). RMSprop is optax's `rmsprop(lr,
decay=0.9, eps=1e-7)` (Keras defaults, WGAN), in plain multi-tensor torch
ops: the JAX package has no kernel for it. Optimizer states share each
parameter's layout (channels_last for conv weights). Losses reduce in at
least float32.

Data parallelism (a core.mesh.DataGroup passed as `group`): each rank's
loss is the mean over its own rows of the global batch, and both applies
average the gradients over the data blocks first (parallel/dp.
all_reduce_mean_, one all-reduce per apply: a sum over the world divided by
the data size), so every rank applies the global-batch gradient to its
replica of the state. `shard_rows` gives a step its rows, and
`global_draw` keeps a rank's rows of a draw made for the global batch.

float64 compute (the CPU parity tests against the JAX package's float64
step, whose parameters and optimizer states are float32): the leaves are
float64 tensors holding float32 values (`place`), so a gradient is
the float64 sum, averaged over the ranks in float64 and rounded to
float32 once, in the apply, as the JAX step rounds its float64 sum; the
optimizer states and arithmetic stay float32 (bfloat16 Adam moments stay
bfloat16, rounded as on the card: ops/adam.adam_leaf_plain).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from imagegeneration_tpu_torch.core import trace
from imagegeneration_tpu_torch.ops import adam as adam_op
from imagegeneration_tpu_torch.parallel import dp


def place(model: torch.nn.Module, device, compute_dtype: torch.dtype) -> None:
    """Move `model` to `device`; for float64 compute its parameters become
    float64 tensors holding the same (float32) values. Buffers (BatchNorm
    statistics, spectral-norm `u`) keep their dtype."""
    model.to(device)
    if compute_dtype == torch.float64:
        for prm in model.parameters():
            prm.data = prm.data.double()


def _float32_apply(apply, params, grads, *args, **kwargs) -> None:
    """Run a float32 optimizer `apply` on float64 leaves that hold float32
    values: on float32 copies, written back."""
    p32 = [p.detach().float() for p in params]
    g32 = [None if g is None else g.float() for g in grads]
    apply(p32, g32, *args, **kwargs)
    with torch.no_grad():
        torch._foreach_copy_([p.data for p in params], p32)


def shard_rows(group, local_batch: int) -> tuple[int, int]:
    """(first global row, global batch) of this rank's `local_batch` rows
    (its data block; spatial peers hold the same rows); (0, local_batch)
    without a group."""
    if group is None:
        return 0, local_batch
    return group.d * local_batch, group.data * local_batch


def global_draw(t: torch.Tensor, rows: tuple[int, int], local_batch: int) -> torch.Tensor:
    """This rank's rows of `t`, a draw (or an input) over the global batch."""
    first, global_batch = rows
    if t.shape[0] != global_batch:
        raise ValueError(f"a global draw has {global_batch} rows, got {t.shape[0]}")
    return t[first:first + local_batch]


def reduce_grads(grads, group):
    """The ranks' mean of each gradient (in place), or `grads` as they are."""
    return grads if group is None else dp.all_reduce_mean_(grads, group)


@dataclasses.dataclass
class AdamState:
    """optax.ScaleByAdamState's fields: step count and the two moments, one
    tensor per parameter (float32, or bfloat16 with `opt_moments="bf16"`),
    in the order and layout of the parameter list."""

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


def adam_init(params: Sequence[torch.Tensor],
              moment_dtype: torch.dtype = torch.float32) -> AdamState:
    """Zero moments of `moment_dtype` (float32 or bfloat16), each in its
    parameter's layout."""
    device = params[0].device

    def zeros():
        return [torch.zeros_like(p, dtype=moment_dtype, memory_format=torch.preserve_format)
                for p in params]

    return AdamState(count=torch.zeros((), dtype=torch.int64, device=device),
                     mu=zeros(), nu=zeros())


def adam_apply(
    params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
    state: AdamState, lr: float, b1: float = 0.9, b2: float = 0.999,
    group=None,
) -> None:
    """One Keras-form Adam step, in place on params and state: on the card
    one kernel launch over every leaf. With a group, the gradients are
    first averaged over the ranks. One `train.apply` span."""
    with trace.span("train.apply"):
        grads = reduce_grads(grads, group)
        if params[0].dtype == torch.float64:
            return _float32_apply(adam_apply, params, grads, state, lr, b1, b2)
        if state.table is None and params[0].device.type == "cuda":
            state.table = adam_op.LeafTable(params, state.mu, state.nu)
        adam_op.adam_apply(params, grads, state.mu, state.nu, state.count, lr, b1, b2,
                           table=state.table)


@dataclasses.dataclass
class RMSpropState:
    """optax.ScaleByRmsState's field (optax keeps no count for RMSprop): the
    running mean of g^2, one float32 tensor per parameter, in the order of
    the parameter list."""

    nu: list[torch.Tensor]

    def state_dict(self) -> dict:
        return {"nu": self.nu}

    def load_state_dict(self, sd: dict) -> None:
        with torch.no_grad():
            for dst, src in zip(self.nu, sd["nu"], strict=True):
                dst.copy_(src)


def rmsprop_init(params: Sequence[torch.Tensor]) -> RMSpropState:
    return RMSpropState(
        nu=[torch.zeros_like(p, dtype=torch.float32, memory_format=torch.preserve_format)
            for p in params])


@torch.no_grad()
def rmsprop_apply(
    params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor | None],
    state: RMSpropState, lr: float, decay: float = 0.9, eps: float = 1e-7,
    group=None,
) -> None:
    """One RMSprop step, in place, in the float operations of optax's
    scale_by_rms(eps_in_sqrt=True) then scale_by_learning_rate:

        nu = (1 - decay) * g*g + decay * nu;  p = p + (-lr) * (rsqrt(nu + eps) * g)

    A None gradient is a zero one (the frozen leaves of a masked update):
    its nu decays, nu = decay * nu, which is what the formula gives exactly
    for g = 0, and its parameter keeps every bit (p + (-lr * 0) = p). With a
    group, the gradients are first averaged over the ranks. One
    `train.apply` span."""
    with trace.span("train.apply"):
        grads = reduce_grads(grads, group)
        if params and params[0].dtype == torch.float64:
            return _float32_apply(rmsprop_apply, params, grads, state, lr, decay, eps)
        live = [i for i, g in enumerate(grads) if g is not None]
        frozen = [state.nu[i] for i, g in enumerate(grads) if g is None]
        if frozen:
            torch._foreach_mul_(frozen, decay)
        if not live:
            return
        p = [params[i] for i in live]
        g = [grads[i] for i in live]
        nu = [state.nu[i] for i in live]
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1.0 - decay)
        torch._foreach_mul_(nu, decay)
        torch._foreach_add_(nu, g2)
        u = torch._foreach_add(nu, eps)
        torch._foreach_rsqrt_(u)
        torch._foreach_mul_(u, g)
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(p, u)


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


def wasserstein_loss(labels: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """mean(y_true * y_pred) (wasserstein_gan/WGAN.py:48-49), in >= float32."""
    x = _loss_dtype(preds)
    return torch.mean(labels.to(x.dtype) * x)
