"""Port Keras-form Adam (plain version of the CUDA kernel) vs the JAX apply.

The JAX side is `train/common.adam_apply(..., fused="interpret")`: its
lane-aligned >= 1M-element leaf goes through the Pallas Adam kernel in
interpret mode, the others through the XLA formula. The port's CPU path is
`ops/adam.adam_leaf_plain`, which evaluates the same float32 expressions
as its CUDA kernel (one launch per apply on the card; its launch plan is
tested in tests/test_torch_adam_plan.py). Bound: 2 ulp per element on p, m and v after every
step, counted in ulps of the largest operand of the last add (|p| and the
update for p; b1*m and (1-b1)*g for m; b2*v and (1-b2)*g*g for v). XLA
may contract a*b+c into one FMA (ops/pallas/adam.py:29-39), which moves a
result by up to an ulp of its operands -- and, where the add cancels, by
many ulps of the (small) result. count exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagegeneration_tpu.ops.pallas.adam import leaf_eligible
from imagegeneration_tpu.train import common as jcommon
from imagegeneration_tpu_torch.ops import adam as tadam
from imagegeneration_tpu_torch.train import common as tcommon

torch.set_num_threads(1)


def _ulp_distance(a, b):
    """|a - b| in units in the last place of float32 (0 for +0 vs -0)."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(key(a) - key(b))


def _within_ulps(got, want, *operands, n=2):
    """|got - want| <= n ulp of the largest of `operands` and `want`."""
    scale = np.maximum.reduce([np.abs(np.asarray(x, np.float32))
                               for x in (want, *operands)])
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return err <= n * np.spacing(scale).astype(np.float64)


@pytest.mark.parametrize("lr,b1,b2", [(2e-4, 0.9, 0.999), (1e-3, 0.5, 0.999)])
def test_plain_apply_within_two_ulp_of_jax(lr, b1, b2):
    rng = np.random.default_rng(0)
    shapes = {"stem": (1024, 1024), "bias": (512,), "odd": (7, 13), "conv": (3, 3, 4, 8)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    assert leaf_eligible(jnp.asarray(params["stem"]), jnp.asarray(params["stem"]))

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jcommon.adam(lr, b1=b1, b2=b2).init(jp)
    keys = sorted(shapes)
    tp = [torch.from_numpy(params[k].copy()) for k in keys]
    ts = tcommon.adam_init(tp)
    for step in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32) * 10.0**-step
                 for k, s in shapes.items()}
        prev = {k: (np.asarray(jp[k]), np.asarray(js.mu[k]), np.asarray(js.nu[k]))
                for k in keys}
        # Each step starts both sides from the same state, so that the bound
        # is per apply and the steps differ only in count (bias correction).
        for i, k in enumerate(keys):
            for dst, src in zip((tp[i], ts.mu[i], ts.nu[i]), prev[k]):
                dst.copy_(torch.from_numpy(np.array(src)))
        jp, js = jcommon.adam_apply(
            jp, {k: jnp.asarray(v) for k, v in grads.items()}, js,
            learning_rate=lr, b1=b1, b2=b2, fused="interpret",
        )
        tcommon.adam_apply(tp, [torch.from_numpy(grads[k]) for k in keys], ts, lr, b1, b2)
        assert int(ts.count) == int(js.count) == step + 1
        for i, k in enumerate(keys):
            p0, m0, v0 = prev[k]
            g = grads[k]
            want_p = np.asarray(jp[k])
            operands = {
                "p": (p0, want_p - p0),
                "m": (np.float32(b1) * m0, np.float32(1.0 - b1) * g),
                "v": (np.float32(b2) * v0, np.float32(1.0 - b2) * g * g),
            }
            for name, got, want in (("p", tp[i], jp[k]), ("m", ts.mu[i], js.mu[k]),
                                    ("v", ts.nu[i], js.nu[k])):
                ok = _within_ulps(got.numpy(), np.asarray(want), *operands[name])
                assert ok.all(), f"step {step} {name}[{k}]: {(~ok).sum()} beyond 2 ulp"


def test_alpha_on_device_tensor():
    count = torch.tensor(3, dtype=torch.int64)
    alpha = tadam.adam_alpha(count, 2e-4, 0.9, 0.999)
    t = jnp.float32(3)
    want = 2e-4 * jnp.sqrt(1.0 - 0.999**t) / (1.0 - 0.9**t)
    assert alpha.dtype == torch.float32 and alpha.shape == (1,)
    assert _ulp_distance(alpha.numpy(), np.asarray([want])).max() <= 2


def test_apply_rejects_mismatched_lists():
    p = [torch.zeros(3)]
    with pytest.raises(ValueError):
        tadam.adam_apply(p, [], [torch.zeros(3)], [torch.zeros(3)],
                         torch.zeros((), dtype=torch.int64), 1e-3)


def test_adam_init_moments_share_param_layout():
    """m and v take each leaf's layout: channels_last conv weights keep
    channels_last moments, so the kernel walks p, g, m, v in one order."""
    params = [torch.zeros(8, 4, 3, 3).contiguous(memory_format=torch.channels_last),
              torch.zeros(4, 8, 4, 4).contiguous(memory_format=torch.channels_last),
              torch.zeros(16, 1, 1, 3).contiguous(memory_format=torch.channels_last),
              torch.zeros(5, 7), torch.zeros(9)]
    state = tcommon.adam_init(params)
    for p, m, v in zip(params, state.mu, state.nu):
        assert m.stride() == v.stride() == p.stride()
        assert m.shape == v.shape == p.shape
    assert state.table is None  # built at the first apply on the card


@pytest.mark.parametrize("lr,b1,b2", [(2e-4, 0.9, 0.999), (1e-3, 0.5, 0.999)])
def test_plain_apply_within_two_ulp_of_jax_channels_last(lr, b1, b2):
    """Conv leaves laid out channels_last (as the port's layers make them),
    one gradient in the other layout: the same values as the JAX apply,
    each leaf compared by its logical index, and no layout copy on the CPU."""
    rng = np.random.default_rng(1)
    shapes = {"conv": (8, 4, 3, 3), "convT": (4, 8, 4, 4), "bias": (8,)}
    cl = {"conv", "convT"}
    keys = sorted(shapes)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jcommon.adam(lr, b1=b1, b2=b2).init(jp)

    def torch_leaf(k, a, channels_last):
        t = torch.from_numpy(np.array(a))
        return t.contiguous(memory_format=torch.channels_last) if channels_last else t

    tp = [torch_leaf(k, params[k], k in cl) for k in keys]
    ts = tcommon.adam_init(tp)
    copies = dict(tadam.GRAD_COPIES)
    for step in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        prev = {k: (np.asarray(jp[k]), np.asarray(js.mu[k]), np.asarray(js.nu[k]))
                for k in keys}
        for i, k in enumerate(keys):
            for dst, src in zip((tp[i], ts.mu[i], ts.nu[i]), prev[k]):
                dst.copy_(torch.from_numpy(np.array(src)))
        jp, js = jcommon.adam_apply(
            jp, {k: jnp.asarray(v) for k, v in grads.items()}, js,
            learning_rate=lr, b1=b1, b2=b2, fused="interpret",
        )
        # "conv"'s gradient arrives contiguous, "convT"'s channels_last.
        tg = [torch_leaf(k, grads[k], k == "convT") for k in keys]
        tcommon.adam_apply(tp, tg, ts, lr, b1, b2)
        for i, k in enumerate(keys):
            assert tp[i].stride() == ts.mu[i].stride() == ts.nu[i].stride()
            p0, m0, v0 = prev[k]
            g = grads[k]
            want_p = np.asarray(jp[k])
            operands = {
                "p": (p0, want_p - p0),
                "m": (np.float32(b1) * m0, np.float32(1.0 - b1) * g),
                "v": (np.float32(b2) * v0, np.float32(1.0 - b2) * g * g),
            }
            for name, got, want in (("p", tp[i], jp[k]), ("m", ts.mu[i], js.mu[k]),
                                    ("v", ts.nu[i], js.nu[k])):
                ok = _within_ulps(got.numpy(), np.asarray(want), *operands[name])
                assert ok.all(), f"step {step} {name}[{k}]: {(~ok).sum()} beyond 2 ulp"
    assert tadam.GRAD_COPIES == copies  # the plain version takes any layout
    assert ts.table is None


def test_leaf_table_is_for_the_card():
    """The kernel's leaf table refuses CPU tensors (the CPU takes the plain
    version) and an empty list (no launch without leaves)."""
    p = [torch.zeros(3)]
    with pytest.raises(ValueError, match="CUDA"):
        tadam.LeafTable(p, [torch.zeros(3)], [torch.zeros(3)])
    with pytest.raises(ValueError, match="non-empty"):
        tadam.LeafTable([], [], [])
