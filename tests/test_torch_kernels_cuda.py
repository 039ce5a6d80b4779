"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test skips where no CUDA device is visible (the CPU
test run). On a machine with an H100 and nvcc, run them with

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_cuda.py -q

(`--noconftest`: tests/conftest.py imports jax, which the GPU machine
lacks.) Bounds: the dropout kernels are bit-identical to their plain
versions (same float32 products, one rounding to the storage dtype; the
mask is integer arithmetic), and so is Adam (explicitly rounded float32
operations in both). The shapes include odd, non-power-of-two extents so
that the grid-stride tail is exercised.
"""

import pytest
import torch

from imagegeneration_tpu_torch.models.sndcgan import SNDCGANConfig
from imagegeneration_tpu_torch.ops import adam, dropout
from imagegeneration_tpu_torch.train import sndcgan_step as steplib

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (3, 64, 17, 33), (1, 512, 18, 32)])
@pytest.mark.parametrize("rate", [0.5, 0.1])
def test_dropout_kernels_equal_plain(cuda, dtype, shape, rate):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    g = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    g = g.contiguous(memory_format=torch.channels_last)
    kw = torch.tensor([0x9E3779B9, 0x7F4A7C15], device=cuda)
    cut = dropout.dropout_cut(rate)
    before = dict(dropout.LAUNCHES)
    y = dropout.leaky_relu_dropout(x, kw, rate)
    y.backward(g)
    assert dropout.LAUNCHES["leaky_relu_dropout_fwd"] == before["leaky_relu_dropout_fwd"] + 1
    assert dropout.LAUNCHES["leaky_relu_dropout_bwd"] == before["leaky_relu_dropout_bwd"] + 1
    assert y.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(
        y, dropout.fwd_plain(x.detach(), kw, cut), rtol=0, atol=0)
    torch.testing.assert_close(
        x.grad, dropout.bwd_plain(x.detach(), g, kw, cut),
        rtol=0, atol=0)


def test_dropout_kernel_refuses_nchw_and_bad_keys(cuda):
    x = torch.randn(2, 8, 3, 5, device=cuda)
    kw = torch.tensor([1, 2], device=cuda)
    with pytest.raises(ValueError, match="channels_last"):
        dropout.leaky_relu_dropout(x, kw, 0.5)
    # The kernel entry points check the layout themselves, for callers that
    # reach them without the autograd wrapper.
    with pytest.raises(ValueError, match="channels_last"):
        dropout.fwd_kernel(x, kw, 128)
    with pytest.raises(ValueError, match="channels_last"):
        dropout.bwd_kernel(x, x.contiguous(memory_format=torch.channels_last), kw, 128)
    x = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="kw"):
        dropout.leaky_relu_dropout(x, kw.cpu(), 0.5)  # keys on the CPU


@pytest.mark.parametrize("n", [1, 1000, 4097, 1 << 20])
def test_adam_kernel_equals_plain(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    p, g, m = (torch.randn(n, generator=gen, device=cuda) for _ in range(3))
    v = torch.rand(n, generator=gen, device=cuda)
    alpha = adam.adam_alpha(torch.tensor(2, device=cuda), 1e-3, 0.9, 0.999)
    pk, mk, vk = p.clone(), m.clone(), v.clone()
    adam.adam_leaf_kernel(pk, g, mk, vk, alpha, 0.9, 0.999)
    adam.adam_leaf_plain(p, g, m, v, alpha, 0.9, 0.999)
    for a, b in ((pk, p), (mk, m), (vk, v)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_small_step_on_card_matches_cpu(cuda):
    """Two float32 steps (TF32 off) from the same weights, z and key words:
    the card's step (kernels, cuDNN) within 1e-3 of the CPU's (plain)."""
    cfg = steplib.SNDCGANTrainConfig(
        model=SNDCGANConfig(image_size=(16, 24, 3), base_width=16, spectral_norm=True),
        batch_size=4, loss="hinge")
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    batch = torch.randint(0, 256, (4, 16, 24, 3), generator=gen, dtype=torch.uint8)
    z = torch.rand((4, 128), generator=gen) * 2 - 1
    kw = torch.randint(0, 2**32, (steplib.N_SITES, 2), generator=gen)
    out = []
    for dev in (torch.device("cpu"), cuda):
        state = steplib.init_state(cfg, dev)
        step = steplib.make_train_step(cfg)
        for _ in range(2):
            state, m = step(state, batch.to(dev), z.to(dev), kw.to(dev))
        out.append(({k: float(v) for k, v in m.items()},
                    [p.detach().cpu() for p in state.gen.parameters()]))
    (m_cpu, p_cpu), (m_gpu, p_gpu) = out
    for k in m_cpu:
        assert m_gpu[k] == pytest.approx(m_cpu[k], rel=1e-3, abs=1e-4), k
    for a, b in zip(p_gpu, p_cpu):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
