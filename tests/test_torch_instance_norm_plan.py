"""The InstanceNorm kernels' launch plan (ops/instance_norm.launch_plan), on CPU.

The kernels only check the plan they are given (and refuse a bad one with
a CUDA invalid-value error), so the plan's invariants are held here: at the
seven norm shapes of the headline CycleGAN step (chip_smoke.IN_SHAPES) and
at ragged shapes, in float32 and bfloat16, for the forward (one input
tensor) and the backward (x and dy). The split norm's passes take plain
grids: the applies `apply_plan`, the forward partial `fwd_partial_plan`,
the backward partial `bwd_partial_plan` (the single-pass backward's CTAs),
held at the generator's half-height shards (chip_smoke.IN_SPLIT_SHAPES)
and the ragged shapes. Beside them, the library call that chip_smoke.py
times beside the backward partial (tools/split_times.library_bwd_partial)
is held to the plain partial's sums.
"""

import pytest
import torch

from imagegeneration_tpu_torch.ops import instance_norm as inorm
from imagegeneration_tpu_torch.tools import split_times

CYCLEGAN_SHAPES = [(4, 64, 128, 128), (4, 128, 64, 64), (4, 256, 32, 32), (4, 3, 128, 128),
                   (4, 128, 30, 30), (4, 256, 14, 14), (4, 512, 6, 6)]
RAGGED_SHAPES = [(2, 3, 5, 7), (2, 40, 9, 11), (1, 64, 129, 131), (2, 6, 17, 33),
                 (3, 64, 40, 45), (1, 8, 1, 1)]
SPLIT_SHAPES = [(4, 64, 64, 128), (4, 128, 32, 64), (4, 256, 16, 32), (4, 3, 64, 128)]
SMEM_PER_CTA = 232448  # the H100's 227 KB of shared memory a CTA can use
ELEMENT_SIZE = {torch.float32: 4, torch.bfloat16: 2}


@pytest.mark.parametrize("tensors", [1, 2], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", CYCLEGAN_SHAPES + RAGGED_SHAPES, ids=str)
def test_launch_plan_invariants(shape, dtype, tensors):
    b, c, h, w = shape
    hw, esize = h * w, ELEMENT_SIZE[dtype]
    plan = inorm.launch_plan(b, c, h, w, dtype, tensors)
    # The 16-byte path exactly when C is a multiple of 16 bytes of channels.
    assert (plan.vec > 1) == (c % (16 // esize) == 0)
    assert plan.vec in (1, 16 // esize)
    cb = plan.channel_block
    assert cb % plan.vec == 0 and cb <= inorm.CHANNEL_BLOCK
    assert plan.blocks == -(-c // cb)
    if plan.vec > 1:  # blocks tile C; a warp holds whole row segments
        assert c % cb == 0 and 32 % (cb // plan.vec) == 0
    # Clusters of at most 16 CTAs that divide the grid.
    assert 1 <= plan.cluster <= 16
    assert plan.ctas == b * plan.blocks * plan.cluster
    assert plan.ctas % plan.cluster == 0
    # Every CTA gets at least one row, and the rows are covered.
    assert plan.rows * plan.cluster >= hw
    assert plan.rows * (plan.cluster - 1) < hw
    # Whole held slices, within the CTA's shared memory.
    assert 0 <= plan.held <= tensors
    assert plan.smem_bytes == plan.held * plan.rows * cb * esize
    assert plan.smem_bytes <= inorm.SMEM_LIMIT < SMEM_PER_CTA


@pytest.mark.parametrize("tensors", [1, 2], ids=["fwd", "bwd"])
@pytest.mark.parametrize("shape", CYCLEGAN_SHAPES[:3], ids=str)
def test_launch_plan_fills_the_card(shape, tensors):
    """The three largest norm shapes run at least 128 CTAs (the H100 has
    132 SMs)."""
    assert inorm.launch_plan(*shape, torch.float32, tensors).ctas >= 128


def test_launch_plan_scalar_path_for_three_channels():
    """The C = 3 norm before the tanh takes the scalar path, split over a
    16-CTA cluster per sample instead of one CTA per sample."""
    plan = inorm.launch_plan(4, 3, 128, 128, torch.float32, 1)
    assert plan.vec == 1 and plan.channel_block == 3 and plan.cluster == 16
    assert plan.ctas == 64


def test_launch_plan_overrides():
    """The tuning tool's overrides: channel block, cluster and held slices."""
    plan = inorm.launch_plan(4, 64, 40, 45, torch.float32, 2, channel_block=16, cluster=8,
                             held=1)
    assert (plan.channel_block, plan.blocks, plan.cluster) == (16, 4, 8)
    assert plan.rows == 225 and plan.held == 1
    assert plan.smem_bytes == 225 * 16 * 4
    assert plan.args() == [16, 4, 8, 225, 225 * 16 * 4]
    assert inorm.launch_plan(4, 64, 40, 45, torch.float32, 1, held=2).held == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES + RAGGED_SHAPES, ids=str)
def test_apply_plan_invariants(shape, dtype):
    """The apply passes: the single-pass kernels' vec and channel block, and
    row chunks of APPLY_UNROLL rows per thread that cover each sample's rows,
    none of them empty (what the source's check_grid_plan refuses)."""
    b, c, h, w = shape
    plan = inorm.apply_plan(b, c, h, w, dtype)
    base = inorm.launch_plan(b, c, h, w, dtype, 1)
    assert (plan.vec, plan.blocks) == (base.vec, -(-c // plan.channel_block))
    assert plan.channel_block % plan.vec == 0 and plan.channel_block <= inorm.CHANNEL_BLOCK
    if plan.vec > 1:
        assert c % plan.channel_block == 0
    assert plan.rows == 256 // (plan.channel_block // plan.vec) * inorm.APPLY_UNROLL
    assert plan.rows * plan.chunks >= h * w > plan.rows * (plan.chunks - 1)
    assert plan.ctas == b * plan.blocks * plan.chunks
    assert plan.args() == [plan.channel_block, plan.vec, plan.chunks, plan.rows]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES + RAGGED_SHAPES, ids=str)
def test_fwd_partial_plan_invariants(shape, dtype):
    """The forward partial: chunks whose rows every thread holds in HOLD
    registers, covering each sample's rows with none empty, cut as the
    apply's merge counts them (chunk_counts); a warp holds whole row
    segments on the 16-byte path (its CTA reduces by shuffles); at the
    generator's shards at least MIN_CTAS CTAs (the H100 has 132 SMs)."""
    b, c, h, w = shape
    plan = inorm.fwd_partial_plan(b, c, h, w, dtype)
    base = inorm.launch_plan(b, c, h, w, dtype, 1, cluster=1)  # the widest block
    lanes = plan.channel_block // plan.vec
    assert (plan.vec, plan.channel_block, plan.blocks) == (base.vec, base.channel_block,
                                                           base.blocks)
    assert plan.rows <= (256 // lanes) * inorm.HOLD
    assert plan.rows * plan.chunks >= h * w > plan.rows * (plan.chunks - 1)
    assert inorm.chunk_counts(h * w, plan.chunks) == [
        min(plan.rows, h * w - j * plan.rows) for j in range(plan.chunks)]
    if plan.vec > 1:
        assert 32 % lanes == 0
    if shape in SPLIT_SHAPES:
        assert plan.ctas >= inorm.MIN_CTAS
    assert plan.ctas == b * plan.blocks * plan.chunks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES + RAGGED_SHAPES, ids=str)
def test_bwd_partial_plan_is_the_single_pass_backward_grid(shape, dtype):
    """The backward partial's chunks are the single-pass backward's cluster
    CTAs, each launched on its own: one shard then sums in that kernel's
    order."""
    b, c, h, w = shape
    plan = inorm.bwd_partial_plan(b, c, h, w, dtype)
    base = inorm.launch_plan(b, c, h, w, dtype, 2)
    assert (plan.vec, plan.channel_block, plan.blocks, plan.chunks, plan.rows) == (
        base.vec, base.channel_block, base.blocks, base.cluster, base.rows)


@pytest.mark.parametrize("shape", [(2, 8, 4, 16), (2, 3, 6, 5), (1, 40, 9, 11)], ids=str)
def test_library_call_beside_the_backward_partial_computes_its_sums(shape):
    """native_batch_norm_backward (output_mask F, T, T) on the (1, B*C, h, W)
    view, times gamma, is in_bwd_partial_plain's sums without ReLU, in
    float64 to gamma's float32 cast (rtol 1e-6); the names match the
    kernels' launch counters."""
    assert split_times.NAMES == tuple(inorm.SPLIT_LAUNCHES)
    gen = torch.Generator().manual_seed(sum(shape))
    cl = torch.channels_last
    x = (2 + 3 * torch.randn(shape, generator=gen, dtype=torch.float64)).contiguous(
        memory_format=cl)
    dy = torch.randn(shape, generator=gen, dtype=torch.float64).contiguous(memory_format=cl)
    gamma = 1 + 0.1 * torch.randn(shape[1], generator=gen, dtype=torch.float64)
    beta = 0.1 * torch.randn(shape[1], generator=gen, dtype=torch.float64)
    parts = torch.stack([inorm.in_fwd_partial_plain(x, 2)] * 2)
    _, mean, rstd = inorm.in_fwd_apply_plain(x, parts, gamma, beta, split_times.EPS, False)
    got = split_times.library_partial_sums(
        split_times.library_bwd_partial(x, dy, gamma, mean, rstd)(), gamma)
    want = inorm.in_bwd_partial_plain(x, dy, gamma, beta, mean, rstd, False)[0]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
