"""The InstanceNorm kernels' launch plan (ops/instance_norm.launch_plan), on CPU.

The kernels only check the plan they are given (and refuse a bad one with
a CUDA invalid-value error), so the plan's invariants are held here: at the
seven norm shapes of the headline CycleGAN step (chip_smoke.IN_SHAPES) and
at ragged shapes, in float32 and bfloat16, for the forward (one input
tensor) and the backward (x and dy). The split norm's apply passes take
their own plan (`apply_plan`), held at the generator's half-height shards
(chip_smoke.IN_SPLIT_SHAPES) and the ragged shapes.
"""

import pytest
import torch

from imagegeneration_tpu_torch.ops import instance_norm as inorm

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
    none of them empty (what the source's check_apply_plan refuses)."""
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
