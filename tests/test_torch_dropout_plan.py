"""The dropout kernels' launch plan (ops/dropout.launch_plan) on the CPU.

Both kernels (csrc/leaky_relu_dropout.cu) launch from this plan: 16-byte
vectors, `unroll` of them (of x, and of g in the backward) loaded before
any is hashed, over a (row, offset) grid, or the pass's scalar kernel.
`plan_for` makes the plan of a pass from its tensors (the forward's x, the
backward's x and g: every one 16-byte aligned for the vector path). The
plan is pure Python, so its choices and refusals are held here; so is the
kernels' index and hash arithmetic, emulated in numpy uint32 exactly as the
source writes it (the 2-D walk with no division, fmix32's first step folded
into the index and one xor a vector element, the keep test as a shifted
compare) against the plain version's mask (`hash_keep_mask`, itself held to
the JAX mask in tests/test_torch_dropout.py) at every element, and the
backward's float32 arithmetic on that walk against `bwd_plain`'s bits. The
card runs the kernels against the plain versions
(tests/test_torch_kernels_cuda.py, chip_smoke.py). No JAX here.
"""

import numpy as np
import pytest
import torch

from imagegeneration_tpu_torch.ops import dropout as tdrop

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
WAVE = tdrop.H100_SXM_SMS * tdrop.CTAS_PER_SM
H100_PCIE_SMS = 114
# The SNDCGAN headline's four dropout sites (B, C, H, W) and their launches
# a step (bench.py:241-248): 3, 6, 6 and 6.
HEADLINE = [(32, 64, 144, 256), (32, 128, 72, 128), (32, 256, 36, 64), (32, 512, 18, 32)]
# Config 5's sites (bench.py:360-411): 512x288, batch 16; a spatial rank of
# 2 holds image rows [0, H/2) or [H/2, H).
CONFIG5 = [(16, 64, 288, 512), (16, 128, 144, 256), (16, 256, 72, 128), (16, 512, 36, 64)]


def _numel(shape):
    return int(np.prod(shape))


def _shard(shape, s, spatial=2):
    """(local numel, rowmap) of image rows [s*H/spatial, (s+1)*H/spatial)."""
    b, c, h, w = shape
    hh = h // spatial
    return b * c * hh * w, (hh, h, s * hh, w * c)


# bf16 plans of the four headline sites: (unroll, CTAs), one trip each.
HEADLINE_PLANS = [(4, 9216), (2, 9216), (2, 4608), (2, 2304)]


def _empty(shape, dtype, offset=0):
    """A channels_last (B, C, H, W) tensor whose data starts `offset`
    elements into its storage (torch.empty: the pages are never touched)."""
    b, c, h, w = shape
    buf = torch.empty(b * c * h * w + offset, dtype=dtype)
    return buf[offset:].view(b, h, w, c).permute(0, 3, 1, 2)


def _plan(part, shape, dtype, base=0, hblock=None, offsets=(0, 0), sms=tdrop.H100_SXM_SMS):
    """The plan of `part` over a tensor of `shape` (x, and g in the
    backward, each `offsets` elements past a 16-byte boundary)."""
    x = _empty(shape, dtype, offsets[0])
    inputs = (x,) if part == "fwd" else (x, _empty(shape, dtype, offsets[1]))
    return tdrop.plan_for(x, inputs, base, hblock, sms)


def _single_trips(plan):
    """Each CTA of the plan covers one block of THREADS * unroll vectors of
    its row, and the blocks cover the row."""
    per = tdrop.THREADS * plan.unroll
    vectors = plan.row_len // plan.vec
    return (plan.ctas_x - 1) * per < vectors <= plan.ctas_x * per


@pytest.mark.parametrize("sms", [tdrop.H100_SXM_SMS, H100_PCIE_SMS])
@pytest.mark.parametrize("part", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("site", range(4))
def test_headline_sites_take_the_vector_path_in_single_trips(site, dtype, part, sms):
    """Either pass, on an H100 SXM (132 SMs) or PCIe (114): the SM count
    moves only the unroll's threshold."""
    shape = HEADLINE[site]
    plan = _plan(part, shape, dtype, sms=sms)
    vec = 16 // (2 if dtype == BF16 else 4)
    assert plan.path == "vector" and plan.vec == vec and plan.args()[0] == plan.unroll
    assert (plan.rows, plan.row_len, plan.tail) == (1, _numel(shape), 0)
    assert _single_trips(plan)
    deep = -(-(_numel(shape) // vec) // (tdrop.THREADS * 4))
    assert plan.unroll == (4 if deep >= tdrop.DEEP_WAVES * sms * tdrop.CTAS_PER_SM else 2)
    if dtype == BF16 and sms == tdrop.H100_SXM_SMS:
        assert (plan.unroll, plan.ctas) == HEADLINE_PLANS[site]
    assert plan.args() == [plan.unroll, plan.ctas_x]


@pytest.mark.parametrize("sms", [tdrop.H100_SXM_SMS, H100_PCIE_SMS])
@pytest.mark.parametrize("part", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("s", [0, 1])
@pytest.mark.parametrize("shape", CONFIG5)
def test_config5_shards_walk_rows_with_vectors(shape, s, dtype, part, sms):
    """Each batch row of an H-shard is one row of the grid, W*C*H/2 elements
    long, H*W*C apart in the global index, covered by single-trip CTAs as
    the whole map of as many elements would be, whatever rank's rows of the
    batch they are; for either pass, on 132 or 114 SMs."""
    b, c, h, w = shape
    numel, rowmap = _shard(shape, s)
    whole = tdrop.launch_plan(numel, dtype, sms=sms)
    local = (b, c, h // 2, w)
    for first_row in (0, b // 2):
        base = first_row * c * h * w
        plan = _plan(part, local, dtype, base, (s * (h // 2), h), sms=sms)
        assert plan == tdrop.launch_plan(numel, dtype, rowmap, True, base, sms=sms)
        assert plan.path == "vector" and plan.tail == 0 and _single_trips(plan)
        assert (plan.rows, plan.row_len) == (b, numel // b)
        assert (plan.unroll, plan.ctas) == (whole.unroll, whole.ctas)


@pytest.mark.parametrize("part", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (3, 64, 17, 33), (1, 3, 1, 1), (2, 13, 9, 11)])
def test_odd_widths(shape, dtype, part):
    """A whole odd-width map is one row: vectors and a scalar tail (or the
    scalar path below a vector). A shard of it takes vectors only where W*C
    is whole vectors."""
    numel = _numel(shape)
    plan = _plan(part, shape, dtype)
    vec = 8 if dtype == BF16 else 4
    if numel < vec:
        assert plan.path == "scalar" and (plan.vec, plan.unroll, plan.tail) == (1, 1, 0)
        assert plan.args() == [0, 1]
    else:
        assert plan.path == "vector" and plan.tail == numel % vec and plan.rows == 1
        assert plan.unroll == 2 and plan.ctas_x == -(-(numel // vec) // (256 * 2))
    b, c, h, w = shape
    if h > 1:
        sub = h - 1
        shard = _plan(part, (b, c, sub, w), dtype, 0, (1, h))
        want = "vector" if (w * c) % vec == 0 else "scalar"
        assert shard.path == want and shard.rows == b and shard.tail == 0


def test_a_view_off_16_bytes_takes_the_scalar_path():
    """A channels_last view that starts one element into its storage."""
    buf = torch.zeros(2 * 8 * 6 * 4 + 1, dtype=BF16)
    x = buf[1:].view(2, 6, 4, 8).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    aligned = x.data_ptr() % tdrop.VECTOR_BYTES == 0
    assert not aligned
    plan = tdrop.launch_plan(x.numel(), x.dtype, None, aligned)
    assert plan.path == "scalar" and plan.args()[0] == 0
    assert tdrop.launch_plan(x.numel(), x.dtype, None, True).path == "vector"


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("part,offsets", [("fwd", (1, 0)), ("bwd", (1, 0)), ("bwd", (0, 1)),
                                          ("bwd", (3, 3))])
def test_plan_for_a_view_off_16_bytes_takes_the_scalar_path(part, offsets, dtype):
    """`plan_for` on views that start elements into their storage: x, or in
    the backward g (autograd's `.contiguous(channels_last)` can hand on a
    view), or both."""
    shape = (2, 8, 6, 4)
    assert _empty(shape, dtype, offsets[0]).is_contiguous(memory_format=torch.channels_last)
    plan = _plan(part, shape, dtype, offsets=offsets)
    assert plan.path == "scalar" and plan.args()[0] == 0
    assert _plan(part, shape, dtype).path == "vector"


def test_an_index_base_off_the_vector_takes_the_scalar_path():
    """A data-parallel rank whose first global index is not a multiple of
    the vector (rows of 3 x 5 x 7 = 105 elements), for either pass."""
    assert tdrop.launch_plan(105, BF16, None, True, 105).path == "scalar"
    assert tdrop.launch_plan(105, BF16, None, True, 8 * 105).path == "vector"
    assert tdrop.launch_plan(2 * 105, F32, (1, 2, 1, 105)).path == "scalar"
    for part in ("fwd", "bwd"):
        assert _plan(part, (1, 3, 5, 7), BF16, 105).path == "scalar"
        assert _plan(part, (1, 3, 5, 7), BF16, 8 * 105).path == "vector"
        assert _plan(part, (2, 3, 1, 35), F32, 0, (1, 2)).path == "scalar"


def test_a_smaller_tensor_spreads_over_more_ctas():
    """Below DEEP_WAVES waves of CTAs at 4 vectors a thread, 2 a thread, so
    twice the CTAs; single trips either way."""
    deep = tdrop.DEEP_WAVES * WAVE * tdrop.THREADS * 4 * 8  # bf16 elements
    block = tdrop.THREADS * 4 * 8  # one CTA's elements at 4 vectors a thread
    big, small = tdrop.launch_plan(deep, BF16), tdrop.launch_plan(deep - block, BF16)
    assert (big.unroll, big.ctas) == (4, tdrop.DEEP_WAVES * WAVE)
    assert (small.unroll, small.ctas) == (2, 2 * (tdrop.DEEP_WAVES * WAVE - 1))
    tiny = tdrop.launch_plan(256 * 2 * 8 * 3, BF16)
    assert tiny.unroll == 2 and tiny.ctas_x == 3


def test_overrides():
    plan = tdrop.launch_plan(_numel(HEADLINE[0]), BF16, unroll=2, ctas_x=132)
    assert (plan.path, plan.unroll, plan.ctas_x) == ("vector", 2, 132)
    # the scalar path keeps one element a thread whatever the unroll
    assert tdrop.launch_plan(7, BF16, unroll=4).args() == [0, 1]


@pytest.mark.parametrize("kwargs,error", [
    (dict(numel=10, dtype=torch.float64), TypeError),
    (dict(numel=2**32, dtype=BF16), ValueError),
    (dict(numel=-1, dtype=BF16), ValueError),
    (dict(numel=100, dtype=BF16, rowmap=(3, 6, 0, 10)), ValueError),  # 100 % 30
    (dict(numel=60, dtype=BF16, rowmap=(3, 6, 4, 10)), ValueError),  # rows past H
    (dict(numel=60, dtype=BF16, rowmap=(0, 6, 0, 10)), ValueError),
    (dict(numel=65536 * 2, dtype=BF16, rowmap=(1, 2, 0, 2)), ValueError),  # rows > 65535
    (dict(numel=64, dtype=BF16, unroll=3), ValueError),
    (dict(numel=64, dtype=BF16, ctas_x=0), ValueError),
])
def test_refusals(kwargs, error):
    with pytest.raises(error):
        tdrop.launch_plan(**kwargs)


def test_an_empty_tensor_launches_one_scalar_cta():
    plan = tdrop.launch_plan(0, BF16)
    assert plan.path == "scalar" and plan.ctas == 1 and plan.row_len == 0


# ------------------------------------------------ the kernel's arithmetic
_U32 = np.uint64(0xFFFFFFFF)


def _u32(a):
    return np.asarray(a, np.uint64) & _U32


def _keep_bit(h, k1s, cuts):
    """keep_bit of the source on uint32 values held in uint64."""
    h = _u32(h * np.uint64(0x85EBCA6B))
    h = h ^ (h >> np.uint64(13))
    h = _u32(h * np.uint64(0xC2B2AE35))
    h = h ^ (h >> np.uint64(16))
    return _u32(h * np.uint64(1 << 24) + k1s) >= cuts


def _kernel_keep(plan, kw, cut, base, rowmap):
    """The keep bits the kernel computes at local offsets 0..numel-1,
    following its walk: row r at global index first + r * row_stride, each
    vector's first hash step a ^ (a >> 16) ^ kx xored with the element's
    place, the tail and the scalar path by the folded step per element."""
    k0, k1 = (np.uint64(int(k)) for k in kw)
    kx, k1s, cuts = k0 ^ (k0 >> np.uint64(16)), _u32(k1 << np.uint64(24)), np.uint64(cut << 24)
    h, h_global, h0, wc = rowmap or (1, 1, 0, plan.row_len)
    first = base + h0 * wc
    row_stride = h_global * wc if plan.rows > 1 else plan.row_len
    out = []
    for r in range(plan.rows):
        a0 = np.uint64(first + r * row_stride)
        if plan.path == "vector":
            vectors = plan.row_len // plan.vec
            a = a0 + np.arange(vectors, dtype=np.uint64) * np.uint64(plan.vec)
            h1 = a ^ (a >> np.uint64(16)) ^ kx
            j = np.arange(plan.vec, dtype=np.uint64)
            keep = _keep_bit(h1[:, None] ^ j[None, :], k1s, cuts).reshape(-1)
            idx = a0 + np.arange(vectors * plan.vec, plan.row_len, dtype=np.uint64)
        else:
            keep = np.zeros(0, bool)
            idx = a0 + np.arange(plan.row_len, dtype=np.uint64)
        tail = _keep_bit(idx ^ (idx >> np.uint64(16)) ^ kx, k1s, cuts)
        out.append(np.concatenate([keep, tail]))
    return np.concatenate(out)


# (what, local (B, C, H, W), rowmap, base): the walks both kernels take
WALKS = [
    ("whole", (2, 64, 6, 10), None, 0),
    ("whole, tail", (2, 3, 5, 7), None, 0),
    ("rank 1 of 2", (2, 16, 4, 6), None, 2 * 16 * 4 * 6),
    ("shard rows [3, 6) of 6", (2, 64, 3, 5), (3, 6, 3, 5 * 64), 0),
    ("shard of rank 1", (2, 64, 3, 5), (3, 6, 0, 5 * 64), 2 * 64 * 6 * 5),
    ("scalar shard", (2, 3, 2, 7), (2, 5, 1, 21), 0),
    ("scalar base", (1, 3, 5, 7), None, 105),
]


def _walk(case, dtype, rate):
    """(numel, kw, cut, plan, the keep bits of the kernels' walk)."""
    _, (b, c, h, w), rowmap, base = case
    numel = b * c * h * w
    kw = torch.from_numpy(np.random.default_rng(numel + base).integers(0, 2**32, 2))
    cut = tdrop.dropout_cut(rate)
    plan = tdrop.launch_plan(numel, dtype, rowmap, True, base)
    return numel, kw, cut, plan, _kernel_keep(plan, kw.tolist(), cut, base, rowmap)


@pytest.mark.parametrize("rate", [0.5, 0.1])
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("case", WALKS)
def test_kernel_walk_and_folded_hash_give_the_plain_mask(case, dtype, rate):
    _, _, rowmap, base = case
    numel, kw, cut, _, got = _walk(case, dtype, rate)
    want = tdrop.hash_keep_mask(kw, numel, cut, base, rowmap).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.mean() < 1


@pytest.mark.parametrize("rate", [0.5, 0.1])
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("case", WALKS)
def test_backward_walk_gives_the_plain_bits(case, dtype, rate):
    """The backward kernels' arithmetic on their walk (bwd_value: float32
    products rounded each, no FMA; keep ? (x >= 0 ? g*scale :
    (g*scale)*slope) : 0, stored rounded to nearest) gives bwd_plain's bits,
    at every element, in memory (NHWC) order, signed zeros included."""
    _, shape, rowmap, base = case
    numel, kw, cut, _, keep = _walk(case, dtype, rate)
    rng = np.random.default_rng(numel)
    x, g = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
            .contiguous(memory_format=torch.channels_last) for _ in range(2))
    flat = x.permute(0, 2, 3, 1).view(-1)  # memory order
    flat[::7] = 0.0  # x >= 0 at x == 0, and at -0
    flat[3::11] = -0.0
    xn, gn = (t.permute(0, 2, 3, 1).float().numpy().reshape(-1) for t in (x, g))
    gs = gn * np.float32(tdrop.keep_scale(cut))
    d = np.where(xn >= 0, gs, gs * np.float32(tdrop.NEGATIVE_SLOPE))
    got = torch.from_numpy(np.where(keep, d, np.float32(0))).to(dtype)
    hblock = None if rowmap is None else (rowmap[2], rowmap[1])
    want = tdrop.bwd_plain(x, g, kw, cut, base, hblock).permute(0, 2, 3, 1).reshape(-1)
    bits = torch.int16 if dtype == BF16 else torch.int32
    assert torch.equal(got.view(bits), want.contiguous().view(bits))


def test_cpu_forward_counts_no_path():
    x = torch.randn(2, 8, 3, 4).contiguous(memory_format=torch.channels_last)
    before = dict(tdrop.FWD_PATHS)
    tdrop.leaky_relu_dropout(x, torch.tensor([1, 2]), 0.5)
    assert tdrop.FWD_PATHS == before


def test_cpu_backward_counts_no_path():
    x = torch.randn(2, 8, 3, 4).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    before = (dict(tdrop.BWD_PATHS), dict(tdrop.LAUNCHES))
    tdrop.leaky_relu_dropout(x, torch.tensor([1, 2]), 0.5).sum().backward()
    assert x.grad is not None
    assert (tdrop.BWD_PATHS, tdrop.LAUNCHES) == before


# --------------------------------------------- tools/dropout_times helpers
SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_121lrd_fwd_vector_kernelI13__nv_bfloat16Li4EEEvPKT_PS3_PKljjjjff
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x00000a00ff017b82 */
                                                                     /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_CTAID.X ;
        /*0020*/              @!P0 BRA 0x80 ;
        /*0030*/                   IMAD R2, R3, R4, RZ ;
        /*0040*/                   LOP3.LUT R2, R2, 0x7, RZ, 0x3c, !PT ;
        /*0050*/                   NOP ;
        /*0060*/                   STG.E.128 desc[UR4][R6.64], R8 ;
        /*0070*/               @P0 BRA 0x30 ;
        /*0080*/                   EXIT ;
        /*0090*/                   BRA 0x90;
\t\tFunction : _ZN12_GLOBAL__N_114lrd_fwd_kernelIfLb0EEEvPKT_PS1_PKlljjjjff
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   EXIT ;
"""


def test_sass_loop_counts():
    from imagegeneration_tpu_torch.tools import dropout_times

    got = dropout_times.loop_counts(SASS)
    vector = got["_ZN12_GLOBAL__N_121lrd_fwd_vector_kernelI13__nv_bfloat16Li4EEEvPKT_PS3_PKljjjjff"]
    assert vector["instructions"] == 9
    assert vector["loops"] == [{"from": 0x30, "to": 0x70, "instructions": 4,
                                "by_opcode": {"BRA": 1, "IMAD": 1, "LOP3": 1, "STG": 1}}]
    old = got["_ZN12_GLOBAL__N_114lrd_fwd_kernelIfLb0EEEvPKT_PS1_PKlljjjjff"]
    assert old == {"instructions": 2, "loops": []}
    # one 16-byte store of 8 bf16 a trip: 4 instructions, 2 of them integer, for 8
    per_store = dropout_times.elements_per_store(next(iter(got)))
    assert dropout_times.per_element(vector, per_store) == {
        "elements_per_trip": 8, "loop_instructions_per_element": 0.5,
        "loop_integer_instructions_per_element": 0.25}
    assert dropout_times.per_element(old, 1)["elements_per_trip"] is None
    assert dropout_times.elements_per_store(
        "_ZN12_GLOBAL__N_121lrd_fwd_vector_kernelIfLi2EEEvPKT_PS2_PKljjjjff") == 4
    assert dropout_times.elements_per_store(
        "_ZN12_GLOBAL__N_121lrd_bwd_vector_kernelI13__nv_bfloat16Li2EEEvPKT_S4_PS2_PKljjjjff") == 8
    assert dropout_times.elements_per_store(
        "_ZN12_GLOBAL__N_121lrd_bwd_scalar_kernelIfEEvPKT_S3_PS1_PKljjjjff") == 1
    assert dropout_times.elements_per_store("_ZN12_GLOBAL__N_114lrd_fwd_kernelIfLb0EE") == 1
    assert dropout_times.elements_per_store("_Z17adam_multi_kernel") is None


def test_bound_at_the_largest_headline_site():
    """bf16 (32, 64, 144, 256): 302 MB moved by the forward in 0.0901 ms at
    3.35 TB/s; 9 integer operations an element at 64 int32 lanes on 132
    SMs at 1.98 GHz, 0.0406 ms: the bytes bound it."""
    from imagegeneration_tpu_torch.tools import dropout_times

    n = 32 * 64 * 144 * 256
    fwd = dropout_times.bound(2, n, 2)
    assert fwd["bound_by"] == "bytes" and fwd["bound_ms"] == fwd["bytes_ms"]
    assert fwd["bytes_ms"] == pytest.approx(0.0901, abs=1e-4)
    assert fwd["int_ms"] == pytest.approx(0.0406, abs=1e-4)
    assert dropout_times.bound(3, n, 2)["bound_ms"] == pytest.approx(0.1352, abs=1e-4)
