"""The Adam kernel's launch plan (ops/adam.launch_groups), on the CPU.

The kernel (csrc/adam.cu) only checks the plan it is given, so what it
covers is decided here: each leaf's float4 body, its scalar head and tail,
its chunks, and the groups of leaves of one launch each. The plan is
computed from the data pointers of real CPU tensors (views at offsets of
0-3 floats, as `torch.load` and the bridge can make them), and walked chunk
by chunk the way the kernel walks it, through the plain version.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from imagegeneration_tpu_torch.ops import adam

torch.set_num_threads(1)

NS = (1, 3, 4, 5, 4095, 4097)
SOURCE = Path(adam.__file__).resolve().parent.parent / "csrc" / "adam.cu"


def _views(n, offsets, seed=0):
    """p, g, m, v of n floats, each a view starting `offsets[i]` floats into
    its own fresh (16-byte aligned) storage."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for i, off in enumerate(offsets):
        base = torch.randn(n + 8, generator=gen)
        if i == 3:
            base = base.abs()  # v >= 0
        out.append(base[off:off + n])
    return out


def _addresses(leaf):
    return [t.data_ptr() for t in leaf]


def _flat(t):
    """The tensor's elements in memory order (it is one dense block)."""
    return t.as_strided((t.numel(),), (1,))


def _coverage(group, chunk):
    """Per leaf of the group: how often each element is visited, and the
    float4 segments [vec_start, vec_stop) the walk takes."""
    out = []
    for j, span in enumerate(group.spans):
        assert group.first_chunk[j + 1] - group.first_chunk[j] == span.chunks
        seen = np.zeros(span.n, dtype=np.int64)
        segments = []
        for k in range(span.chunks):
            start, vec_start, vec_stop, stop = adam.chunk_bounds(span, k, chunk)
            assert 0 <= start <= vec_start <= vec_stop <= stop <= span.n
            seen[start:stop] += 1
            if vec_stop > vec_start:
                segments.append((vec_start, vec_stop))
        out.append((seen, segments))
    return out


@pytest.mark.parametrize("chunk", [4, 64, adam.CHUNK])
@pytest.mark.parametrize("offsets", [(0, 0, 0, 0), (1, 1, 1, 1), (2, 2, 2, 2), (3, 3, 3, 3),
                                     (0, 1, 0, 0), (3, 3, 2, 3)])
def test_plan_covers_every_element_once(offsets, chunk):
    leaves = [_views(n, offsets, seed=n) for n in NS]
    groups = adam.launch_groups([n for n in NS], [_addresses(leaf) for leaf in leaves],
                                chunk=chunk)
    assert len(groups) == 1 and groups[0].leaves == tuple(range(len(NS)))
    for leaf, (seen, segments) in zip(leaves, _coverage(groups[0], chunk)):
        assert (seen == 1).all()
        for vec_start, vec_stop in segments:
            assert (vec_stop - vec_start) % 4 == 0
            for t in leaf:  # 16-byte loads from all four tensors
                assert (t.data_ptr() + 4 * vec_start) % 16 == 0


@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("n", NS)
def test_head_body_tail(n, off):
    """Aligned alike: a head of the 0-3 floats before the first 16-byte
    boundary, whole float4s, a tail of 0-3; no body where fewer than four
    floats follow the head."""
    leaf = _views(n, (off,) * 4)
    span = adam.leaf_span(n, _addresses(leaf))
    head = (4 - off) % 4
    if n - head < 4:
        assert (span.body_begin, span.body_end) == (0, 0)
    else:
        assert span.body_begin == head
        assert (span.body_end - head) % 4 == 0 and 0 <= n - span.body_end < 4
        assert (leaf[0].data_ptr() + 4 * span.body_begin) % 16 == 0
    assert span.chunks == max(1, -(-(n - span.body_begin) // adam.CHUNK))


@pytest.mark.parametrize("offsets", [(0, 1, 0, 0), (1, 1, 1, 2), (2, 0, 2, 2), (3, 3, 0, 3)])
def test_leaf_aligned_unlike_goes_scalar(offsets):
    leaf = _views(4097, offsets)
    span = adam.leaf_span(4097, _addresses(leaf))
    assert (span.body_begin, span.body_end, span.chunks) == (0, 0, 2)


def test_groups_split_in_order():
    numels = [(i % 7) * 3 for i in range(1100)]  # every seventh leaf is empty
    addresses = [(0, 0, 0, 0)] * len(numels)
    groups = adam.launch_groups(numels, addresses)
    non_empty = [i for i, n in enumerate(numels) if n > 0]
    assert len(non_empty) > 512
    assert [len(g.leaves) for g in groups] == [512, len(non_empty) - 512]
    assert [i for g in groups for i in g.leaves] == non_empty
    small = adam.launch_groups(numels[:20], addresses[:20], table_leaves=7)
    assert [g.leaves for g in small] == [(1, 2, 3, 4, 5, 6, 8), (9, 10, 11, 12, 13, 15, 16),
                                         (17, 18, 19)]
    for g in groups + small:
        assert g.first_chunk[0] == 0 and len(g.first_chunk) == len(g.leaves) + 1
        assert g.first_chunk[-1] == sum(s.chunks for s in g.spans)
    assert adam.launch_groups([], []) == []
    assert adam.launch_groups([0, 0], addresses[:2]) == []
    with pytest.raises(ValueError, match="multiple of 4"):
        adam.launch_groups([5], addresses[:1], chunk=6)
    with pytest.raises(ValueError, match="leaves"):
        adam.launch_groups([5], addresses[:1], table_leaves=adam.TABLE_LEAVES + 1)


def test_table_fits_the_parameter_limit_and_matches_the_source():
    """The ctypes mirror is no larger than the 32,764 bytes of kernel
    parameters, and its offsets are those the CUDA source asserts."""
    assert ctypes.sizeof(adam.AdamTable) <= adam.PARAM_LIMIT
    names = [name for name, _ in adam.AdamTable._fields_]
    asserted = dict(re.findall(r"offsetof\(AdamTable, (\w+)\) == (\d+)", SOURCE.read_text()))
    size = re.search(r"sizeof\(AdamTable\) == (\d+)", SOURCE.read_text())
    assert len(asserted) >= 10 and size is not None
    layout = adam.table_layout()
    for name, offset in asserted.items():
        assert layout[names.index(name)] == int(offset), name
    assert layout[-1] == ctypes.sizeof(adam.AdamTable) == int(size.group(1))
    leaves = re.search(r"kMaxLeaves = (\d+);", SOURCE.read_text())
    assert int(leaves.group(1)) == adam.TABLE_LEAVES


def test_fill_table():
    numels = [5, 0, 4097, 3]
    addresses = [(16 * i + 4, 16 * i + 4, 16 * i + 4, 16 * i + 4) for i in range(4)]
    (group,) = adam.launch_groups(numels, addresses, chunk=1024)
    p, m, v = ([a[k] + 1000 * k for a in addresses] for k in (0, 2, 3))
    t = adam.fill_table(group, p, m, v, chunk=1024)
    assert (t.leaves, t.chunk) == (3, 1024)
    for j, i in enumerate(group.leaves):
        assert (t.p[j], t.m[j], t.v[j]) == (p[i], m[i], v[i])
        span = group.spans[j]
        assert (t.n[j], t.body_begin[j], t.body_end[j]) == (
            span.n, span.body_begin, span.body_end)
    assert list(t.first_chunk[:4]) == list(group.first_chunk) == [0, 1, 5, 6]


@pytest.mark.parametrize("chunk", [4, 64, 1024])
@pytest.mark.parametrize("offsets", [(0, 0, 0, 0), (3, 3, 3, 3), (1, 2, 1, 1)])
def test_cpu_walk_of_the_plan_is_bit_identical(offsets, chunk):
    """Each chunk's head, body and tail through `adam_leaf_plain`, as the
    kernel walks them, give the bits of whole-leaf `adam_leaf_plain`; a
    channels_last conv leaf is walked in memory order."""
    alpha = adam.adam_alpha(torch.tensor(3), 2e-4, 0.9, 0.999)
    leaves = [_views(n, offsets, seed=n) for n in NS]
    gen = torch.Generator().manual_seed(9)
    conv = [torch.randn(8, 5, 3, 3, generator=gen).contiguous(
        memory_format=torch.channels_last) for _ in range(4)]
    conv[3] = conv[3].abs()
    leaves.append(conv)
    want = []
    for p, g, m, v in leaves:
        pw, mw, vw = p.clone(), m.clone(), v.clone()
        adam.adam_leaf_plain(pw, g, mw, vw, alpha, 0.9, 0.999)
        want.append((pw, mw, vw))
    groups = adam.launch_groups([leaf[0].numel() for leaf in leaves],
                                [_addresses(leaf) for leaf in leaves], table_leaves=3,
                                chunk=chunk)
    for group in groups:
        for i, span in zip(group.leaves, group.spans):
            p, g, m, v = (_flat(t) for t in leaves[i])
            for k in range(span.chunks):
                bounds = adam.chunk_bounds(span, k, chunk)
                for a, b in zip(bounds, bounds[1:]):
                    if b > a:
                        adam.adam_leaf_plain(p[a:b], g[a:b], m[a:b], v[a:b], alpha, 0.9, 0.999)
    for (p, _, m, v), (pw, mw, vw) in zip(leaves, want):
        for got, exp in ((p, pw), (m, mw), (v, vw)):
            assert torch.equal(got.view(torch.int32), exp.view(torch.int32))


# ------------------------------------------------- bfloat16 moments (opt_moments="bf16")
def _views_bf16(n, offsets, seed=0):
    """p, g (float32) and m, v (bfloat16) of n elements, each a view
    starting `offsets[i]` elements into its own fresh storage."""
    p, g, m, v = _views(n, offsets, seed)
    out = [p, g]
    for i, t in ((2, m), (3, v)):
        base = torch.zeros(n + 8, dtype=torch.bfloat16)
        base[offsets[i]:offsets[i] + n] = t
        out.append(base[offsets[i]:offsets[i] + n])
    return out


@pytest.mark.parametrize("chunk", [4, 64, adam.CHUNK])
@pytest.mark.parametrize("offsets", [(0, 0, 0, 0), (1, 1, 1, 1), (3, 3, 3, 3), (0, 0, 4, 0),
                                     (2, 2, 6, 2), (0, 1, 0, 0), (1, 1, 2, 1), (0, 0, 2, 0)])
def test_bf16_plan_covers_every_element_once(offsets, chunk):
    """bfloat16 m and v: every element once, the quads from an element at
    which p and g are 16-byte and m and v 8-byte aligned."""
    leaves = [_views_bf16(n, offsets, seed=n) for n in NS]
    groups = adam.launch_groups(list(NS), [_addresses(leaf) for leaf in leaves], chunk=chunk,
                                moment_bytes=2)
    assert len(groups) == 1
    for leaf, (seen, segments) in zip(leaves, _coverage(groups[0], chunk)):
        assert (seen == 1).all()
        for vec_start, vec_stop in segments:
            assert (vec_stop - vec_start) % 4 == 0
            for t in leaf:
                assert (t.data_ptr() + t.element_size() * vec_start) % (4 * t.element_size()) == 0


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("offsets,head", [
    ((0, 0, 0, 0), 0), ((1, 1, 1, 1), 3), ((3, 3, 3, 3), 1),
    # m and v 8 bytes past a 16-byte boundary: a float32 moment there would
    # leave the leaf scalar, a bfloat16 quad needs only 8 bytes
    ((0, 0, 4, 4), 0), ((2, 2, 6, 2), 2), ((1, 1, 5, 1), 3)])
def test_bf16_head_body_tail(n, offsets, head):
    leaf = _views_bf16(n, offsets)
    span = adam.leaf_span(n, _addresses(leaf), moment_bytes=2)
    if n - head < 4:
        assert (span.body_begin, span.body_end) == (0, 0)
    else:
        assert span.body_begin == head
        assert (span.body_end - head) % 4 == 0 and 0 <= n - span.body_end < 4
        for t in leaf:
            assert (t.data_ptr() + t.element_size() * head) % (4 * t.element_size()) == 0
    assert span.chunks == max(1, -(-(n - span.body_begin) // adam.CHUNK))


@pytest.mark.parametrize("offsets", [(0, 0, 1, 0), (0, 0, 0, 2), (1, 1, 2, 1), (1, 0, 1, 1),
                                     (2, 2, 2, 3)])
def test_bf16_leaf_aligned_unlike_goes_scalar(offsets):
    """m or v at another element phase of its 8-byte quads than p and g (or
    p and g apart): no body."""
    leaf = _views_bf16(4097, offsets)
    span = adam.leaf_span(4097, _addresses(leaf), moment_bytes=2)
    assert (span.body_begin, span.body_end, span.chunks) == (0, 0, 2)


def test_bf16_moment_at_odd_byte_goes_scalar():
    """An address that is not a whole bfloat16 element never starts a body."""
    span = adam.leaf_span(64, (0, 0, 1, 0), moment_bytes=2)
    assert (span.body_begin, span.body_end) == (0, 0)


@pytest.mark.parametrize("chunk", [4, 64, 1024])
@pytest.mark.parametrize("offsets", [(0, 0, 0, 0), (3, 3, 3, 3), (0, 0, 4, 0), (1, 1, 2, 1)])
def test_bf16_cpu_walk_of_the_plan_is_bit_identical(offsets, chunk):
    """With bfloat16 m and v, each chunk's head, body and tail through
    `adam_leaf_plain` give the bits of whole-leaf `adam_leaf_plain`; p and
    the float32 parameters' update read the float32 moments, which are
    stored rounded to nearest even."""
    alpha = adam.adam_alpha(torch.tensor(3), 2e-4, 0.9, 0.999)
    leaves = [_views_bf16(n, offsets, seed=n) for n in NS]
    for leaf in leaves:
        leaf[3].abs_()
    want = []
    for p, g, m, v in leaves:
        pw, mw, vw = p.clone(), m.clone(), v.clone()
        adam.adam_leaf_plain(pw, g, mw, vw, alpha, 0.9, 0.999)
        assert mw.dtype == vw.dtype == torch.bfloat16
        want.append((pw, mw, vw))
    groups = adam.launch_groups([leaf[0].numel() for leaf in leaves],
                                [_addresses(leaf) for leaf in leaves], table_leaves=3,
                                chunk=chunk, moment_bytes=2)
    for group in groups:
        for i, span in zip(group.leaves, group.spans):
            p, g, m, v = leaves[i]
            for k in range(span.chunks):
                bounds = adam.chunk_bounds(span, k, chunk)
                for a, b in zip(bounds, bounds[1:]):
                    if b > a:
                        adam.adam_leaf_plain(p[a:b], g[a:b], m[a:b], v[a:b], alpha, 0.9, 0.999)
    for (p, _, m, v), (pw, mw, vw) in zip(leaves, want):
        assert torch.equal(p.view(torch.int32), pw.view(torch.int32))
        for got, exp in ((m, mw), (v, vw)):
            assert torch.equal(got.view(torch.int16), exp.view(torch.int16))


def test_bf16_plain_matches_the_float32_formula_rounded():
    """The bfloat16-moment update is the float32 update from the widened
    moments, its m and v rounded to nearest even: p bit-equal to the
    float32 form's on the same (widened) moments."""
    gen = torch.Generator().manual_seed(4)
    p = torch.randn(1000, generator=gen)
    g = torch.randn(1000, generator=gen)
    m16 = torch.randn(1000, generator=gen).to(torch.bfloat16)
    v16 = torch.rand(1000, generator=gen).to(torch.bfloat16)
    alpha = adam.adam_alpha(torch.tensor(5), 2e-4, 0.9, 0.999)
    p32, m32, v32 = p.clone(), m16.float(), v16.float()
    adam.adam_leaf_plain(p32, g, m32, v32, alpha, 0.9, 0.999)
    adam.adam_leaf_plain(p, g, m16, v16, alpha, 0.9, 0.999)
    assert torch.equal(p.view(torch.int32), p32.view(torch.int32))
    assert torch.equal(m16.view(torch.int16), m32.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(v16.view(torch.int16), v32.to(torch.bfloat16).view(torch.int16))


def test_bf16_entry_point_in_the_source():
    """Both forms are exported, and counted apart."""
    text = SOURCE.read_text()
    assert "int adam_multi_f32(const void* table_ptr, void* stream)" in text
    assert "int adam_multi_bf16(const void* table_ptr, void* stream)" in text
    assert adam.LAUNCHES.keys() == {"adam"} and adam.BF16_LAUNCHES.keys() == {"adam_bf16"}


@pytest.mark.parametrize("b1", [0.9, 0.5])
def test_library_call_beside_the_kernel_is_the_keras_update(b1):
    """tools/adam_times.library_call (torch._fused_adam_ with eps /
    sqrt(1 - b2^t); the kernel's `library_ms` yardstick, never used by the
    port) gives the plain version's p, m and v within LIBRARY_MAX_ULP ulps
    of each element's terms, on the CPU's fused Adam; with Keras's eps
    unscaled it does not (torch.optim.Adam's update)."""
    from imagegeneration_tpu_torch.tools import adam_times

    gen = torch.Generator().manual_seed(6)
    p = [torch.randn(300, 37, generator=gen),
         torch.randn(64, 3, 3, 3, generator=gen).contiguous(memory_format=torch.channels_last)]
    g = [torch.randn(t.shape, generator=gen).contiguous(memory_format=fmt)
         for t, fmt in zip(p, (torch.contiguous_format, torch.channels_last))]
    m = [torch.randn_like(t) for t in p]
    v = [torch.rand_like(t) * 1e-8 for t in p]  # sqrt(v) near eps: eps's place shows
    dist = adam_times.library_distance(p, g, m, v, b1, adam)
    assert max(dist.values()) <= adam_times.LIBRARY_MAX_ULP, dist
    # torch.optim.Adam's own eps placement moves p by far more
    q, mq, vq = ([t.clone() for t in ts] for ts in (p, m, v))
    steps = [torch.tensor(float(adam_times.STEP)) for _ in p]
    torch._fused_adam_(q, g, mq, vq, [], steps, lr=2e-4, beta1=b1, beta2=0.999,
                       weight_decay=0.0, eps=adam.KERAS_EPS, amsgrad=False, maximize=False)
    ref = [t.clone() for t in p]
    adam.adam_plain(ref, g, [t.clone() for t in m], [t.clone() for t in v],
                    adam.adam_alpha(torch.tensor(adam_times.STEP), 2e-4, b1, 0.999), b1, 0.999)
    assert max((a - b).abs().max().item() for a, b in zip(q, ref)) > 1e-6
