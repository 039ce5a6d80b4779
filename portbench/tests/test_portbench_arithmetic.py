"""The harness's arithmetic, on the CPU: the percentile, the busy union of a
trace, the work counts behind each roofline, the FLOP count, the inputs
made from the seed."""

import math
import re

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, peaks, spec as speclib, trace, traffic, weights

SPEC = speclib.Spec.load(harness.ROOT)


def cell(name, batch=None):
    """A cell of the manifest; `batch` puts it at another batch size, such as
    the 32 at which PERF.md's per-kernel byte counts were taken."""
    c = harness.Cell(SPEC, name)
    if batch is not None:
        c.batch = batch
    return c


# ------------------------------------------------------------------ p90
def test_p90_is_the_nearest_rank_over_every_step():
    p90 = SPEC.reader("step_ms_p90").p90
    assert p90(list(range(1, 101))) == 90
    assert p90(list(range(1, 11))) == 9
    assert p90([5.0]) == 5.0
    # one slow step in 20 sits beyond p90; three in 20 do not
    assert p90([10.0] * 19 + [100.0]) == 10.0
    assert p90([10.0] * 17 + [100.0] * 3) == 100.0
    assert p90(reversed(range(1, 101))) == 90


def test_step_intervals_cover_every_step_from_the_window_start():
    c = cell("cyclegan-b4")
    c.window = {"steps": 4, "seconds": 1.0, "intervals_ms": [250.0, 240.0, 260.0, 900.0]}
    assert SPEC.reader("step_ms_p90").read(c) == 900.0
    assert SPEC.reader("images_per_s").read(c) == 4 * 4 / 1.0


# -------------------------------------------------------- trace reading
def _events():
    ann = {"ph": "X", "cat": "user_annotation", "name": harness.ANNOTATION, "ts": 100.0,
           "dur": 100.0}
    k = lambda name, ts, dur, cat="kernel": {"ph": "X", "cat": cat, "name": name,  # noqa: E731
                                             "ts": ts, "dur": dur}
    host = {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 150.0, "dur": 20.0}
    outer = {"ph": "X", "cat": "cpu_op", "name": "aten::linear", "ts": 140.0, "dur": 40.0}
    return [ann, host, outer,
            k("before", 80.0, 30.0),                    # clipped to [100, 110]
            k("void lrd_fwd_vector_kernel<bf16, 4>", 105.0, 20.0),   # [105, 125], overlaps
            k("memcpy", 130.0, 5.0, "gpu_memcpy"),
            k("void adam_multi_kernel<float>(AdamTable)", 190.0, 30.0),  # clipped to [190, 200]
            k("outside", 250.0, 10.0)]


def test_busy_union_counts_overlap_once_and_gaps_as_idle():
    w = trace.Window(_events(), harness.ANNOTATION)
    assert w.span_us == 100.0
    # [100, 125] + [130, 135] + [190, 200]
    assert w.busy_us() == pytest.approx(40.0)
    assert trace.gaps_us([(100, 125), (130, 135), (190, 200)], 100, 200) == [(125, 130),
                                                                              (135, 190)]
    assert trace.union_us([(0, 10), (5, 15), (20, 30)]) == 25


def test_kernel_time_by_name_rule_and_idle_gaps_by_host_op():
    w = trace.Window(_events(), harness.ANNOTATION)
    dropout = SPEC.reader("dropout_roofline").KERNELS
    adam = SPEC.reader("adam_roofline").KERNELS
    assert w.kernel_us(dropout) == 20.0
    assert w.kernel_us(adam) == 10.0
    gaps = dict(w.idle_gaps())
    # the gap [135, 190) starts under no op; [125, 130) likewise
    assert sum(gaps.values()) == pytest.approx(60e-6)
    name, seconds = w.top_device_ops()[0]
    assert name == "lrd_fwd_vector_kernel<bf16, 4>" and seconds == pytest.approx(20e-6)


def test_idle_gap_is_named_by_the_innermost_host_op():
    ev = _events()
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::addmm", "ts": 134.0, "dur": 3.0})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::linear", "ts": 130.0, "dur": 60.0})
    gaps = dict(trace.Window(ev, harness.ANNOTATION).idle_gaps())
    # [135, 190) starts inside both; the shorter one is the innermost
    assert gaps["aten::addmm"] == pytest.approx(55e-6)
    assert gaps["(no host op)"] == pytest.approx(5e-6)


def test_kernel_rules_match_the_sources_kernels():
    src = (harness.ROOT / harness.PROGRAM / "csrc")
    rules = {"leaky_relu_dropout.cu": SPEC.reader("dropout_roofline").KERNELS,
             "adam.cu": SPEC.reader("adam_roofline").KERNELS,
             "instance_norm.cu": SPEC.reader("instance_norm_roofline").KERNELS}
    for name, rule in rules.items():
        text = (src / name).read_text()
        kernels = re.findall(r"__global__ void(?: __launch_bounds__\(\w+\))?\s+(\w+)\(", text)
        assert kernels, name
        for k in kernels:
            assert rule.search(f"void {k}<float>(int)"), (name, k)
    assert not rules["instance_norm.cu"].search("void index_select_kernel<float>")


# ------------------------------------------------------- work counts
def test_dropout_bytes_at_the_largest_site():
    c = cell("sndcgan-b128", batch=32)
    sites = SPEC.reader("dropout_roofline").site_elements(c)
    assert sites[0] == 32 * 64 * 144 * 256
    assert round(2 * 2 * sites[0] / 1e6) == 302  # forward: read x, write y, bf16
    assert round(3 * 2 * sites[0] / 1e6) == 453  # backward: read x and g, write dx
    fwd_b, bwd_b, _, _ = SPEC.reader("dropout_roofline").work(c)
    assert fwd_b == pytest.approx(3 * 4 * sum(sites) + 16 * 21)
    assert bwd_b == pytest.approx(3 * 6 * sum(sites) + 16 * 21)


@pytest.mark.parametrize("name,leaves,gbytes", [("sndcgan-b128", 29, 1.32),
                                                ("cyclegan-b4", 224, 0.793)])
def test_adam_bytes_of_one_launch_over_every_leaf(name, leaves, gbytes):
    c = cell(name)
    trainable = [(n, s) for n, s, _, t in c.reference.param_specs(c.cfg) if t]
    assert len(trainable) == leaves
    once = sum(math.prod(s) for _, s in trainable)
    assert round(28 * once / 1e9, 3 if leaves == 224 else 2) == gbytes
    applies = c.reference.ADAM_APPLIES
    assert SPEC.reader("adam_roofline").elements(c) == sum(
        math.prod(s) * applies[n.split(".")[0]] for n, s in trainable)


def test_instance_norm_counts_of_one_step():
    c = cell("cyclegan-b4")
    gen, disc = SPEC.reader("instance_norm_roofline").norm_shapes(c)
    assert len(gen) == 24 and len(disc) == 3
    assert gen[0] == (4, 64, 128, 128) and gen[-1] == (4, 3, 128, 128)
    assert disc == [(4, 128, 30, 30), (4, 256, 14, 14), (4, 512, 6, 6)]
    _, _, fwd, bwd = SPEC.reader("instance_norm_roofline").work(c)
    assert (fwd, bwd) == (156, 210)


def test_roofline_share_takes_the_larger_bound():
    kind = "NVIDIA H100 80GB HBM3"
    assert peaks.roofline_pct(kind, "bfloat16", 3.35e9, 0.0, 1e-3) == pytest.approx(100.0)
    assert peaks.roofline_pct(kind, "float32", 0.0, 67e9, 2e-3) == pytest.approx(50.0)
    assert peaks.roofline_pct("cpu", "float32", 1.0, 1.0, 1.0) is None
    assert peaks.roofline_pct(kind, "float32", 1.0, 1.0, 0.0) is None
    assert peaks.flops("NVIDIA H100 PCIe", "bfloat16") == 756e12


def test_flop_counter_counts_a_conv_as_the_hand_formula():
    x = torch.empty(8, 64, 36, 64, device="meta")
    w = torch.empty(128, 64, 4, 4, device="meta", requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        y = F.conv2d(x, w, stride=2, padding=1)
    out = 8 * 128 * 18 * 32
    assert fc.get_total_flops() == 2 * out * 64 * 4 * 4
    with FlopCounterMode(display=False) as fc:
        y.sum().backward()
    assert fc.get_total_flops() == 2 * out * 64 * 4 * 4  # the weight gradient alone


@pytest.mark.parametrize("name,batch,tflop", [("sndcgan-b128", 32, (4.5, 4.9)),
                                              ("sndcgan-b128", None, (18.0, 19.6)),
                                              ("cyclegan-b4", None, (1.8, 2.2))])
def test_step_flops_of_the_reference_step(name, batch, tflop):
    flops = SPEC.reader("step_mfu").step_flops(cell(name, batch))
    assert tflop[0] < flops / 1e12 < tflop[1]


# ------------------------------------------------ inputs from the seed
def test_weights_follow_the_seed_and_their_rules():
    c = cell("sndcgan-b128")
    specs = [s for s in c.reference.param_specs({**c.cfg, "image_size": [16, 32, 3],
                                                 "base_width": 16})]
    a, b = weights.make(specs, 2**40 + 3, "cpu"), weights.make(specs, 2**40 + 3, "cpu")
    other = weights.make(specs, 4, "cpu")
    for name, shape, init, _ in specs:
        assert a[name].shape == torch.Size(shape)
        assert torch.equal(a[name], b[name])
        if isinstance(init, tuple):
            limit = math.sqrt(6.0 / (init[1] + init[2]))
            assert a[name].abs().max() <= limit
            assert not torch.equal(a[name], other[name])
        elif init == "unit":
            assert torch.linalg.vector_norm(a[name]) == pytest.approx(1.0)
        else:
            assert torch.all(a[name] == (1.0 if init == "ones" else 0.0))


def test_seeds_of_each_use_differ_and_fit_a_generator():
    s = harness._seeds(2**31 + 99)
    assert len(set(s.values())) == len(s)
    assert all(0 <= v < 2**63 for v in s.values())
    assert harness._seeds(2**31 + 99) == s != harness._seeds(2**31 + 98)


def test_the_first_steps_take_rows_that_all_differ_and_epochs_renew():
    t = {"batch_size": 4, "images": 10, "domains": 2}
    order = traffic.EpochOrder(t, 7, "cpu")
    steps = [order.next() for _ in range(5)]  # 2 a epoch
    first = torch.cat([s[0].view(-1) for s in steps[:2]])
    assert len(set(first.tolist())) == 8
    assert all(s[0].shape == (1, 4) for s in steps)
    again = traffic.EpochOrder(t, 7, "cpu")
    assert all(torch.equal(a[1], again.next()[1]) for a in steps)
    data = traffic.make_datasets(t, (8, 8, 3), 1, "cpu")
    assert len(data) == 2 and data[0].dtype == torch.uint8 and data[0].shape == (10, 8, 8, 3)
    assert not torch.equal(data[0], data[1])
