"""tools/profile_step's memory phase: the replay of an allocator trace to its
peak and the grouping of the blocks live there, on a hand-made trace (the
phase itself needs a CUDA card)."""

from imagegeneration_tpu_torch.tools import profile_step as ps

PKG = "/src/imagegeneration_tpu_torch/"


def _event(action, addr, size, *frames):
    return {"action": action, "addr": addr, "size": size,
            "frames": [{"filename": f, "line": line, "name": name}
                       for f, line, name in frames]}


def test_peak_blocks_replays_to_the_peak():
    conv = (PKG + "nn/layers.py", 20, "forward")
    step = (PKG + "train/wgan_step.py", 150, "critic_update")
    trace = [
        _event("alloc", 1, 100, (PKG + "nn/layers.py", 10, "forward"), step),
        _event("alloc", 2, 50),  # the backward thread: no Python frame
        _event("free_requested", 1, 100),
        _event("free_completed", 1, 100),
        _event("free_requested", 9, 30),  # live before the trace began
        _event("alloc", 3, 200, conv, step),
        _event("free_requested", 3, 200),
        _event("alloc", 4, 10, ("/usr/lib/python3/threading.py", 1, "run")),
    ]
    peak, blocks, reached = ps.peak_blocks(trace, base=1000)
    assert peak == 1000 + 100 + 50 - 100 - 30 + 200
    assert [b["addr"] for b in blocks] == [2, 3]
    assert reached["addr"] == 3
    assert ps._site(blocks[0]["frames"], ps.PACKAGE) == ps.NO_FRAME
    assert ps._site(blocks[1]["frames"], ps.PACKAGE) == "nn/layers.py:20 forward"
    assert ps._site(blocks[1]["frames"], "train/") == "train/wgan_step.py:150 critic_update"
    assert ps._site(trace[-1]["frames"], ps.PACKAGE) == "(outside the package)"


def test_peak_blocks_of_an_empty_trace_is_the_base():
    assert ps.peak_blocks([], base=7) == (7, [], None)
