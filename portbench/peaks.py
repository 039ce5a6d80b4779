"""Published peaks of the cards the benchmark runs on, and roofline shares.

NVIDIA's H100 data sheet, dense rates without sparsity, at the card's full
power limit (SXM 700 W, PCIe 350 W): bfloat16 on the tensor cores, float32
outside them (what a float32 product with TF32 off runs at), and the HBM
bandwidth. A card is matched by the name `torch.cuda.get_device_name()`
gives; a card not in the table has no peak, and the metrics that need one
report nothing on it.
"""

from __future__ import annotations

PEAKS = {
    # name fragment: (bfloat16 FLOP/s, float32 FLOP/s, HBM bytes/s)
    "H100 80GB HBM3": (989e12, 67e12, 3.35e12),  # SXM5
    "H100 PCIe": (756e12, 51e12, 2.0e12),
}
DTYPES = ("bfloat16", "float32")


def card(kind: str) -> tuple[float, float, float] | None:
    for fragment, peaks in PEAKS.items():
        if fragment in kind:
            return peaks
    return None


def flops(kind: str, dtype: str) -> float | None:
    """The card's dense peak in FLOP/s for compute in `dtype`."""
    peaks = card(kind)
    return None if peaks is None else peaks[DTYPES.index(dtype)]


def roofline_pct(kind: str, dtype: str, nbytes: float, ops: float,
                 seconds: float) -> float | None:
    """100 x the least time the card could take for `nbytes` moved and `ops`
    operations in `dtype` (the larger of the two bounds), over `seconds`."""
    peaks = card(kind)
    if peaks is None or seconds <= 0:
        return None
    bound = max(nbytes / peaks[2], ops / peaks[DTYPES.index(dtype)])
    return 100.0 * bound / seconds
