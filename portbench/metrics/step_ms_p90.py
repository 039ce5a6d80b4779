"""step_ms_p90 (end to end, host clock over CUDA events): the 90th percentile,
by nearest rank, of the intervals between consecutive steps' ends over
every step of the window. An event recorded after each step call marks its
end on the device; the first interval starts at an event recorded when the
window opened. A stall of the host that idles the card lengthens the
interval in which it falls."""

import math


def p90(values):
    """The nearest-rank 90th percentile: the smallest value with at least
    90% of the values at or below it."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    return ordered[max(math.ceil(0.9 * len(ordered)) - 1, 0)]


def read(cell):
    w = cell.window
    if not w or not w["intervals_ms"]:
        return None
    return p90(w["intervals_ms"])
