"""device_idle_pct (device): 100 minus the busy share of the profiled
sub-window, the busy time being the union of the kernel, memcpy and memset
intervals clipped to the window's span. The profiler's own host cost is
inside the span, so a host-paced step reads idler here than it runs."""


def read(cell):
    w = cell.profiled
    if w is None or w.span_us <= 0 or not w.device:
        return None
    return 100.0 * (1.0 - w.busy_us() / w.span_us)
