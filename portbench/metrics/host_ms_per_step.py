"""host_ms_per_step (engine / step dispatch): the median host time of one
step call started on an idle card (a synchronize before each call, none
inside), over the traced run's synced sub-window: what the host pays to
enqueue one step."""

import statistics


def read(cell):
    if not cell.host_s:
        return None
    return statistics.median(cell.host_s) * 1e3
