"""device_ms_per_step (device): busy device milliseconds in the profiled
sub-window over its steps. The sum of the work the card did, free of the
host's pacing."""


def read(cell):
    w = cell.profiled
    if w is None or not cell.profiled_steps or not w.device:
        return None
    return w.busy_us() / 1e3 / cell.profiled_steps
