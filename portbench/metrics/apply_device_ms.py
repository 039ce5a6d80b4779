"""apply_device_ms (step): device milliseconds a step of the kernels, copies
and memsets launched inside the program's `train.apply` spans (the Adam
launches, the step size's chain, any gradient copy or reduce), over the
profiled sub-window (portbench/phases.py)."""

from portbench import phases


def read(cell):
    s = phases.of(cell)
    return None if s is None else s.device_ms("apply")
