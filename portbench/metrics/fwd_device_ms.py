"""fwd_device_ms (step): device milliseconds a step of the kernels, copies
and memsets launched inside the program's `train.forward` spans, over the
profiled sub-window (portbench/phases.py: a device event goes with its
launch by the trace's correlation id, the launch with the innermost
program span that contains it)."""

from portbench import phases


def read(cell):
    s = phases.of(cell)
    return None if s is None else s.device_ms("forward")
