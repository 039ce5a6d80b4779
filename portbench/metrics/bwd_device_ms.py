"""bwd_device_ms (step): device milliseconds a step of the kernels, copies
and memsets launched inside the program's `train.backward` spans (the
gradient pulls, the recomputes of `remat_d`), over the profiled sub-window.
The autograd engine's thread launches them while the main thread is inside
the span: they go with it by time (portbench/phases.py)."""

from portbench import phases


def read(cell):
    s = phases.of(cell)
    return None if s is None else s.device_ms("backward")
