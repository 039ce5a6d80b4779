"""apply_host_ms (engine / step dispatch): host milliseconds a step inside
the program's `train.apply` spans, over the profiled sub-window: the Adam
host path (the gradients' checks, the step size, the launch tables and
calls). Read under the profiler, which adds its own cost to every operator
and launch inside the span, so it reads several times the untraced host
time of an apply: compare it only between traced runs on one card
(portbench/phases.py)."""

from portbench import phases


def read(cell):
    s = phases.of(cell)
    return None if s is None else s.apply_host_us / 1e3 / s.steps
