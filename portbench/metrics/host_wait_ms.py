"""host_wait_ms (engine / step dispatch): host milliseconds a step, inside
the program's `train.step` spans, that launch calls spend waiting for room
in the device's queue: the part over phases.LAUNCH_US of each launch
(phases.LAUNCH_CALLS), over the profiled sub-window. Higher: the device
paces the step and the host has that much headroom. A synchronize added to
the step drains the queue, so it lowers this and raises host_sync_ms.
Read under the profiler, whose own per-launch cost slows the host and so
shortens the waits: compare it only between traced runs on one card."""

from portbench import phases


def read(cell):
    s = phases.of(cell)
    return None if s is None else phases.launch_wait_us(s.step_calls) / 1e3 / s.steps
