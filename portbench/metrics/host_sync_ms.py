"""host_sync_ms (engine / step dispatch): host milliseconds a step, inside
the program's `train.step` spans, spent in CUDA calls that stop the host
until the device drains or the driver answers: the synchronize family,
blocking copies, cudaMalloc and cudaFree (phases.SYNC_CALLS), over the
profiled sub-window. Lower: each is a stall of the host that a steady step
does not need. Read under the profiler: compare it only between traced
runs on one card."""

from portbench import phases


def read(cell):
    s = phases.of(cell)
    return None if s is None else phases.sync_us(s.step_calls) / 1e3 / s.steps
