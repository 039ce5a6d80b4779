"""device_mallocs_per_step (device): the CUDA caching allocator's device
calls (cudaMalloc and cudaFree) a step, the mean over the program's
`train.step` records of the profiled sub-window (the only steps run under
the profiler): `allocator_calls` of
`imagegeneration_tpu_torch.core.trace.steps()`. A call in a step makes the
host wait; a steady state makes none. None where the program keeps no such
records."""


def read(cell):
    try:
        from imagegeneration_tpu_torch.core import trace
    except ImportError:
        return None
    calls = [r["allocator_calls"] for r in trace.steps() if "allocator_calls" in r]
    return sum(calls) / len(calls) if calls else None
