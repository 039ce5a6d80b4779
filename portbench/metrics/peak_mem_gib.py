"""peak_mem_gib (end to end, read by the benchmark from the allocator):
torch.cuda.max_memory_allocated() over the window, reset before it, in
GiB. It holds the resident datasets, the training state and the step's
activations: what bounds the largest batch or image a user can train."""


def read(cell):
    return cell.peak_bytes / 2**30 if cell.peak_bytes else None
