"""The allocator's peak over the window on the fullest card of the cell
(torch.cuda.max_memory_allocated after reset_peak_memory_stats at the
window's start, on each card), in GiB."""


def read(run):
    if not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2**30
