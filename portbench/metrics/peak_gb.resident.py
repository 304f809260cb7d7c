"""peak_gb.resident: the allocator's peak over the window
(max_memory_allocated after reset_peak_memory_stats), GB."""


def read(ctx):
    return ctx.memory_peak_bytes / 1e9 if ctx.memory_peak_bytes else None
