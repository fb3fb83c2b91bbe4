"""peak_mem_gb: torch.cuda.max_memory_allocated() at the window's close,
after a reset at its start, in GB (1e9 bytes)."""


def read(rec):
    return rec.peak_window_bytes / 1e9 if rec.peak_window_bytes else None
