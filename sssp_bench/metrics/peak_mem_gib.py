"""peak_mem_gib: ``torch.cuda.max_memory_allocated`` over the window, GiB
(the set-up's peak is left out: the statistics are reset at the window's
start)."""


def read(ctx):
    if ctx.peak_window_bytes is None:
        return None
    return ctx.peak_window_bytes / 2**30
