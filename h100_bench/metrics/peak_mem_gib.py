"""peak_mem_gib: torch.cuda.max_memory_allocated() over the whole
process, set-up included, read when the window closes, in GiB."""


def read(ctx):
    return ctx.memory_peak_bytes / 2 ** 30 if ctx.memory_peak_bytes else None
