"""torch.cuda.max_memory_allocated over the window (the peak reset
at its start), GiB."""


def read(ctx):
    b = ctx["window_peak_bytes"]
    return b / 2 ** 30 if b > 0 else None
