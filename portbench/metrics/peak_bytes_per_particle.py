"""torch.cuda.max_memory_allocated() over set-up and window, over N."""


def read(run):
    return run.peak_bytes / run.n if run.peak_bytes else None
