"""The card's allocator peak (``torch.cuda.max_memory_allocated``) over the
program's set-up and the window, in GiB; the generator's transient memory
is freed and the peak reset before ``from_graph``."""


def read(run):
    peak = run["memory_peak_bytes"]
    return peak / 2**30 if peak else None
