"""CUDA launches a batch by ``kernels/coremaint.py``'s ``LAUNCHES``
counters, reset before the window, over the window's batches."""


def read(run):
    rows = run["batches"]
    return run["launches"] / len(rows) if rows else None
