"""90th percentile of the latencies of all batches in the window, from the
call of ``apply_batch`` to the end of the device sync that follows it."""
import numpy as np


def read(run):
    lat = [b["seconds"] for b in run["batches"]]
    return float(np.percentile(lat, 90)) * 1e3 if lat else None
