"""Share of the HBM roofline that the core-maintenance kernels reach in the
traced pairs, in percent: the bytes each call of a ``kernels/coremaint.py``
entry point must move (``corebench/roofline.py``, counted once a call,
with the window's slots and its live edges taken as m less the most edges
a batch removes, the fewest a batch holds) over the device time of ``csrc/coremaint.cu``'s
kernels in the trace, against 3.35 TB/s."""
from corebench import roofline


def read(run):
    tr = run.get("trace") or {}
    if not tr.get("kernel_s") or not tr.get("calls"):
        return None
    live = run["m"] - run["batch_edges"]
    total = sum(roofline.call_bytes(entry, stat, e, min(e, live), run["n"])
                for entry, stat, e in tr["calls"])
    return roofline.share(total, tr["kernel_s"])
