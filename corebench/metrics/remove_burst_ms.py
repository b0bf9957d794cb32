"""Mean latency of the window's removal bursts (``apply_batch`` with a
removal list only, to the end of its sync), in ms. ``None`` where the
window has no pure removal batch, as a mixed batch (``kind`` ``mixed``)
is neither a removal nor an insertion burst."""


def read(run):
    lat = [b["seconds"] for b in run["batches"] if b["kind"] == "remove"]
    return 1e3 * sum(lat) / len(lat) if lat else None
