"""Mean latency of the window's insertion bursts (``apply_batch`` with an
insertion list only, to the end of its sync), in ms. ``None`` where the
window has no pure insertion batch, as a mixed batch (``kind`` ``mixed``)
is neither a removal nor an insertion burst."""


def read(run):
    lat = [b["seconds"] for b in run["batches"] if b["kind"] == "insert"]
    return 1e3 * sum(lat) / len(lat) if lat else None
