"""Mean latency of the window's insertion bursts (``apply_batch`` with an
insertion list, to the end of its sync), in ms."""


def read(run):
    lat = [b["seconds"] for b in run["batches"] if b["kind"] == "insert"]
    return 1e3 * sum(lat) / len(lat) if lat else None
