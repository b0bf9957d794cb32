"""Mean latency of the window's removal bursts (``apply_batch`` with a
removal list, to the end of its sync), in ms."""


def read(run):
    lat = [b["seconds"] for b in run["batches"] if b["kind"] == "remove"]
    return 1e3 * sum(lat) / len(lat) if lat else None
