"""Device time of the slot table's operations a traced batch, in ms: the
kernels launched inside the program's ``engine.lookup``,
``engine.tombstone``, ``engine.dedup`` and ``engine.alloc`` spans (and in
none of their children), over the count of ``api.apply_batch`` spans."""

SPANS = ("engine.lookup", "engine.tombstone", "engine.dedup", "engine.alloc")


def read(run):
    sp = (run.get("trace") or {}).get("spans") or {}
    api = sp.get("api.apply_batch")
    if not api or not api["count"]:
        return None
    return 1e3 * sum(sp[s]["device_s"] for s in SPANS if s in sp) \
        / api["count"]
