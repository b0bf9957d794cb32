"""Device idle time inside the fixpoints' rounds a traced batch, in ms:
the time inside the program's ``remove.round`` and ``insert.round`` spans
in which no operation ran on the device (each round's host read and
relaunch), over the count of ``api.apply_batch`` spans."""

SPANS = ("remove.round", "insert.round")


def read(run):
    sp = (run.get("trace") or {}).get("spans") or {}
    api = sp.get("api.apply_batch")
    if not api or not api["count"]:
        return None
    return 1e3 * sum(sp[s]["idle_s"] for s in SPANS if s in sp) \
        / api["count"]
