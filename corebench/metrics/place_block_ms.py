"""Device time of label placement a traced batch, in ms: the kernels
launched inside the program's ``order.place_block`` spans, over the count
of ``api.apply_batch`` spans."""


def read(run):
    sp = (run.get("trace") or {}).get("spans") or {}
    api = sp.get("api.apply_batch")
    if not api or not api["count"]:
        return None
    place = sp.get("order.place_block")
    return 1e3 * (place["device_s"] if place else 0.0) / api["count"]
