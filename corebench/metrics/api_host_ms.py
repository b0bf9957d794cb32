"""Host work of ``apply_batch`` a traced batch, in ms: the self time of
the program's ``api.apply_batch`` spans (validation, padding, window
planning, upload; the time its child spans cover left out), over their
count, from ``spans.span_summary`` of the traced batches."""


def read(run):
    sp = (run.get("trace") or {}).get("spans") or {}
    api = sp.get("api.apply_batch")
    if not api or not api["count"]:
        return None
    return 1e3 * api["self_s"] / api["count"]
