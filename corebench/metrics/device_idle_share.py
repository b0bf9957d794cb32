"""Percent of the traced pairs' wall time in which no operation ran on the
card: one minus the union of the device's activity intervals over the
window from the first span's start to the last span's end."""


def read(run):
    tr = run.get("trace") or {}
    if not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
