"""Edits applied with exact cores a second: the requested edits (inserted
plus removed) of every batch in the window over the window's wall time."""


def read(run):
    edits = sum(b["edits"] for b in run["batches"])
    return edits / run["window_s"] if edits else None
