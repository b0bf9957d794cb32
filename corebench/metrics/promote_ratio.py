"""Vertices promoted out of those the insertion visited, in percent: the
window's sum of ``BatchStats.n_promoted`` over its sum of ``v_plus`` (the
paper's |V*| over |V+|)."""


def read(run):
    visited = sum(b["v_plus"] for b in run["batches"])
    if not visited:
        return None
    return 100.0 * sum(b["n_promoted"] for b in run["batches"]) / visited
