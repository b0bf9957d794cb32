"""Removal plus promotion rounds a batch (``BatchStats.remove_rounds +
insert_rounds``), over the window's batches."""


def read(run):
    rows = run["batches"]
    if not rows:
        return None
    return sum(b["remove_rounds"] + b["insert_rounds"] for b in rows) / len(rows)
