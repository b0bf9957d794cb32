"""Host syncs a batch of the window: the program's sync counter
(``repro_torch.trace.SYNCS``, every site summed), reset before the window
and read after it, over the window's batches."""


def read(run):
    syncs, rows = run.get("syncs"), run["batches"]
    if syncs is None or not rows:
        return None
    return sum(syncs.values()) / len(rows)
