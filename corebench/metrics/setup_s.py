"""Seconds from the process's start to the window's start: imports, the
graph generated on the card, ``from_graph``'s peel, the warm-up (one cycle of the mix), and
on a checkout's first run the kernels' build."""


def read(run):
    return run["setup_s"]
