"""The traffic of a cell. A mix is a data file,
``corebench/traffic/<name>.json``, whose ``"kind"`` names the generator
that reads its other keys: ``corebench/kinds/<kind>.py``, found by name
(``parts.py``), whose ``make(params, graph, set_seed, seed)`` returns the
traffic of one run.

``graph`` is the run's ``graphs.Graph``; ``set_seed`` the configuration's
``graph_seed``, which fixes the traffic's edges with the graph; ``seed``
the run's ``--seed``. A traffic object gives the harness

* ``warmup()``: the list of batches set-up sends, steps ``0 .. W - 1``;
  the window goes on at step ``W``;
* ``batch(i)``: step ``i``'s ``Batch``;
* ``live(i, device)``: ``(keys, weights or None)``, the live edge set
  after step ``i`` as sorted keys ``lo * n + hi`` in the run's vertex ids
  (``i = -1``: the graph before any batch), with each edge's weight where
  the configuration has weights; what the judge holds the program to;
* ``trace_batches``: how many more steps ``--trace 1`` sends, traced.

The batches are numpy arrays made on the host before the window: the
client's data.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np

from . import parts


@dataclasses.dataclass
class Batch:
    kind: str                 # "remove" | "insert" | "mixed"
    insert: np.ndarray        # [b, 2] int64 (may be empty)
    remove: np.ndarray        # [b, 2] int64 (may be empty)
    insert_weights: Optional[np.ndarray] = None  # [b] int64, weighted only
    chunk: Optional[int] = None  # the burst chunk the batch moves

    @property
    def edits(self) -> int:
        return len(self.insert) + len(self.remove)


NONE = np.zeros((0, 2), dtype=np.int64)


def make(params: dict, graph, set_seed: int, seed: int,
         root: Path = parts.ROOT):
    """The traffic of one mix over ``graph`` (a ``graphs.Graph``)."""
    kind = parts.load("kinds", params["kind"], root)
    return kind.make(params, graph, set_seed, seed)
