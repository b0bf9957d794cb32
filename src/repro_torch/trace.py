"""The port's tracing: named spans on ``torch.profiler``'s clock, and a
counter of the host syncs the batch path issues.

``span(name)`` is a context manager. While no ``torch.profiler`` is
recording it returns one shared no-op after a single flag check, and
allocates nothing. While one records it opens a profiler range named
``name``, so the span lands in the same ``prof.events()`` as the aten
ops, the CUDA runtime calls and the kernels they launch, and a span's
parent is the span it opens inside. The range is a function-scope
``RecordFunction`` (``_RecordFunctionFast``), not a user annotation:
the profiler then links every kernel launched inside it to it, and
draws no device-side copy of the range that a reader of the device's
activity would take for device work. The root span of a batch
(``api.apply_batch``) carries the maintainer's running batch number as
its keyword value ``batch`` (shown with ``record_shapes=True``).

``SYNCS`` counts the syncs the unified engine's batch path issues, keyed
``"<file>::<function>:<kind>"`` after the ``analysis.hostlint.SYNC_SITES``
entry that names them (``kind``: ``round`` for a host read, ``hidden``
for a sync without one). It is always on: a dict increment at each
site. A host-to-device copy syncs only on a card, so those sites pass
their device and count nothing on the CPU, as
``analysis.walker.RoundRecorder`` records them.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _profiler

# every span the program opens, by ``<module>.<function>``
SPANS = (
    "api.apply_batch",
    "engine.batch_program",
    "engine.lookup",
    "engine.tombstone",
    "engine.dedup",
    "engine.alloc",
    "engine.renumber",
    "remove.round",
    "insert.round",
    "insert.forward_reach",
    "insert.evict",
    "order.place_block",
    "order.place_block_ring",
    "HaloSession.complete",
    "HaloSession.gather_values",
)

_OFF = contextlib.nullcontext()

SYNCS: Dict[str, int] = {}


def span(name: str, batch: Optional[int] = None):
    """A profiler range named ``name`` while a profiler records, else the
    shared no-op; ``batch`` tags a batch's root span."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if batch is None:
        return torch._C._profiler._RecordFunctionFast(name)
    # (a None in place of the empty inputs aborts the process)
    return torch._C._profiler._RecordFunctionFast(name, (),
                                                  {"batch": batch})


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def count_sync(key: str, k: int = 1,
               device: Optional[torch.device] = None) -> None:
    """Count ``k`` syncs at ``key``; with ``device`` (a host-to-device
    copy) only where that device is not the CPU."""
    if device is None or device.type != "cpu":
        SYNCS[key] = SYNCS.get(key, 0) + k


def reset_syncs() -> None:
    SYNCS.clear()
