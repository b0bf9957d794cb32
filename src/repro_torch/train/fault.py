"""Fault tolerance runtime: preemption handling, straggler detection,
elastic re-meshing hooks. The reference's ``train/fault.py``, copied
(plain Python; the behaviour is the same).

When a cluster preempts a node, SIGTERM arrives ~30s before; the handler
flips a flag the train loop checks each step so it checkpoints and exits
cleanly. ``run_training`` installs the handler for its loop only and
always uninstalls it. Straggler mitigation is a per-step deadline: steps
exceeding ``deadline_factor`` x the rolling median are logged (a
collective in flight cannot be abandoned — mitigation is re-scheduling
the slow host; here we record and expose the decision hook).
"""
from __future__ import annotations

import signal
import time
from typing import Callable, List, Optional


class PreemptionGuard:
    def __init__(self) -> None:
        self.requested = False
        self._old = None

    def install(self) -> "PreemptionGuard":
        def handler(signum, frame):
            self.requested = True

        self._old = signal.signal(signal.SIGTERM, handler)
        return self

    def uninstall(self) -> None:
        if self._old is not None:
            signal.signal(signal.SIGTERM, self._old)


class StragglerMonitor:
    def __init__(self, deadline_factor: float = 3.0, window: int = 32):
        self.deadline_factor = deadline_factor
        self.window = window
        self.durations: List[float] = []
        self.straggler_steps: List[int] = []
        self.on_straggler: Optional[Callable[[int, float], None]] = None
        self._t0 = None
        self._step = 0

    def step_start(self, step: int) -> None:
        self._t0 = time.monotonic()
        self._step = step

    def step_end(self) -> float:
        dt = time.monotonic() - self._t0
        hist = self.durations[-self.window:]
        if len(hist) >= 8:
            med = sorted(hist)[len(hist) // 2]
            if dt > self.deadline_factor * med:
                self.straggler_steps.append(self._step)
                if self.on_straggler:
                    self.on_straggler(self._step, dt)
        self.durations.append(dt)
        return dt


class ElasticMesh:
    """Tracks desired vs available device counts; on shrink/grow the launcher
    re-creates the mesh and re-shards from the latest checkpoint. On a real
    cluster `available()` would query the coordinator; here it is injectable
    for tests."""

    def __init__(self, desired: int, available_fn: Callable[[], int]):
        self.desired = desired
        self.available_fn = available_fn

    def needs_remesh(self, current: int) -> bool:
        return self.available_fn() != current

    def next_shape(self) -> int:
        avail = self.available_fn()
        # largest power-of-two <= available (keeps mesh factorable)
        shape = 1
        while shape * 2 <= avail:
            shape *= 2
        return shape
