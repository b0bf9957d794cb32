"""What the harness drives. ``Program`` is the system under test:
``repro_torch``'s ``CoreMaintainer`` built by ``from_graph`` and fed by
``apply_batch``. ``Control`` stands in its place for the control runs:
the plain reference with one guarantee broken (see ``control.py``).

Both are built as ``system(config, n, indptr, indices, device,
weights=...)``, ``weights`` the initial edges' weights aligned with the
CSR's ``edge_array()`` (None for an unweighted graph), and give the
harness the same calls: ``apply(insert, remove, insert_weights)``
returning the batch's statistics, ``state()`` the cores and k-order
labels, ``live_keys()`` the live edge keys of the slot table and their
weights (None when unweighted), ``reset_launches()``, ``launches()`` and
``syncs()`` for the kernel launch count and the program's sync counter
over the window, and ``entry_points()`` for the kernel calls counted in a
traced run.
"""
from __future__ import annotations

import numpy as np
import torch


class Program:
    """``repro_torch.core.api.CoreMaintainer`` under the cell's options:
    ``engine``, ``kernel_backend``, ``init``, and ``weighted`` (default
    false), which builds the weighted maintainer from ``weights`` and
    hands each batch's ``insert_weights`` on."""

    def __init__(self, config: dict, n: int, indptr: np.ndarray,
                 indices: np.ndarray, device, weights=None):
        from repro_torch import trace
        from repro_torch.core.api import CoreMaintainer
        from repro_torch.graph.csr import CSRGraph
        from repro_torch.kernels import coremaint

        weighted = bool(config.get("weighted", False))
        if weighted != (weights is not None):
            raise ValueError(f"weighted={weighted} but the graph "
                             f"{'has no' if weighted else 'has'} weights")
        self.kernels = coremaint
        self.trace = trace
        g = CSRGraph(n=n, indptr=indptr, indices=indices)
        extra = {"weighted": True, "weights": weights} if weighted else {}
        self.m = CoreMaintainer.from_graph(
            g, init=config["init"], engine=config["engine"],
            kernel_backend=config["kernel_backend"], device=device, **extra)

    def apply(self, insert: np.ndarray, remove: np.ndarray,
              insert_weights=None):
        return self.m.apply_batch(insert_edges=insert, remove_edges=remove,
                                  insert_weights=insert_weights)

    def state(self) -> tuple:
        return self.m.core, self.m.label

    def live_keys(self) -> tuple:
        m = self.m
        live = torch.nonzero(m.valid).flatten()
        src, dst = m.src[live].long(), m.dst[live].long()
        keys = torch.minimum(src, dst) * m.n + torch.maximum(src, dst)
        return keys, (m.w[live].long() if m.weighted else None)

    def reset_launches(self) -> None:
        self.kernels.reset_launches()
        self.trace.reset_syncs()

    def launches(self) -> int:
        return sum(self.kernels.LAUNCHES.values())

    def syncs(self) -> dict:
        """The program's syncs since ``reset_launches``, by site."""
        return dict(self.trace.SYNCS)

    def entry_points(self):
        """``(module, name)`` of each kernel entry point, for counting
        calls in the traced batches."""
        return [(self.kernels, name) for name in
                ("coo_stat", "fused_removal_round", "fused_promotion_stats")]
