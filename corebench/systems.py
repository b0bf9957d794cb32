"""What the harness drives. ``Program`` is the system under test:
``repro_torch``'s ``CoreMaintainer`` built by ``from_graph`` and fed by
``apply_batch``. ``Control`` stands in its place for the control runs:
the plain reference with one guarantee broken (see ``control.py``).

Both give the harness the same calls: ``apply(insert, remove)`` returning
the batch's statistics, ``state()`` the cores and k-order labels,
``live_keys()`` the live edge keys of the slot table, ``reset_launches()``
and ``launches()`` for the kernel launch count, and ``entry_points()`` for
the kernel calls counted in a traced run.
"""
from __future__ import annotations

import numpy as np
import torch


class Program:
    """``repro_torch.core.api.CoreMaintainer`` under the cell's options."""

    def __init__(self, config: dict, n: int, indptr: np.ndarray,
                 indices: np.ndarray, device):
        from repro_torch.core.api import CoreMaintainer
        from repro_torch.graph.csr import CSRGraph
        from repro_torch.kernels import coremaint

        self.kernels = coremaint
        g = CSRGraph(n=n, indptr=indptr, indices=indices)
        self.m = CoreMaintainer.from_graph(
            g, init=config["init"], engine=config["engine"],
            kernel_backend=config["kernel_backend"], device=device)

    def apply(self, insert: np.ndarray, remove: np.ndarray):
        return self.m.apply_batch(insert_edges=insert, remove_edges=remove)

    def state(self) -> tuple:
        return self.m.core, self.m.label

    def live_keys(self) -> torch.Tensor:
        m = self.m
        live = torch.nonzero(m.valid).flatten()
        src, dst = m.src[live].long(), m.dst[live].long()
        return torch.minimum(src, dst) * m.n + torch.maximum(src, dst)

    def reset_launches(self) -> None:
        self.kernels.reset_launches()

    def launches(self) -> int:
        return sum(self.kernels.LAUNCHES.values())

    def entry_points(self):
        """``(module, name)`` of each kernel entry point, for counting
        calls in the traced pairs."""
        return [(self.kernels, name) for name in
                ("coo_stat", "fused_removal_round", "fused_promotion_stats")]
