"""Parallel order-based core maintenance on PyTorch — the single-device
``engine="unified"`` slice of the reference's ``repro.core``, unweighted
and weighted.

Layers:
* ``oracle``        — sequential Simplified-Order / Traversal / BZ (numpy).
* ``decomposition`` — data-parallel peeling + h-index fixpoint.
* ``order``         — k-order label maintenance.
* ``graph_ops``     — per-round statistics; the kernel dispatch point.
* ``insert``        — batch-parallel order-based insertion maintenance.
* ``remove``        — batch-parallel mcd-cascade removal maintenance.
* ``engine``        — the unified mixed-batch program.
* ``vertex_layout`` — the single-device vertex layout.
* ``weighted``      — weighted-coreness oracle and reference harness.
* ``api``           — CoreMaintainer public interface.
"""
from .oracle import (  # noqa: F401
    OrderCoreMaintainer,
    TraversalCoreMaintainer,
    bz_core_decomposition,
    bz_from_csr,
)
