"""Parallel order-based core maintenance on PyTorch — the single-device
part of the reference's ``repro.core``: ``engine="unified"`` (unweighted
and weighted) and ``engine="host"`` (the seed two-call path), with the
applications of maintained cores.

Layers:
* ``oracle``        — sequential Simplified-Order / Traversal / BZ (numpy).
* ``decomposition`` — data-parallel peeling + h-index fixpoint.
* ``order``         — k-order label maintenance.
* ``graph_ops``     — per-round statistics; the kernel dispatch point.
* ``insert``        — batch-parallel order-based insertion maintenance
                      (and the host engine's ``insert_batch``).
* ``remove``        — batch-parallel mcd-cascade removal maintenance
                      (and the host engine's ``remove_batch``).
* ``engine``        — the unified mixed-batch program.
* ``vertex_layout`` — the single-device vertex layout.
* ``weighted``      — weighted-coreness oracle and reference harness.
* ``api``           — CoreMaintainer public interface (both engines).
* ``applications``  — k-core masks and subgraphs, sampling weights.
"""
from .oracle import (  # noqa: F401
    OrderCoreMaintainer,
    TraversalCoreMaintainer,
    bz_core_decomposition,
    bz_from_csr,
)
