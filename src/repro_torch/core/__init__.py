"""Parallel order-based core maintenance on PyTorch — the reference's
``repro.core``: ``engine="unified"`` (unweighted and weighted),
``engine="host"`` (the seed two-call path) and ``engine="sharded"``
over ``torch.distributed`` with replicated or halo-sharded vertex state
(``vertex_sharding="range"`` on one shared axis, ``"halo"`` on a 2-axis
edge x vertex mesh; either with the dense or the sparse frontier
exchange), with the applications of maintained cores.

Layers:
* ``oracle``        — sequential Simplified-Order / Traversal / BZ (numpy).
* ``decomposition`` — data-parallel peeling + h-index fixpoint.
* ``order``         — k-order label maintenance (and its ring variants
                      over owned slices).
* ``graph_ops``     — per-round statistics; the kernel dispatch point.
* ``insert``        — batch-parallel order-based insertion maintenance
                      (and the host engine's ``insert_batch``).
* ``remove``        — batch-parallel mcd-cascade removal maintenance
                      (and the host engine's ``remove_batch``).
* ``engine``        — the mixed-batch program (unified, and each rank of
                      the sharded engine; its halo twin under "range"
                      and "halo").
* ``sharded``       — the sharded engine's per-rank program and the
                      core-only sharded building blocks.
* ``vertex_layout`` — the replicated and halo-sharded vertex layouts,
                      their collectives, ``record_traffic`` and
                      ``record_shapes``.
* ``weighted``      — weighted-coreness oracle and reference harness.
* ``api``           — CoreMaintainer public interface (all three engines).
* ``applications``  — k-core masks and subgraphs, sampling weights.
"""
from .oracle import (  # noqa: F401
    OrderCoreMaintainer,
    TraversalCoreMaintainer,
    bz_core_decomposition,
    bz_from_csr,
)
