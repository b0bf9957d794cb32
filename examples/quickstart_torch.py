"""Quickstart: parallel order-based core maintenance in 30 lines, on
PyTorch (``examples/quickstart.py`` is its counterpart on the JAX
package). Runs on the card; ``--device cpu`` runs it on the CPU.

    python examples/quickstart_torch.py
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.api import CoreMaintainer  # noqa: E402
from repro_torch.core.oracle import bz_from_csr  # noqa: E402
from repro_torch.graph.csr import add_edges_csr  # noqa: E402
from repro_torch.graph.generators import erdos_renyi  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()

    g = erdos_renyi(n=2000, m=8000, seed=0)
    m = CoreMaintainer.from_graph(g, device=args.device)
    print(f"graph: n={g.n} m={g.m}  max core = {m.cores().max()}  "
          f"({m.device}, kernel_backend={m.kernel_backend})")

    # insert a batch of 100 random edges — one bulk-synchronous call
    rng = np.random.default_rng(1)
    batch = []
    while len(batch) < 100:
        u, v = rng.integers(0, g.n, size=2)
        if u != v and not g.has_edge(int(u), int(v)):
            batch.append((int(min(u, v)), int(max(u, v))))
    batch = np.asarray(sorted(set(batch)))
    stats = m.insert_edges(batch)
    print(
        f"insert {len(batch)} edges: rounds={int(stats.rounds)} "
        f"|V*|={int(stats.n_promoted)} |V+|={int(stats.v_plus)}"
    )

    # verify against BZ recomputation
    expect = bz_from_csr(add_edges_csr(g, batch))
    assert (m.cores() == expect).all(), "core maintenance mismatch!"
    print("cores match BZ recomputation ✓")

    # remove them again
    stats = m.remove_edges(batch)
    print(f"remove: rounds={int(stats.rounds)} |V*|={int(stats.n_dropped)}")
    expect = bz_from_csr(g)
    assert (m.cores() == expect).all()
    print("cores restored ✓")

    # the maintained k-order is queryable in O(1)
    print(f"k-order: vertex 0 {'<' if m.order_lt(0, 1) else '>='} vertex 1")


if __name__ == "__main__":
    main()
