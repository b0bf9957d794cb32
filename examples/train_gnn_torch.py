"""Train a GNN on a DYNAMIC graph with maintained core-number features, on
PyTorch (``examples/train_gnn.py`` is its counterpart on the JAX
package).

The paper's technique inside training: between training steps the graph
receives edge bursts; core numbers are maintained (not recomputed) by a
``CoreMaintainer`` on the card (the unified engine, whose removal and
promotion rounds launch the core-maintenance kernels) and fed to the
model as a structural node feature. The batch is built on the
maintainer's device from its slot table. Checkpointed and resumable.

    python examples/train_gnn_torch.py --steps 60
    python examples/train_gnn_torch.py --n 100000 --burst 1000 --verify
    python examples/train_gnn_torch.py --device cpu --n 300 --steps 20 --verify
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.api import CoreMaintainer  # noqa: E402
from repro_torch.core.oracle import bz_from_csr  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.graph.csr import build_csr  # noqa: E402
from repro_torch.graph.generators import erdos_renyi  # noqa: E402
from repro_torch.graph.stream import synthetic_stream  # noqa: E402
from repro_torch.models.gnn import (GraphBatch, PNAConfig,  # noqa: E402
                                    pna_forward, pna_init)
from repro_torch.train.loop import TrainConfig, run_training  # noqa: E402


def make_batch(m: CoreMaintainer, feats: torch.Tensor,
               edge_cap: int) -> GraphBatch:
    """The maintainer's live edges (both directions, at most
    ``edge_cap // 2`` of them) and ``feats`` plus the normalised core
    number as node features, on the maintainer's device."""
    dev = m.core.device
    cores = m.core[: m.n].to(torch.float32)
    senders = torch.zeros(edge_cap, dtype=torch.int64, device=dev)
    receivers = torch.zeros(edge_cap, dtype=torch.int64, device=dev)
    emask = torch.zeros(edge_cap, dtype=torch.bool, device=dev)
    idx = torch.nonzero(m.valid).flatten()[: edge_cap // 2]
    k = idx.shape[0]
    src, dst = m.src[idx].long(), m.dst[idx].long()
    senders[:k], receivers[:k] = src, dst
    senders[k:2 * k], receivers[k:2 * k] = dst, src
    emask[:2 * k] = True
    node_feat = torch.cat(
        [feats, (cores / (cores.max() + 1e-6))[:, None]], dim=1)
    n = feats.shape[0]
    return GraphBatch(
        node_feat=node_feat, senders=senders, receivers=receivers,
        edge_mask=emask, node_mask=torch.ones(n, dtype=torch.bool,
                                              device=dev),
        graph_id=torch.zeros(n, dtype=torch.int64, device=dev), n_graphs=1)


def train(n: int = 1000, steps: int = 60, burst: int = 32, device=None,
          ckpt_dir=None, log_every: int = 10, say=print):
    """Build the graph (``erdos_renyi(n, 4 n)``), the maintainer
    (capacity 16 n), the planted labels and PNA, then train for
    ``steps`` steps, one burst of ``burst`` edges before each. Returns
    ``(report, maintainer, model)``."""
    dev = resolve_device(device)
    g = erdos_renyi(n, 4 * n, seed=0)
    m = CoreMaintainer.from_graph(g, capacity=16 * n, device=dev)
    rng = np.random.default_rng(0)
    feats_np = rng.normal(size=(n, 8)).astype(np.float32)
    cores0 = m.cores()
    # labels planted from (features + initial core structure) — learnable
    labels = torch.from_numpy((
        feats_np[:, 0] + 0.5 * (cores0 > np.median(cores0)) > 0.2
    ).astype(np.int32)).to(dev)
    feats = torch.from_numpy(feats_np).to(dev)

    cfg = PNAConfig(n_layers=2, d_hidden=32, d_in=9, n_classes=2)
    model = pna_init(cfg, torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    stream = synthetic_stream(g, steps, burst, seed=7)
    edge_cap = 16 * n

    def batches():
        for ev in stream:
            # maintain cores through the burst, then emit a training batch
            if ev.kind == "insert":
                m.insert_edges(ev.edges)
            else:
                m.remove_edges(ev.edges)
            yield make_batch(m, feats, edge_cap), labels

    def loss_fn(params, gb, labels):
        logits = pna_forward(cfg, params, gb)  # [N, 2] node logits
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
        return torch.mean(nll)

    tc = TrainConfig(lr=3e-3, warmup=5, total_steps=steps,
                     ckpt_dir=ckpt_dir, ckpt_every=20)
    model, report = run_training(
        model, loss_fn, batches(), tc,
        on_step=lambda s, mx: say(
            f"step {s:03d} loss={mx['loss']:.4f} "
            f"max_core={int(m.core.max())}"
        ) if s % log_every == 0 else None,
    )
    return report, m, model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--burst", type=int, default=32,
                    help="edges inserted or removed before each step")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--verify", action="store_true",
                    help="check the final cores against BZ on the host")
    args = ap.parse_args()

    report, m, _ = train(args.n, args.steps, args.burst, args.device,
                         args.ckpt_dir)
    print(f"maintainer: device={m.device} "
          f"kernel_backend={m.kernel_backend}")
    hist = report["history"]
    print(f"\nloss: first={hist[0]['loss']:.4f} last={hist[-1]['loss']:.4f}")
    assert hist[-1]["loss"] < hist[0]["loss"], "training did not improve"
    print("dynamic-graph GNN training improved the loss ✓")
    if args.verify:
        live = np.asarray(sorted(m.edge_slot), dtype=np.int64).reshape(-1, 2)
        assert (m.cores() == bz_from_csr(build_csr(m.n, live))).all()
        print("final cores verified against BZ ✓")


if __name__ == "__main__":
    main()
