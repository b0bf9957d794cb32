"""Fanout neighbor sampler (GraphSAGE-style) for the minibatch_lg shape.

Host-side numpy sampling producing fixed-shape padded blocks (the device
program is shape-static). Samples L-hop neighborhoods with per-hop fanouts
and relabels to a compact local id space.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .csr import CSRGraph


@dataclasses.dataclass
class SampledBlock:
    """A sampled computation block: local subgraph + seed positions."""

    node_ids: np.ndarray     # [N_cap] global ids (padded with -1)
    senders: np.ndarray      # [E_cap] local ids
    receivers: np.ndarray    # [E_cap] local ids
    edge_mask: np.ndarray    # [E_cap]
    node_mask: np.ndarray    # [N_cap]
    seed_mask: np.ndarray    # [N_cap] — the batch nodes (loss positions)


class NeighborSampler:
    def __init__(self, g: CSRGraph, fanouts: Tuple[int, ...] = (15, 10),
                 seed: int = 0):
        self.g = g
        self.fanouts = fanouts
        self.rng = np.random.default_rng(seed)
        # capacity: batch * prod(fanout+1) edges upper bound
        self._node_cap_mult = 1
        for f in fanouts:
            self._node_cap_mult *= f + 1

    def sample(self, batch_nodes: np.ndarray) -> SampledBlock:
        b = len(batch_nodes)
        node_cap = b * self._node_cap_mult
        edge_cap = node_cap * 2
        nodes: List[int] = list(dict.fromkeys(int(v) for v in batch_nodes))
        local = {v: i for i, v in enumerate(nodes)}
        edges: List[Tuple[int, int]] = []
        frontier = list(nodes)
        for f in self.fanouts:
            nxt: List[int] = []
            for v in frontier:
                nbrs = self.g.neighbors(v)
                if len(nbrs) > f:
                    nbrs = self.rng.choice(nbrs, size=f, replace=False)
                for w in nbrs:
                    w = int(w)
                    if w not in local:
                        if len(nodes) >= node_cap:
                            continue
                        local[w] = len(nodes)
                        nodes.append(w)
                        nxt.append(w)
                    if len(edges) < edge_cap:
                        edges.append((local[w], local[v]))  # msg w -> v
            frontier = nxt
        node_ids = np.full(node_cap, -1, dtype=np.int64)
        node_ids[: len(nodes)] = nodes
        senders = np.zeros(edge_cap, dtype=np.int32)
        receivers = np.zeros(edge_cap, dtype=np.int32)
        emask = np.zeros(edge_cap, dtype=bool)
        for i, (s, r) in enumerate(edges):
            senders[i], receivers[i], emask[i] = s, r, True
        nmask = np.zeros(node_cap, dtype=bool)
        nmask[: len(nodes)] = True
        smask = np.zeros(node_cap, dtype=bool)
        for v in batch_nodes:
            smask[local[int(v)]] = True
        return SampledBlock(
            node_ids=node_ids, senders=senders, receivers=receivers,
            edge_mask=emask, node_mask=nmask, seed_mask=smask,
        )
