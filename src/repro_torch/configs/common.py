"""Shared config plumbing: shape cells and the arch registry protocol,
copied from the reference's ``configs/common.py`` (pure data).

Every ``configs/<arch>.py`` exposes:
  FAMILY       — "lm" | "gnn" | "recsys" | "coremaint"
  full()       — the exact published configuration
  smoke()      — a reduced same-family configuration for CPU smoke tests
  SHAPES       — list[ShapeCell]: the assigned input shapes for this arch
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode | serve | retrieval |
    #                    full_graph | minibatch | molecule
    params: Dict[str, Any]


LM_SHAPES = [
    ShapeCell("train_4k", "train", {"seq": 4096, "batch": 256}),
    ShapeCell("prefill_32k", "prefill", {"seq": 32768, "batch": 32}),
    ShapeCell("decode_32k", "decode", {"cache": 32768, "batch": 128}),
    ShapeCell("long_500k", "decode", {"cache": 524288, "batch": 1}),
]

LM_SHAPES_SMOKE = [
    ShapeCell("train_4k", "train", {"seq": 64, "batch": 2}),
    ShapeCell("prefill_32k", "prefill", {"seq": 128, "batch": 1}),
    ShapeCell("decode_32k", "decode", {"cache": 128, "batch": 2}),
    ShapeCell("long_500k", "decode", {"cache": 256, "batch": 1}),
]

GNN_SHAPES = [
    ShapeCell(
        "full_graph_sm", "full_graph",
        {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433},
    ),
    ShapeCell(
        "minibatch_lg", "minibatch",
        {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
         "fanout": (15, 10), "d_feat": 602},
    ),
    ShapeCell(
        "ogb_products", "full_graph",
        {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100},
    ),
    ShapeCell(
        "molecule", "molecule",
        {"n_nodes": 30, "n_edges": 64, "batch": 128},
    ),
]

GNN_SHAPES_SMOKE = [
    ShapeCell("full_graph_sm", "full_graph",
              {"n_nodes": 128, "n_edges": 512, "d_feat": 32}),
    ShapeCell("minibatch_lg", "minibatch",
              {"n_nodes": 1024, "n_edges": 4096, "batch_nodes": 16,
               "fanout": (3, 2), "d_feat": 32}),
    ShapeCell("ogb_products", "full_graph",
              {"n_nodes": 256, "n_edges": 1024, "d_feat": 16}),
    ShapeCell("molecule", "molecule",
              {"n_nodes": 8, "n_edges": 24, "batch": 4}),
]

RECSYS_SHAPES = [
    ShapeCell("train_batch", "train", {"batch": 65536}),
    ShapeCell("serve_p99", "serve", {"batch": 512}),
    ShapeCell("serve_bulk", "serve", {"batch": 262144}),
    ShapeCell("retrieval_cand", "retrieval",
              {"batch": 1, "n_candidates": 1_000_000}),
]

RECSYS_SHAPES_SMOKE = [
    ShapeCell("train_batch", "train", {"batch": 64}),
    ShapeCell("serve_p99", "serve", {"batch": 16}),
    ShapeCell("serve_bulk", "serve", {"batch": 128}),
    ShapeCell("retrieval_cand", "retrieval",
              {"batch": 1, "n_candidates": 1024}),
]
