"""Vertex-state layout — who holds each per-vertex statistic.

The port's single-device subset of the reference's
``core/vertex_layout.py``: ``ReplicatedVertices`` with ``axis=None``,
where every statistic is already complete and every mask is the full
``[n]`` mask. The mesh layouts
(a ``psum`` axis, range and halo sharding, traffic accounting) come
with the multi-GPU engines, ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ReplicatedVertices:
    """Full ``[n]`` vertex state on one device."""

    n: int
    axis: Optional[str] = None
    device: torch.device | str = "cpu"

    def __post_init__(self) -> None:
        if self.axis is not None:
            raise NotImplementedError(
                "ReplicatedVertices over a mesh axis is ROADMAP Queue 1 "
                "item 8 (multi-GPU engines)"
            )

    def own(self, full: torch.Tensor) -> torch.Tensor:
        return full

    def gather_mask(self, owned_mask: torch.Tensor) -> torch.Tensor:
        return owned_mask

    def any_owned(self, owned_mask: torch.Tensor) -> torch.Tensor:
        return torch.any(owned_mask)

    def frontier_peak(self, full_mask: torch.Tensor) -> torch.Tensor:
        """Frontier size of one exchanged mask: with one shard, the
        popcount (int32 device scalar)."""
        return torch.sum(full_mask, dtype=torch.int32)

    def zeros(self, dtype=torch.int32) -> torch.Tensor:
        return torch.zeros(self.n, dtype=dtype, device=self.device)

    def add_at(self, owned: torch.Tensor, idx: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
        """``owned.at[idx].add(vals)``: a new tensor, duplicates summed."""
        return owned.index_add(0, idx.long(), vals.to(owned.dtype))
