"""The paper's own workload: parallel order-based core maintenance over a
dynamic graph (edge batches against livej-scale graphs)."""
import dataclasses

from .common import ShapeCell

FAMILY = "coremaint"


@dataclasses.dataclass(frozen=True)
class CoreMaintConfig:
    name: str = "coremaint"
    n_vertices: int = 4_847_571       # livej scale
    edge_capacity: int = 140_000_000  # 2x livej edges
    batch_edges: int = 100_000        # the paper's batch size


SHAPES = [
    ShapeCell("insert_100k", "coremaint_insert", {"batch_edges": 100_000}),
    ShapeCell("remove_100k", "coremaint_remove", {"batch_edges": 100_000}),
]
SHAPES_SMOKE = [
    ShapeCell("insert_100k", "coremaint_insert", {"batch_edges": 64}),
    ShapeCell("remove_100k", "coremaint_remove", {"batch_edges": 64}),
]


def full() -> CoreMaintConfig:
    return CoreMaintConfig()


def smoke() -> CoreMaintConfig:
    return CoreMaintConfig(name="coremaint-smoke", n_vertices=256,
                           edge_capacity=2048, batch_edges=64)
