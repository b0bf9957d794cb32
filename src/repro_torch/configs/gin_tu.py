"""GIN [arXiv:1810.00826; paper]: 5L d_hidden=64, sum aggregator,
learnable eps."""
from ..models.gnn import GINConfig
from .common import GNN_SHAPES, GNN_SHAPES_SMOKE

FAMILY = "gnn"
SHAPES = GNN_SHAPES
SHAPES_SMOKE = GNN_SHAPES_SMOKE


def full() -> GINConfig:
    return GINConfig(name="gin-tu", n_layers=5, d_hidden=64, d_in=8,
                     n_classes=2)


def smoke() -> GINConfig:
    return GINConfig(name="gin-tu-smoke", n_layers=2, d_hidden=16, d_in=8,
                     n_classes=2)
