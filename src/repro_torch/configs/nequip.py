"""NequIP [arXiv:2101.03164; paper]: 5L d_hidden=32, l_max=2, n_rbf=8,
cutoff=5, E(3)-equivariant tensor products."""
from ..models.gnn import NequIPConfig
from .common import GNN_SHAPES, GNN_SHAPES_SMOKE

FAMILY = "gnn"
SHAPES = GNN_SHAPES
SHAPES_SMOKE = GNN_SHAPES_SMOKE


def full() -> NequIPConfig:
    return NequIPConfig(name="nequip", n_layers=5, d_hidden=32, l_max=2,
                        n_rbf=8, cutoff=5.0)


def smoke() -> NequIPConfig:
    return NequIPConfig(name="nequip-smoke", n_layers=2, d_hidden=8, l_max=2,
                        n_rbf=4, cutoff=5.0)
