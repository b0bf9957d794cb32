"""PNA [arXiv:2004.05718; paper]: 4L d_hidden=75, mean-max-min-std
aggregators x identity-amplification-attenuation scalers."""
from ..models.gnn import PNAConfig
from .common import GNN_SHAPES, GNN_SHAPES_SMOKE

FAMILY = "gnn"
SHAPES = GNN_SHAPES
SHAPES_SMOKE = GNN_SHAPES_SMOKE


def full() -> PNAConfig:
    return PNAConfig(name="pna", n_layers=4, d_hidden=75, d_in=1433,
                     n_classes=7)


def smoke() -> PNAConfig:
    return PNAConfig(name="pna-smoke", n_layers=2, d_hidden=16, d_in=32,
                     n_classes=4)
