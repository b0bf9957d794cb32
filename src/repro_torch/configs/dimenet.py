"""DimeNet [arXiv:2003.03123; unverified]: 6 interaction blocks,
d_hidden=128, n_bilinear=8, n_spherical=7, n_radial=6."""
from ..models.gnn import DimeNetConfig
from .common import GNN_SHAPES, GNN_SHAPES_SMOKE

FAMILY = "gnn"
SHAPES = GNN_SHAPES
SHAPES_SMOKE = GNN_SHAPES_SMOKE


def full() -> DimeNetConfig:
    return DimeNetConfig(name="dimenet", n_blocks=6, d_hidden=128,
                         n_bilinear=8, n_spherical=7, n_radial=6, cutoff=5.0)


def smoke() -> DimeNetConfig:
    return DimeNetConfig(name="dimenet-smoke", n_blocks=2, d_hidden=16,
                         n_bilinear=2, n_spherical=3, n_radial=3, cutoff=5.0)
