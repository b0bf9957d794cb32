"""DeepFM [arXiv:1703.04247; paper]: 39 sparse fields, embed_dim=10,
MLP 400-400-400, FM interaction."""
from ..models.recsys import DeepFMConfig
from .common import RECSYS_SHAPES, RECSYS_SHAPES_SMOKE

FAMILY = "recsys"
SHAPES = RECSYS_SHAPES
SHAPES_SMOKE = RECSYS_SHAPES_SMOKE


def full() -> DeepFMConfig:
    return DeepFMConfig(name="deepfm", n_sparse=39, embed_dim=10,
                        mlp_dims=(400, 400, 400), rows_per_field=1_000_000)


def smoke() -> DeepFMConfig:
    return DeepFMConfig(name="deepfm-smoke", n_sparse=8, embed_dim=4,
                        mlp_dims=(32, 32), rows_per_field=1000)
