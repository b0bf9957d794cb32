"""Yi-34B [arXiv:2403.04652; hf]: llama-arch GQA.

60L d_model=7168 56 heads (GQA kv=8) d_ff=20480 vocab 64000.
"""
from ..models.transformer import LMConfig
from .common import LM_SHAPES, LM_SHAPES_SMOKE

FAMILY = "lm"
SHAPES = LM_SHAPES
SHAPES_SMOKE = LM_SHAPES_SMOKE


def full() -> LMConfig:
    return LMConfig(
        name="yi-34b", n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        d_head=128, d_ff=20480, vocab=64000,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="yi-34b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=128, vocab=256,
    )
