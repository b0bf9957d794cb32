"""Qwen2-7B [arXiv:2407.10671; hf]: GQA + QKV bias.

28L d_model=3584 28 heads (GQA kv=4) d_ff=18944 vocab 152064.
"""
from ..models.transformer import LMConfig
from .common import LM_SHAPES, LM_SHAPES_SMOKE

FAMILY = "lm"
SHAPES = LM_SHAPES
SHAPES_SMOKE = LM_SHAPES_SMOKE


def full() -> LMConfig:
    return LMConfig(
        name="qwen2-7b", n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_head=128, d_ff=18944, vocab=152064, qkv_bias=True,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="qwen2-7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=256, qkv_bias=True,
    )
