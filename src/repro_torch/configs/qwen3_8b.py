"""Qwen3-8B [hf:Qwen/Qwen3-8B]: GQA + qk_norm.

36L d_model=4096 32 heads (GQA kv=8) d_ff=12288 vocab 151936.
"""
from ..models.transformer import LMConfig
from .common import LM_SHAPES, LM_SHAPES_SMOKE

FAMILY = "lm"
SHAPES = LM_SHAPES
SHAPES_SMOKE = LM_SHAPES_SMOKE


def full() -> LMConfig:
    return LMConfig(
        name="qwen3-8b", n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
        d_head=128, d_ff=12288, vocab=151936, qk_norm=True,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="qwen3-8b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=256, qk_norm=True,
    )
