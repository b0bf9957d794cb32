"""DeepSeek-V2-Lite 16B [arXiv:2405.04434; hf]: MLA + DeepSeekMoE.

27L d_model=2048 16 heads, MLA kv_lora=512 (no q_lora), MoE: 2 shared +
64 routed top-6, expert d_ff=1408, vocab 102400.
"""
from ..models.transformer import LMConfig, MLAConfig, MoEConfig
from .common import LM_SHAPES, LM_SHAPES_SMOKE

FAMILY = "lm"
SHAPES = LM_SHAPES
SHAPES_SMOKE = LM_SHAPES_SMOKE


def full() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-lite-16b",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=192,
        d_ff=1408,
        vocab=102400,
        attention="mla",
        mla=MLAConfig(kv_lora=512, q_lora=0, rope_head_dim=64,
                      nope_head_dim=128, v_head_dim=128),
        moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_expert=1408),
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-lite-16b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=24,
        d_ff=96,
        vocab=256,
        attention="mla",
        mla=MLAConfig(kv_lora=16, q_lora=0, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16),
        moe=MoEConfig(n_routed=8, n_shared=2, top_k=2, d_expert=32),
    )
