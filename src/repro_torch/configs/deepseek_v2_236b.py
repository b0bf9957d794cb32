"""DeepSeek-V2 236B [arXiv:2405.04434; hf]: MLA + DeepSeekMoE.

60L d_model=5120 128 heads, MLA kv_lora=512 (q_lora=1536, rope 64 / nope
128 / v 128), MoE: 2 shared + 160 routed experts top-6, expert d_ff=1536,
vocab 102400.
"""
from ..models.transformer import LMConfig, MLAConfig, MoEConfig
from .common import LM_SHAPES, LM_SHAPES_SMOKE

FAMILY = "lm"
SHAPES = LM_SHAPES
SHAPES_SMOKE = LM_SHAPES_SMOKE


def full() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-236b",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_head=192,
        d_ff=1536,
        vocab=102400,
        attention="mla",
        mla=MLAConfig(kv_lora=512, q_lora=1536, rope_head_dim=64,
                      nope_head_dim=128, v_head_dim=128),
        moe=MoEConfig(n_routed=160, n_shared=2, top_k=6, d_expert=1536),
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-236b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=24,
        d_ff=96,
        vocab=256,
        attention="mla",
        mla=MLAConfig(kv_lora=16, q_lora=32, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16),
        moe=MoEConfig(n_routed=8, n_shared=2, top_k=2, d_expert=32),
    )
