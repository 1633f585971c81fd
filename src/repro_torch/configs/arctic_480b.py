"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base].

Dense-MoE hybrid: 35L, d_model 7168, 56 q / 8 kv heads, head_dim 128,
128 experts top-2 with per-expert d_ff 4864, PLUS a dense residual FFN in
parallel with the MoE at every layer.  vocab 32000.
~480B total / ~17B active parameters.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,            # dense residual branch
    moe_d_ff=4864,        # per-expert hidden
    n_experts=128,
    top_k=2,
    dense_residual=True,
    vocab_size=32000,
    rope_theta=10000.0,
    max_seq=4096 * 8,
    supports_long_context=False,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="arctic-480b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=96, moe_d_ff=96, n_experts=8,
        top_k=2, vocab_size=256, max_seq=512)
