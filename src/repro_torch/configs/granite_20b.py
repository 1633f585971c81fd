"""Granite-20B-Code [arXiv:2405.04324].

Dense llama-arch code model: 52L, d_model 6144, 48 heads with MQA (kv=1),
head_dim 128, d_ff 24576, vocab 49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_gated=False,   # GPT-BigCode lineage: plain 2-matrix GELU MLP
    rope_theta=10000.0,
    max_seq=8192 * 4,
    supports_long_context=False,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="granite-20b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=256, max_seq=512)
