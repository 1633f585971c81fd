"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

MoE decoder: 24L, d_model 2048, 16 heads MHA (kv=16), head_dim 128,
60 routed experts top-4 + 4 always-active shared experts, per-expert
d_ff 1408, vocab 151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    moe_d_ff=1408,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    vocab_size=151936,
    rope_theta=1_000_000.0,
    max_seq=32768,
    supports_long_context=False,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2-moe-a2.7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=96, moe_d_ff=96, n_experts=6,
        top_k=2, n_shared_experts=1, vocab_size=256, max_seq=512)
