"""Zamba2-7B [arXiv:2411.15242].

Mamba2 backbone with a SHARED attention+MLP block interleaved:
81 block applications = 70 Mamba2 layers + 11 applications of one shared
transformer block (every 7th position).  d_model 3584, 32 heads
(kv=32, head_dim 112), d_ff 14336, ssm_state 64, expand 2
(d_inner 7168 = 112 SSD heads x 64).  vocab 32000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    d_state=64,
    ssd_head_dim=64,
    expand=2,
    conv_kernel=4,
    shared_attn_every=6,   # 81 // 7 = 11 shared sites, 70 mamba layers
    max_seq=1 << 20,
    supports_long_context=True,
    notes="pruning the shared block affects all 11 call sites at once",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="zamba2-7b-smoke", n_layers=9, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256, d_state=16,
        ssd_head_dim=16, shared_attn_every=2, max_seq=512)
