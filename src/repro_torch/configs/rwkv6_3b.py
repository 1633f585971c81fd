"""RWKV6-3B "Finch" [arXiv:2404.05892].

Attention-free linear-recurrence LM with data-dependent decay:
32L, d_model 2560 (40 heads x 64), d_ff 8960, vocab 65536.
O(1) recurrent state per layer -> long_500k decode is supported natively.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv",
    n_layers=32,
    d_model=2560,
    n_heads=40,           # d_model / rwkv_head_dim
    n_kv_heads=40,
    head_dim=64,
    rwkv_head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    max_seq=1 << 20,
    supports_long_context=True,
    notes="attention-free: head-pruning stage of the IOLM pipeline is a no-op",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="rwkv6-3b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, rwkv_head_dim=16, d_ff=128,
        vocab_size=256, max_seq=512)
