"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407].

Dense decoder: 40L, d_model 5120, 32 q heads / 8 kv (GQA), head_dim 128,
d_ff 14336, vocab 131072, 128k ctx (rope theta 1e6).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    max_seq=131072,
    supports_long_context=False,  # pure full attention -> long_500k skipped
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="mistral-nemo-12b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, max_seq=512)
