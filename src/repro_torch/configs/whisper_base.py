"""Whisper-base [arXiv:2212.04356].

Encoder-decoder: 6 enc + 6 dec layers, d_model 512, 8 heads (MHA),
head_dim 64, d_ff 2048, vocab 51865.  LayerNorm, learned absolute
positions.  Conv frontend is a STUB per the assignment: ``input_specs``
provides precomputed frame embeddings (B, T, d_model) directly.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,              # reported per-stack depth
    n_enc_layers=6,
    n_dec_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    norm_type="layernorm",
    enc_ctx=1500,
    max_seq=65536,           # stress shapes push decoder ctx to 32k
    supports_long_context=False,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-base-smoke", n_layers=2, n_enc_layers=2, n_dec_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        vocab_size=256, enc_ctx=32, max_seq=512)
