"""Gemma2-2B [arXiv:2408.00118].

Dense decoder with alternating local(4096-window)/global attention and
logit softcapping: 26L, d_model 2304, 8 q / 4 kv heads, head_dim 256,
d_ff 9216, vocab 256000.  Embeddings tied + scaled by sqrt(d); RMSNorm
uses the (1+w) gemma convention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    attn_pattern="LG" * 13,
    window_size=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    rope_theta=10000.0,
    rms_offset=True,
    post_norms=True,
    emb_scale=True,
    tie_embeddings=True,
    max_seq=8192,
    supports_long_context=False,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="gemma2-2b-smoke", n_layers=4, attn_pattern="LG" * 2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        window_size=64, max_seq=512)
