"""Gemma3-1B [hf:google/gemma-3-1b-pt].

Dense decoder, 5:1 local:global attention, 128k ctx on global layers:
26L, d_model 1152, 4 q / 1 kv head (MQA), head_dim 256, d_ff 6912,
vocab 262144.  Local window 512, local rope theta 10k, global 1M.
26 = 4x(LLLLLG) + LL remainder.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    attn_pattern="LLLLLG" * 4 + "LL",
    window_size=512,
    rope_theta=1_000_000.0,
    rope_theta_local=10000.0,
    rms_offset=True,
    post_norms=True,
    emb_scale=True,
    tie_embeddings=True,
    max_seq=131072,
    # 5:1 local:global, kv=1 -> only ~4 global layers hold 500k KV (~2 GB): runnable
    supports_long_context=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="gemma3-1b-smoke", n_layers=8, attn_pattern="LLLLLG" + "LL",
        d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
        vocab_size=256, window_size=64, max_seq=512)
