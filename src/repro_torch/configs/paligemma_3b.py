"""PaliGemma-3B [arXiv:2407.07726].

VLM: SigLIP vision tower (STUB: precomputed patch embeddings) feeding a
gemma-style decoder backbone: 18L, d_model 2048, 8 q / 1 kv head (MQA),
head_dim 256, d_ff 16384, vocab 257216.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    n_img_tokens=256,
    rope_theta=10000.0,
    emb_scale=True,
    tie_embeddings=True,
    max_seq=8192,
    supports_long_context=False,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="paligemma-3b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=256,
        n_img_tokens=8, max_seq=512)
