"""Model configuration: the reference's ``ModelConfig`` with a torch dtype.

Field for field the same dataclass as ``repro.configs.base.ModelConfig``
(the fields are the contract a bridged checkpoint is read against), so
:func:`from_reference` converts by name.  The dry-run helpers of the
reference (``input_specs``, ``SHAPES``) are not ported.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | encdec | rwkv | hybrid | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- attention pattern (dense/vlm/gemma families) ---
    attn_pattern: Optional[str] = None
    window_size: int = 4096
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 10000.0
    rope_theta_local: float = 0.0

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False
    capacity_factor: float = 1.25

    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    enc_ctx: int = 1500

    # --- rwkv6 ---
    rwkv_head_dim: int = 64

    # --- mamba2 / zamba2 hybrid ---
    d_state: int = 0
    ssd_head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    shared_attn_every: int = 0

    # --- vlm ---
    n_img_tokens: int = 0

    # --- common ---
    mlp_gated: bool = True
    norm_type: str = "rmsnorm"
    rms_offset: bool = False
    post_norms: bool = False
    emb_scale: bool = False
    tie_embeddings: bool = False
    max_seq: int = 131072
    param_dtype: str = "bfloat16"
    supports_long_context: bool = False
    scan_unroll: bool = False
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def pattern(self) -> str:
        if self.attn_pattern is not None:
            assert len(self.attn_pattern) == self.n_layers, self.name
            return self.attn_pattern
        return "G" * self.n_layers

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (matches init_params up to norm vectors)."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        mlp_dense = (3 if self.mlp_gated else 2) * d * self.d_ff
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm"):
            return self.n_layers * (attn + mlp_dense) + emb
        if self.family == "moe":
            moe = self.n_experts * 3 * d * self.moe_d_ff
            shared = self.n_shared_experts * 3 * d * self.moe_d_ff
            dense_res = mlp_dense if self.dense_residual else 0
            router = d * self.n_experts
            return self.n_layers * (attn + moe + shared + dense_res + router) + emb
        if self.family == "encdec":
            enc = self.n_enc_layers * (attn + mlp_dense)
            dec = self.n_dec_layers * (2 * attn + mlp_dense)
            return enc + dec + emb
        if self.family == "rwkv":
            per_layer = 5 * d * d + 2 * d * self.d_ff + 6 * d * 96
            return self.n_layers * per_layer + emb
        if self.family == "hybrid":
            di = self.expand * d
            mamba = d * 2 * di + d * (2 * self.d_state + di // self.ssd_head_dim) \
                + di * d + self.conv_kernel * (di + 2 * self.d_state)
            n_mamba, _ = self.hybrid_layout()
            return n_mamba * mamba + attn + mlp_dense + emb
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        all_experts = self.n_layers * self.n_experts * 3 * d * self.moe_d_ff
        active_experts = self.n_layers * self.top_k * 3 * d * self.moe_d_ff
        return full - all_experts + active_experts

    def hybrid_layout(self) -> Tuple[int, int]:
        """(n_mamba_layers, n_shared_attn_sites) for zamba2-style hybrids."""
        assert self.family == "hybrid"
        n_sites = self.n_layers // (self.shared_attn_every + 1)
        return self.n_layers - n_sites, n_sites


def from_reference(cfg) -> ModelConfig:
    """Convert a reference ``ModelConfig`` (any object with the same
    fields) into the port's, field by field."""
    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})
