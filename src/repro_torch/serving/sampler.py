"""Token sampling: greedy / temperature / top-k (f32 logits).

``SamplingConfig`` is the static half; the random stream is an explicit
``torch.Generator`` the engine seeds from ``SamplingConfig.seed`` on its
device.  ``temperature <= 0`` is exactly greedy ``argmax`` and draws no
random numbers.  ``torch`` and ``jax.random`` give different streams
from one seed, so sampled outputs are compared by distribution, not by
value.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator], *,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """Next tokens from ``logits`` [..., vocab]; ``generator`` may be None
    when ``temperature <= 0``."""
    if temperature <= 0.0:
        return greedy(logits)
    lf = logits.float() / temperature
    if top_k:
        kth = torch.topk(lf, top_k, dim=-1).values[..., -1:]
        lf = torch.where(lf < kth, torch.full_like(lf, -1e30), lf)
    probs = torch.softmax(lf, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    tok = torch.multinomial(flat, 1, generator=generator)
    return tok.reshape(probs.shape[:-1]).to(torch.int32)


def token_confidence(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Probability of the emitted token under the raw (untempered)
    softmax, ``exp(logit[tok] - logsumexp(logits))``: the cascade's
    acceptance signal.  ``logits`` [..., vocab], ``tok`` [...] ints;
    returns f32 in [0, 1], computed on the device without a host sync."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    chosen = torch.gather(lf, -1, tok.long()[..., None])[..., 0]
    return torch.exp(chosen - lse)
