"""Plain PyTorch versions of the ported kernels.

Each function computes what its CUDA kernel computes, rounding at the
same places, so it serves as the kernel's oracle on the card and as the
path the wrappers in ``kernels/ops.py`` take for tensors on the CPU.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def dequantize_codes(q, scale, group: int):
    """bf16(q [K, N] int8 codes * scale [K/g, N]) — the kernel's weight."""
    K, N = q.shape
    w = q.float().reshape(K // group, group, N) * scale[:, None, :]
    return w.reshape(K, N).to(torch.bfloat16)


def quant_matmul(x, q, scale, *, group: int, in_scale=None):
    """x [..., K] @ bf16(q [K, N] * scale [K/g, N]) -> [..., N] in x's dtype.

    ``in_scale`` (SmoothQuant, f32 [K]) multiplies x in f32 first and the
    product is cast back to x's dtype; the weight is dequantized to bf16
    before the product and the sum is taken in f32.
    """
    if in_scale is not None:
        x = (x.float() * in_scale).to(x.dtype)
    w = dequantize_codes(q, scale, group)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def paged_attention(q, k_pool, v_pool, tables, lengths, *,
                    softcap: float = 0.0, window: int = 0):
    """One decode token per slot against paged K/V.

    q [S, Kh, G, D], pools [nb, bs, Kh, D], tables [S, nblk] int,
    lengths [S] int -> [S, Kh, G, D] in q's dtype.  Position t of slot s
    lives at pool block ``tables[s, t // bs]``, row ``t % bs``; positions
    ``>= lengths[s]`` (and, with a window, ``< lengths[s] - window``) get
    weight 0.
    """
    S, Kh, G, D = q.shape
    _, bs, _, _ = k_pool.shape
    nblk = tables.shape[1]
    T = nblk * bs
    tbl = tables.long()
    k = k_pool[tbl].reshape(S, T, Kh, D)
    v = v_pool[tbl].reshape(S, T, Kh, D)
    s = torch.einsum("skgd,stkd->skgt", q.float(), k.float()) * (1.0 / math.sqrt(D))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kpos = torch.arange(T, device=q.device)[None, :]
    ln = lengths.long()[:, None]
    valid = kpos < ln
    if window:
        valid &= kpos >= ln - window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    probs = (p / p.sum(-1, keepdim=True)).to(v.dtype)
    out = torch.einsum("skgt,stkd->skgd", probs.float(), v.float())
    return out.to(q.dtype)
