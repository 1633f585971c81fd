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
    """bf16(q [..., K, N] int8 codes * scale [..., K/g, N]) — the kernel's
    weight (leading axes: an expert stack)."""
    *lead, K, N = q.shape
    w = q.float().reshape(*lead, K // group, group, N) * scale[..., :, None, :]
    return w.reshape(*lead, K, N).to(torch.bfloat16)


def quant_matmul(x, q, scale, *, group: int, in_scale=None):
    """x [..., K] @ bf16(q [K, N] * scale [K/g, N]) -> [..., N] in x's dtype,
    or every expert's product: x [E, C, K] against q [E, K, N] and scale
    [E, K/g, N] -> [E, C, N].

    ``in_scale`` (SmoothQuant, f32 [K], or [E, K] for experts) multiplies
    x in f32 first and the product is cast back to x's dtype; the weight
    is dequantized to bf16 before the product and the sum is taken in f32.
    """
    if in_scale is not None:
        x = (x.float() * (in_scale[:, None, :] if q.dim() == 3 else in_scale)).to(x.dtype)
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


def paged_attention_split(q, k_pool, v_pool, tables, lengths, *, splits: int, per: int,
                          softcap: float = 0.0, window: int = 0):
    """K1's split-and-merge arithmetic in plain PyTorch (a model for the
    tests; the wrappers use :func:`paged_attention`).  Split z of slot s
    covers positions [lo + z per, lo + (z + 1) per) of its live range
    [lo, min(len, T)), lo = max(0, len - window); each split keeps its
    scores and its (max, sum of exp); the slot's (m, l) is formed from the
    pairs in split order, exp(s - m) / l is rounded to V's dtype, and the
    splits' f32 PV partials are added in split order."""
    S, Kh, G, D = q.shape
    bs = k_pool.shape[1]
    T = tables.shape[1] * bs
    ln = lengths.long()
    hi = ln.clamp(max=T)
    lo = (ln - window).clamp(min=0) if window else torch.zeros_like(ln)
    t = lo[:, None] + torch.arange(splits * per, device=q.device)[None, :]
    live = (t < hi[:, None]).reshape(S, 1, 1, splits, per)
    t = t.clamp(max=T - 1)
    rows = tables.long().gather(1, t // bs) * bs + t % bs              # [S, P]
    k = k_pool.reshape(-1, Kh, D)[rows].float()                         # [S, P, Kh, D]
    v = v_pool.reshape(-1, Kh, D)[rows].float()
    s = torch.einsum("skgd,stkd->skgt", q.float(), k) * (1.0 / math.sqrt(D))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = s.reshape(S, Kh, G, splits, per)
    m_z = torch.where(live, s, torch.full_like(s, -math.inf)).amax(-1)  # [S, Kh, G, splits]
    has = live.any(-1)
    e = torch.where(live, torch.exp(s - torch.where(has, m_z, 0.0)[..., None]), 0.0)
    l_z = e.sum(-1)
    m = m_z.amax(-1)
    w = torch.where(has, l_z * torch.exp(m_z - m[..., None]), 0.0)
    l = torch.zeros_like(m)
    for z in range(splits):
        l = l + w[..., z]
    p = torch.where(live, torch.exp(s - m[..., None, None]) / l[..., None, None], 0.0)
    p = p.to(v_pool.dtype).float()
    part = torch.einsum("skgzt,sztkd->skgzd", p, v.reshape(S, splits, per, Kh, D))
    out = torch.zeros((S, Kh, G, D), device=q.device)
    for z in range(splits):
        out = out + part[..., z, :]
    return out.to(q.dtype)


def block_mask_from_idx(idx, n_in_blocks: int):
    """Bool block map [K/bs, N/bs] with True at (idx[j, t], j)."""
    nbn = idx.shape[0]
    mask = torch.zeros((n_in_blocks, nbn), dtype=torch.bool, device=idx.device)
    mask[idx.long(), torch.arange(nbn, device=idx.device)[:, None]] = True
    return mask


def block_sparse_matmul(x, w, idx, *, bs: int):
    """x [..., K] @ w [K, N] over only the blocks listed in ``idx``
    [N/bs, keep] (output block column j reads input blocks ``idx[j, :]``)
    -> [..., N] in x's dtype, summed in f32.  Blocks outside ``idx``
    count as zero whatever ``w`` holds there."""
    K, N = w.shape
    mask = block_mask_from_idx(idx, K // bs)
    big = mask.repeat_interleave(bs, 0).repeat_interleave(bs, 1)
    wz = torch.where(big, w.float(), torch.zeros((), device=w.device))
    return torch.matmul(x.float(), wz).to(x.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, t_real: int = 0, q_offset: int = 0,
                    bq: int = 1024, bkv: int = 1024):
    """Tiled online-softmax attention: q [B, S, H, D], k/v [B, T, Kh, D]
    -> [B, S, H, D] in q's dtype; query head h reads KV head h // (H/Kh).

    Query row i sits at position ``i + q_offset``; keys at or past
    ``t_real`` (default T) are masked, as are, with ``causal``, keys after
    the query and, with ``window``, keys ``window`` or more behind it.
    Scores are f32, scaled by 1/sqrt(D) and softcapped before the mask;
    tiles with no live (query, key) pair are skipped; probabilities are
    rounded to V's dtype before the f32 PV sum.  A masked key adds exactly
    zero, so a row with no live key gives 0 and the result does not depend
    on the tile sizes beyond summation order.  Memory stays at one
    [B, H, bq, bkv] tile.
    """
    B, S, H, D = q.shape
    T, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    t_real = t_real or T
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, Kh, G, D)
    out = torch.empty_like(q)
    dev = q.device
    for qs in range(0, S, bq):
        qe = min(qs + bq, S)
        qb = qg[:, qs:qe].float()
        qpos = torch.arange(qs, qe, device=dev) + q_offset
        first_q, last_q = qs + q_offset, qe - 1 + q_offset
        m = torch.full((B, Kh, G, qe - qs), NEG_INF, device=dev)
        l = torch.zeros((B, Kh, G, qe - qs), device=dev)
        acc = torch.zeros((B, Kh, G, qe - qs, D), device=dev)
        for ks in range(0, T, bkv):
            ke = min(ks + bkv, T)
            if ks >= t_real or (causal and ks > last_q) \
                    or (window and ke - 1 < first_q - window + 1):
                continue
            s = torch.einsum("bqkgd,btkd->bkgqt", qb, k[:, ks:ke].float()) * scale
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            kpos = torch.arange(ks, ke, device=dev)
            live = (kpos < t_real)[None, :].expand(qe - qs, -1)
            if causal:
                live = live & (qpos[:, None] >= kpos[None, :])
            if window:
                live = live & (qpos[:, None] - kpos[None, :] < window)
            s = torch.where(live, s, torch.full_like(s, NEG_INF))
            m2 = torch.maximum(m, s.amax(-1))
            p = torch.where(live, torch.exp(s - m2[..., None]), torch.zeros_like(s))
            corr = torch.exp(m - m2)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p.to(v.dtype).float(), v[:, ks:ke].float())
            m = m2
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, qs:qe] = o.permute(0, 3, 1, 2, 4).reshape(B, qe - qs, H, D).to(q.dtype)
    return out
