"""Shared neural-net layers of the port (dense and MoE families).

Functional style like the reference: ``init_*`` builds param dicts of
tensors, plain functions apply them.  Every linear projection goes
through ``repro_torch.core.compressed.matmul`` so quantized weights slot
in transparently.  Attention is written as explicit einsums with an f32
softmax (never ``scaled_dot_product_attention``), keeping the
reference's rounding points.  Init draws from an explicit
``torch.Generator`` on the target device; the numbers differ from
``jax.random`` for the same seed, so parity tests bridge the reference's
weights instead.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import compressed
from repro_torch.core.compressed import (QEmbed, ShardedTensor, current_backend, matmul,
                                         piece_device, tied_logits)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float = 1.0, lead: Tuple[int, ...] = ()):
    """N(0, scale^2 / d_in) weight [*lead, d_in, d_out] on gen's device.
    Scaled in place: one f32 copy of a stacked weight at a time (granite-20b's
    [52, 6144, 24576] MLP weights are 31.4 GB each in f32)."""
    std = scale / math.sqrt(d_in)
    w = torch.randn((*lead, d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(std).to(dtype)


def norm_init(d: int, dtype, norm_type: str = "rmsnorm", *,
              device="cuda", lead: Tuple[int, ...] = ()):
    if norm_type == "layernorm":
        return {"w": torch.ones((*lead, d), dtype=dtype, device=device),
                "b": torch.zeros((*lead, d), dtype=dtype, device=device)}
    return {"w": torch.ones((*lead, d), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------

def rmsnorm(x, p, offset: bool = False, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = p["w"].float()
    w = 1.0 + w if offset else w
    return (xf * w).to(x.dtype)


def layernorm(x, p, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * p["w"].float() + p["b"].float()).to(x.dtype)


def norm(x, p, cfg):
    if cfg.norm_type == "layernorm":
        return layernorm(x, p)
    return rmsnorm(x, p, offset=cfg.rms_offset)


def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cuda"):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [..., S] int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(gen, cfg, dtype, lead: Tuple[int, ...] = ()):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    depth_scale = 1.0 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "wq": dense_init(gen, d, H * hd, dtype, lead=lead),
        "wk": dense_init(gen, d, K * hd, dtype, lead=lead),
        "wv": dense_init(gen, d, K * hd, dtype, lead=lead),
        "wo": dense_init(gen, H * hd, d, dtype, scale=depth_scale, lead=lead),
    }


def _qkv(p, x, cfg, positions, theta: float, use_rope: bool = True):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    q = matmul(x, p["wq"]).reshape(B, S, H, hd)
    k = matmul(x, p["wk"]).reshape(B, S, K, hd)
    v = matmul(x, p["wv"]).reshape(B, S, K, hd)
    if use_rope:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def _sdpa(q, k, v, mask, cap: float):
    """Grouped-query attention core.

    q: [B, S, K, G, D]; k, v: [B, T, K, D]; mask: broadcastable to
    [B, K, G, S, T] (True = attend).  f32 scores and softmax; the
    probabilities are rounded to v's dtype before the f32 PV sum.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    logits = softcap(logits, cap)
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def full_attention(q, k, v, *, causal: bool, cap: float = 0.0,
                   window: int = 0, q_offset: int = 0):
    """q: [B,S,H,D], k/v: [B,T,K,D].  Optional causal/window banding."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, K, H // K, D)
    qpos = torch.arange(S, device=q.device) + q_offset
    kpos = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= qpos[:, None] - kpos[None, :] < window
    out = _sdpa(qg, k, v, mask[None, None, None], cap)
    return out.reshape(B, S, H, D)


def local_block_attention(q, k, v, *, window: int, cap: float = 0.0):
    """Sliding-window causal attention in O(S*W) via W-sized blocks.

    Each query block attends to itself + the previous key block, which
    covers every key within ``window``.  Requires S % window == 0.
    Falls back to masked full attention when S <= window.
    """
    B, S, H, D = q.shape
    K = k.shape[2]
    W = window
    if S <= W:
        return full_attention(q, k, v, causal=True, cap=cap, window=W)
    assert S % W == 0, (S, W)
    nb = S // W
    G = H // K
    qb = q.reshape(B, nb, W, K, G, D)
    kb = k.reshape(B, nb, W, K, D)
    vb = v.reshape(B, nb, W, K, D)

    def prev(a):
        return torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], dim=1)

    k2 = torch.cat([prev(kb), kb], dim=2)               # [B, nb, 2W, K, D]
    v2 = torch.cat([prev(vb), vb], dim=2)
    logits = torch.einsum("bnskgd,bntkd->bnkgst", qb.float(), k2.float()) \
        * (1.0 / math.sqrt(D))
    logits = softcap(logits, cap)
    dev = q.device
    qpos = torch.arange(W, device=dev)[:, None] + W
    kpos = torch.arange(2 * W, device=dev)[None, :]
    mask = (qpos >= kpos) & (qpos - kpos < W)
    first = torch.arange(nb, device=dev) == 0
    valid = torch.where(first[:, None, None], kpos >= W,
                        torch.ones_like(kpos, dtype=torch.bool))  # [nb,1,2W]
    mask = mask[None, :, :] & valid                      # [nb, W, 2W]
    logits = logits.masked_fill(~mask[None, :, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnkgst,bntkd->bnskgd", probs.to(v2.dtype).float(),
                       v2.float())
    return out.reshape(B, S, H, D).to(v.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    cap: float = 0.0, q_offset: int = 0):
    """Tiled online-softmax attention, q [B,S,H,D], k/v [B,T,K,D]: the
    flash kernel under the ``"cuda"`` backend, its plain version
    otherwise (memory stays at one tile either way)."""
    fn = kops.flash_attention if current_backend(q.device) == "cuda" \
        else kref.flash_attention
    return fn(q, k, v, causal=causal, window=window, softcap=cap, q_offset=q_offset)


# threshold above which full [S, T] logits would dominate device memory
_FLASH_MIN_ELEMS = 1 << 26


def best_attention(q, k, v, *, kind: str, cfg, q_offset: int = 0,
                   causal: bool = True):
    """Dispatch: local-block for window layers, blocked flash for long
    global sequences, plain masked attention otherwise.

    The flash branch runs K3 under the ``"cuda"`` backend, and K3 has no
    backward pass (its wrapper refuses inputs that require grad), so a
    training step stays below the flash threshold (S * T < 2**26) until
    one exists; the reference sends this branch to its differentiable
    jnp flash instead."""
    S, T = q.shape[1], k.shape[1]
    if kind == "L" and S > cfg.window_size and causal:
        return local_block_attention(q, k, v, window=cfg.window_size,
                                     cap=cfg.attn_softcap)
    win = cfg.window_size if kind == "L" else 0
    if S * T >= _FLASH_MIN_ELEMS and S % 1024 == 0 and T % 1024 == 0:
        return flash_attention(q, k, v, causal=causal, window=win,
                               cap=cfg.attn_softcap, q_offset=q_offset)
    return full_attention(q, k, v, causal=causal, cap=cfg.attn_softcap,
                          window=win, q_offset=q_offset)


def attention_block(p, x, cfg, *, kind: str, positions, theta: float,
                    use_flash: bool = False):
    """Full-sequence (train/prefill) attention incl. projections."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions, theta)
    if use_flash:
        out = flash_attention(q, k, v, causal=True,
                              window=cfg.window_size if kind == "L" else 0,
                              cap=cfg.attn_softcap)
    else:
        out = best_attention(q, k, v, kind=kind, cfg=cfg)
    return matmul(out.reshape(B, S, -1), p["wo"])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg, dtype, d_ff: Optional[int] = None,
             lead: Tuple[int, ...] = ()):
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    depth_scale = 1.0 / math.sqrt(2 * max(cfg.n_layers, 1))
    p = {
        "wi": dense_init(gen, d, ff, dtype, lead=lead),
        "wo": dense_init(gen, ff, d, dtype, scale=depth_scale, lead=lead),
    }
    if cfg.mlp_gated:
        p["wg"] = dense_init(gen, d, ff, dtype, lead=lead)
    return p


def mlp_block(p, x):
    if "wg" in p:
        h = F.silu(matmul(x, p["wg"])) * matmul(x, p["wi"])
    else:
        h = F.gelu(matmul(x, p["wi"]), approximate="tanh")
    return matmul(h, p["wo"])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def init_moe(gen, cfg, dtype, lead: Tuple[int, ...] = ()):
    """Router (f32 [d, E]) and expert stacks wi, wg [E, d, moe_d_ff], wo
    [E, moe_d_ff, d]."""
    d, ffe, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    depth_scale = 1.0 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "router": dense_init(gen, d, E, torch.float32, lead=lead),
        "wi": dense_init(gen, d, ffe, dtype, lead=(*lead, E)),
        "wg": dense_init(gen, d, ffe, dtype, lead=(*lead, E)),
        "wo": dense_init(gen, ffe, d, dtype, scale=depth_scale, lead=(*lead, E)),
    }


def moe_capacity(n_tokens: int, cfg, train: bool) -> int:
    """Rows of each expert's buffer for a dispatch of ``n_tokens`` tokens:
    dropless (``n_tokens``) at eval up to 4096 tokens, so that prefill and
    decode agree with the full forward; above that (and in training)
    capacity-bounded, the lowest-gate entries dropped first, at a capacity
    factor of 2.0 at eval and ``cfg.capacity_factor`` in training.  The
    reference's default behaviour (every switch of its ``OPT`` off)."""
    if not train and n_tokens <= 4096:
        return n_tokens
    cf = cfg.capacity_factor if train else 2.0
    cap = int(math.ceil(n_tokens * cfg.top_k * cf / cfg.n_experts))
    return max(8, min(cap, n_tokens))


def moe_block(p, x, cfg, *, train: bool, cap_tokens: Optional[int] = None):
    """Scatter/gather top-k MoE: x [B, S, d] -> (out [B, S, d], aux).

    ``aux`` is the Switch load-balance loss E * sum_e f_e * p_e.
    ``cap_tokens`` is the token count that decides the capacity (default
    B * S, one dispatch over the whole batch, as the reference's
    ``moe_block``).  A smaller count makes every ``cap_tokens`` tokens (a
    row of the serving engine's admission) a dispatch of their own, as
    the reference's per-row ``vmap`` does: when such a group keeps all its
    tokens (capacity >= ``cap_tokens``), one dropless dispatch over the
    batch gives the same rows; otherwise the groups run one at a time.

    Inside a split train step (``distributed/data_parallel.py``) ``x`` is
    one piece's rows and the block computes what it would over the global
    batch: the capacity follows the global token count (the pieces' tokens
    together), the pieces exchange their gates and expert choices
    (``data_parallel.moe_exchange``) so that each entry's place in its
    expert's buffer is its rank among every piece's entries in the global
    gate order, and ``f_e`` and ``p_e`` are the global means.  So a piece
    keeps exactly the entries the unsplit step keeps, dropless or not; its
    buffer holds its own kept entries at their global places (the others'
    rows stay empty)."""
    from repro_torch.distributed import data_parallel
    B, S, d = x.shape
    T = B * S
    piece = data_parallel.active()
    n = piece.n if piece is not None else 1
    if cap_tokens is not None and cap_tokens < T:
        if piece is not None:
            raise ValueError("cap_tokens inside a split train step")
        if T % cap_tokens:
            raise ValueError(f"cap_tokens={cap_tokens} does not divide {T} tokens")
        if moe_capacity(cap_tokens, cfg, train) < cap_tokens:
            rows = x.reshape(T // cap_tokens, 1, cap_tokens, d)
            outs = [moe_block(p, r, cfg, train=train) for r in rows]
            aux = torch.stack([a for _, a in outs]).mean()
            return torch.cat([o for o, _ in outs]).reshape(B, S, d), aux
        C = T
    else:
        C = moe_capacity(T * n, cfg, train)
    E, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, d)
    logits = matmul(xt, p["router"]).float()                       # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)                     # [T, k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux (Switch-style): E * sum_e f_e * p_e, over every piece
    # of a split step (its gates and choices gathered, its probabilities'
    # sums added)
    if piece is not None:
        all_gates, all_e, pmean = data_parallel.moe_exchange(gates, eidx, probs.sum(0) / (T * n))
        lo = piece.index * T * k
    else:
        all_gates, all_e, pmean = gates, eidx, probs.mean(0)
        lo = 0
    f = F.one_hot(all_e, E).float().sum(1).mean(0)
    aux = E * torch.sum(f * pmean)

    # position of each (token, choice) within its expert: ranks from the
    # exclusive cumsum of the one-hot; when capacity can drop entries, in
    # gate order (stable, as jnp.argsort), so the lowest gates drop first
    all_flat = all_e.reshape(-1)                                   # [n*T*k]
    if C < n * T * k:
        order = torch.argsort(-all_gates.reshape(-1).detach(), stable=True)
        inv = torch.argsort(order)
        onehot = F.one_hot(all_flat[order], E)
        pos = onehot.cumsum(0) - onehot
        ppos = pos.gather(1, all_flat[order][:, None])[:, 0][inv]
    else:
        onehot = F.one_hot(all_flat, E)
        pos = onehot.cumsum(0) - onehot
        ppos = pos.gather(1, all_flat[:, None])[:, 0]
    ppos = ppos[lo:lo + T * k]
    flat_e = eidx.reshape(-1)                                      # [T*k]
    keep = ppos < C
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    # scatter the kept entries into [E, C, d]; dropped ones go to a spare row
    slot = torch.where(keep, flat_e * C + ppos, torch.full_like(ppos, E * C))
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, slot, xt[tok])
    buf = buf[:E * C].reshape(E, C, d)
    # calibration hooks: expert inputs and routing statistics
    ecounts = (F.one_hot(flat_e, E) * keep[:, None]).sum(0)
    compressed.record(p["wg"], buf, ecounts)
    compressed.record(p["wi"], buf, ecounts)
    compressed.record_routing(p["router"], ecounts, pmean)
    # expert FFN on [E, C, d] (one K2 launch per linear for int8 stacks)
    h = F.silu(compressed.expert_matmul(buf, p["wg"]))
    h = h * compressed.expert_matmul(buf, p["wi"])
    compressed.record(p["wo"], h, ecounts)
    yb = compressed.expert_matmul(h, p["wo"]).reshape(E * C, d)
    # gather back and weight by the gates, summed over the k choices in order
    gath = yb[torch.where(keep, flat_e * C + ppos, torch.zeros_like(ppos))]
    gath = torch.where(keep[:, None], gath, torch.zeros((), dtype=x.dtype, device=x.device))
    w = (gath * gates.reshape(-1, 1).to(x.dtype)).reshape(T, k, d)
    out = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + w[:, j]
    return out.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def init_embed(gen, cfg, dtype):
    w = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                    device=gen.device, dtype=torch.float32)
    p = {"embed": (w * 0.02).to(dtype)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    return p


def _lookup(t, tokens):
    """Rows of a table, or of a vocab piece whose model dim is split again
    (FSDP's "data" split of ``d_model``): each piece's columns gathered
    (outside a split train step, which gathers the table piece itself:
    ``data_parallel.unshard``)."""
    if isinstance(t, ShardedTensor):
        from repro_torch.distributed import collectives
        if t.dim != -1:
            raise NotImplementedError(f"a table piece split along dim {t.dim}")
        return collectives.all_gather([_lookup(p, tokens.to(piece_device(p)))
                                       for p in t.pieces], dim=-1, device=tokens.device)
    return t.lookup(tokens) if isinstance(t, QEmbed) else t[tokens]


def _sharded_lookup(t: ShardedTensor, tokens):
    """Rows of a vocab-sharded table: each piece looks up the tokens in its
    range (the others read row 0 and are zeroed), and the pieces' rows are
    summed (one piece is nonzero per token, so the sum is exact); the
    gradient of the sum hands each piece the rows' gradient."""
    from repro_torch.distributed import collectives, data_parallel
    rows, lo = [], 0
    for p in t.pieces:
        n = p.shape[0]
        tok = tokens.to(piece_device(p))
        mine = (tok >= lo) & (tok < lo + n)
        r = _lookup(p, torch.where(mine, tok - lo, torch.zeros_like(tok)))
        rows.append(r * mine[..., None].to(r.dtype))
        lo += n
    return collectives.all_reduce_sum(rows, device=data_parallel.home_device(t))


def _tied_logits(t, x):
    """f32 logits of ``x`` against a table; a piece whose model dim is split
    again takes ``x``'s matching columns (``collectives.split``) and sums
    the partial logits in f32, in mesh order."""
    if isinstance(t, ShardedTensor):
        from repro_torch.distributed import collectives
        if t.dim != -1:
            raise NotImplementedError(f"a table piece split along dim {t.dim}")
        xs = collectives.split(x, [p.shape[-1] for p in t.pieces], -1,
                               [piece_device(p) for p in t.pieces])
        return collectives.all_reduce_sum(
            [_tied_logits(p, xj) for xj, p in zip(xs, t.pieces)],
            dtype=torch.float32, device=x.device)
    return t.logits(x) if isinstance(t, QEmbed) else tied_logits(x, t)


def embed(params, cfg, tokens):
    """The rows of ``tokens``; a ``QEmbed`` table gives them in bf16.  A
    vocab-sharded table is looked up piece by piece."""
    from repro_torch.distributed import data_parallel
    t = data_parallel.unshard(params["embed"])
    if isinstance(t, ShardedTensor):
        x = _sharded_lookup(t, tokens.long())
    else:
        x = _lookup(t, tokens.long())
    if cfg.emb_scale:
        x = (x.float() * math.sqrt(cfg.d_model)).to(x.dtype)
    return x


def unembed(params, cfg, x):
    """f32 logits [..., V].  The tied product (a plain table's, or a
    ``QEmbed``'s on its codes) keeps its f32 accumulation: the logits are
    never rounded to bf16, as in the reference.  A vocab-sharded table
    gives each piece's logits, gathered along the vocabulary, from ``x``
    handed to each piece (``collectives.replicate``).  Inside a split train
    step a table FSDP split over "data" is gathered where it is used."""
    if cfg.tie_embeddings:
        from repro_torch.distributed import data_parallel
        t = data_parallel.unshard(params["embed"])
        if isinstance(t, ShardedTensor):
            from repro_torch.distributed import collectives
            xs = collectives.replicate(x, [piece_device(p) for p in t.pieces])
            logits = collectives.all_gather(
                [_tied_logits(p, xj) for xj, p in zip(xs, t.pieces)], dim=-1,
                device=data_parallel.home_device(t))
        else:
            logits = _tied_logits(t, x)
    else:
        logits = matmul(x, params["unembed"]).float()
    return softcap(logits, cfg.final_softcap)
