"""Decoder-only transformer LM (dense, MoE and vlm families), and the block
the hybrid family shares across its sites (``init_block``, ``block_apply``,
``block_decode``, ``paged_block_decode``, ``block_prefill_from``).

A vlm (paligemma) is the dense stack with precomputed image embeddings
``img_embs`` [B, n_img, d] spliced ahead of the text in ``forward``,
``prefill`` and ``loss_fn``: cast to the activations' dtype and not
scaled (``emb_scale`` multiplies the text embeddings only), positions
running over the whole image-prefixed sequence, and the loss taken on the
text positions only.

The reference runs the layer stack with ``lax.scan`` over the repeating
pattern unit of the architecture (gemma2's (local, global) pair); the
port keeps its param layout — each unit position's leaves stacked along
a leading ``[R, ...]`` axis in ``params["blocks"]``, remainder layers in
``params["tail"]`` — and loops over the stacked layers in Python.

KV caches keep the reference's layout too: the contiguous prefill cache
is ``{"blocks": [{"k": [R, B, T, K, hd], "v": ...}], "tail": [...]}``,
the paged pools are ``[R, num_blocks, block_size, K, hd]``.  Where the
reference returns a new cache (jit donation), the port writes the pools
in place with ``index_copy_`` and returns the same dicts.

An MoE block's FFN is the routed experts plus, where the config has
them, a shared MLP (qwen2-moe's always-active experts) and a dense
residual MLP (arctic).  Its capacity is decided by the token count of one
dispatch: the whole batch, except in ``prefill`` and ``prefill_from``
with ``cap_tokens`` (the serving engine's admission), where every row is
its own dispatch, as in the reference's per-row prefill.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.core.compressed import BlockSparseTensor, QTensor, ShardedTensor, current_backend
from repro_torch.distributed.data_parallel import checkpoint, position_span
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import sharded_cache as SC
from repro_torch.models.layers import matmul, norm

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# pattern-unit machinery
# ---------------------------------------------------------------------------

def pattern_unit(cfg) -> Tuple[str, int, int]:
    """(unit, n_repeats, n_tail) — smallest repeating unit of the pattern."""
    pat = cfg.pattern()
    n = len(pat)
    for U in range(1, n + 1):
        R = n // U
        if R < 1:
            continue
        unit = pat[:U]
        if (unit * R == pat[:U * R] and pat[U * R:] == unit[:n - U * R]
                and (R >= 2 or U == n)):
            return unit, R, n - U * R
    return pat, 1, 0


def layer_slice(tree, r: int):
    """The ``r``-th layer of a stacked param or cache subtree."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, r) for k, v in tree.items()}
    if isinstance(tree, (QTensor, BlockSparseTensor, ShardedTensor)):
        return tree.layer(r)
    return tree[r]


def _layers(tree, cfg) -> Iterator[Tuple[str, Any]]:
    """(kind, per-layer subtree) in execution order over ``blocks`` and
    ``tail`` of a param or cache tree."""
    unit, R, _ = pattern_unit(cfg)
    for r in range(R):
        for u, kind in enumerate(unit):
            yield kind, layer_slice(tree["blocks"][u], r)
    for i, p in enumerate(tree["tail"]):
        yield unit[i % len(unit)], p


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def init_block(gen, cfg, dtype, lead: Tuple[int, ...] = ()) -> Params:
    """One block's params (the hybrid's shared attention + MLP block too)."""
    if cfg.family not in ("dense", "moe", "vlm", "hybrid"):
        raise ValueError(f"family {cfg.family!r} has no transformer block")
    d, dev = cfg.d_model, gen.device
    p: Params = {
        "ln1": L.norm_init(d, dtype, cfg.norm_type, device=dev, lead=lead),
        "attn": L.init_attention(gen, cfg, dtype, lead=lead),
        "ln2": L.norm_init(d, dtype, cfg.norm_type, device=dev, lead=lead),
    }
    if cfg.post_norms:
        p["ln1_post"] = L.norm_init(d, dtype, cfg.norm_type, device=dev, lead=lead)
        p["ln2_post"] = L.norm_init(d, dtype, cfg.norm_type, device=dev, lead=lead)
    if cfg.family == "moe":
        p["moe"] = L.init_moe(gen, cfg, dtype, lead=lead)
        if cfg.n_shared_experts:
            # n parallel shared experts == one MLP with concatenated hidden
            p["shared_mlp"] = L.init_mlp(gen, cfg, dtype, lead=lead,
                                         d_ff=cfg.n_shared_experts * cfg.moe_d_ff)
        if cfg.dense_residual:
            p["dense_mlp"] = L.init_mlp(gen, cfg, dtype, d_ff=cfg.d_ff, lead=lead)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, dtype, lead=lead)
    return p


def _theta(cfg, kind: str) -> float:
    if kind == "L" and cfg.rope_theta_local:
        return cfg.rope_theta_local
    return cfg.rope_theta


def _ffn(p, h, cfg, *, train: bool = False, cap_tokens: Optional[int] = None):
    """FFN half of a block (dense, or MoE with its shared and dense
    residual MLPs) -> (out, MoE load-balance aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if "moe" in p:
        m, aux = L.moe_block(p["moe"], h, cfg, train=train, cap_tokens=cap_tokens)
        if "shared_mlp" in p:
            m = m + L.mlp_block(p["shared_mlp"], h)
        if "dense_mlp" in p:
            m = m + L.mlp_block(p["dense_mlp"], h)
    else:
        m = L.mlp_block(p["mlp"], h)
    if "ln2_post" in p:
        m = norm(m, p["ln2_post"], cfg)
    return m, aux


def _mlp_section(p, h, cfg, cap_tokens: Optional[int] = None):
    """Inference-mode FFN half of a block."""
    return _ffn(p, h, cfg, cap_tokens=cap_tokens)[0]


def block_apply(p: Params, x, cfg, *, kind: str, positions, train: bool = False,
                use_flash: bool = False):
    """Full-sequence block (prefill without cache) -> (x, MoE aux)."""
    h = norm(x, p["ln1"], cfg)
    a = L.attention_block(p["attn"], h, cfg, kind=kind, positions=positions,
                          theta=_theta(cfg, kind), use_flash=use_flash)
    if "ln1_post" in p:
        a = norm(a, p["ln1_post"], cfg)
    x = x + a
    h = norm(x, p["ln2"], cfg)
    m, aux = _ffn(p, h, cfg, train=train)
    return x + m, aux


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg) -> Params:
    """Random params on ``gen.device``, drawn from ``gen``."""
    dtype = cfg.dtype
    unit, R, tail = pattern_unit(cfg)
    params = L.init_embed(gen, cfg, dtype)
    params["blocks"] = [init_block(gen, cfg, dtype, lead=(R,)) for _ in unit]
    params["tail"] = [init_block(gen, cfg, dtype) for _ in range(tail)]
    params["ln_f"] = L.norm_init(cfg.d_model, dtype, cfg.norm_type,
                                 device=gen.device)
    return params


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------

def _trunk(params: Params, cfg, x, *, train: bool, use_flash: bool, remat: bool,
           inputs: Optional[list] = None):
    """Every block over x [B, S, d], then the final norm -> (x, the summed
    MoE aux).  With ``remat``
    (and grad mode on) each layer of ``blocks`` runs under
    ``torch.utils.checkpoint``, which keeps only its input for the
    backward pass and recomputes the rest, as ``jax.checkpoint`` of the
    reference's scan body does; the ``tail`` layers are not
    rematerialized, as in the reference.  ``inputs``, a list, receives
    every layer's input in execution order, and turns remat off."""
    B, S, _ = x.shape
    span = position_span()          # a piece of a split along the positions: its block's,
    first = span[0] if span is not None else 0      # after the image it holds whole
    pre = cfg.n_img_tokens if cfg.family == "vlm" and span is not None else 0
    positions = torch.cat([torch.arange(pre, device=x.device),
                           torch.arange(pre + first, first + S, device=x.device)]).expand(B, S)
    unit, R, _ = pattern_unit(cfg)
    remat = remat and torch.is_grad_enabled() and inputs is None

    def one(p, x, kind):
        return block_apply(p, x, cfg, kind=kind, positions=positions,
                           train=train, use_flash=use_flash)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (kind, p) in enumerate(_layers(params, cfg)):
        if inputs is not None:
            inputs.append(x)
        if remat and i < R * len(unit):
            x, a = checkpoint(one, p, x, kind)
        else:
            x, a = one(p, x, kind)
        aux = aux + a
    return norm(x, params["ln_f"], cfg), aux


def embed_inputs(params: Params, cfg, tokens, img_embs=None):
    """The token embeddings [B, S, d], a vlm's image embeddings [B, n_img,
    d] ahead of them when given (cast to their dtype, not scaled).  A
    vlm's piece of a split along the positions holds its image whole."""
    if cfg.family == "vlm" and img_embs is None and position_span() is not None:
        raise ValueError("a vlm's split of the positions needs its img_embs")
    x = L.embed(params, cfg, tokens)
    if cfg.family == "vlm" and img_embs is not None:
        x = torch.cat([img_embs.to(x.dtype), x], dim=1)
    return x


def forward(params: Params, cfg, tokens, *, img_embs=None, train: bool = False,
            use_flash: bool = False, remat: bool = True, capture: bool = False):
    """Returns (logits [B, n_img + S, V], aux dict).  ``capture`` adds the
    reference's ``aux["captures"]`` (``"blocks"``: for each member of the
    pattern unit its layers' inputs [R, B, S, d]; ``"tail"``: the tail
    layers' inputs, each [B, S, d]; a vlm's include its image positions)
    and ``aux["final_hidden"]`` (after the final norm), and turns remat
    off."""
    inputs = [] if capture else None
    x, aux = _trunk(params, cfg, embed_inputs(params, cfg, tokens, img_embs), train=train,
                    use_flash=use_flash, remat=remat, inputs=inputs)
    logits = L.unembed(params, cfg, x)
    out = {"moe_aux": aux}
    if capture:
        unit, R, _ = pattern_unit(cfg)
        n = R * len(unit)
        out["captures"] = {"blocks": [torch.stack(inputs[u:n:len(unit)])
                                      for u in range(len(unit))],
                           "tail": inputs[n:]}
        out["final_hidden"] = x
    return logits, out


def loss_fn(params: Params, cfg, tokens, labels, *, img_embs=None,
            xent_chunk: int = 0, remat: bool = True, aux_weight: float = 0.01):
    """Causal LM loss: the summed cross-entropy over every position divided
    by ``labels.numel()`` (padding positions count, with label 0, as in
    the reference), plus ``aux_weight`` times the summed MoE aux.  ``xent_chunk`` > 0 streams the vocab projection
    over sequence chunks so [B, S, V] logits are never materialized;
    with ``remat`` each chunk's logits are recomputed in the backward
    pass instead of kept.  A vlm's loss is taken on the text positions
    only, after its ``img_embs``."""
    n_text = tokens.shape[1]
    if not xent_chunk:
        logits, aux = forward(params, cfg, tokens, img_embs=img_embs, train=True,
                              remat=remat)
        if cfg.family == "vlm":
            logits = logits[:, -n_text:]
        return _xent(logits, labels) / labels.numel() + aux_weight * aux["moe_aux"]
    x, aux = _trunk(params, cfg, embed_inputs(params, cfg, tokens, img_embs), train=True,
                    use_flash=False, remat=remat)
    if cfg.family == "vlm":
        x = x[:, -n_text:]
    B, S, d = x.shape
    nchunks = max(S // xent_chunk, 1)
    xcs = x.reshape(B, nchunks, -1, d)
    ycs = labels.reshape(B, nchunks, -1)

    def chunk(xc, yc):
        return _xent(L.unembed(params, cfg, xc), yc)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(nchunks):
        if remat and torch.is_grad_enabled():
            total = total + checkpoint(chunk, xcs[:, c], ycs[:, c])
        else:
            total = total + chunk(xcs[:, c], ycs[:, c])
    return total / labels.numel() + aux_weight * aux


def _xent(logits, labels) -> torch.Tensor:
    """Summed token cross-entropy of logits [..., V] against int labels
    [...], in f32."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - gold.float()).sum()


# ---------------------------------------------------------------------------
# prefill: forward + cache population
# ---------------------------------------------------------------------------

def _slots(cfg, kind: str, max_len: int, compact_local: bool) -> int:
    """A layer's cache length: a local layer of the compact layout keeps
    a circular buffer of min(window, max_len) slots, every other layer
    ``max_len``."""
    if kind == "L" and compact_local:
        return min(cfg.window_size, max_len)
    return max_len


def _empty_cache(cfg, batch: int, max_len: int, dtype, device, compact_local: bool):
    """Contiguous cache of zeros, [R, batch, T, K, hd] per unit position
    (T from :func:`_slots`)."""
    unit, R, tail = pattern_unit(cfg)
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim

    def entry(kind, lead):
        shape = (*lead, batch, _slots(cfg, kind, max_len, compact_local), K, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {"blocks": [entry(kind, (R,)) for kind in unit],
            "tail": [entry(unit[i % len(unit)], ()) for i in range(tail)]}


def prefill(params: Params, cfg, tokens, *, img_embs=None, max_len: int,
            compact_local: bool = True, use_flash: bool = False,
            cap_tokens: Optional[int] = None):
    """Run the prompt, return (logits [B, n_img + S, V], populated cache).

    Rows are right-padded; the caller gathers each row's last-valid-token
    logits (a vlm's text follows its ``img_embs``, whose KV fills the
    first n_img slots).  Cache slots are absolute with
    ``compact_local=False`` (the serving layout); by default a local
    layer keeps only its window, circular (:func:`init_cache`), which
    holds only for rows of equal length: a right-padded shorter row
    would lose its real positions to the roll.  ``cap_tokens``: the token
    count that decides MoE capacity (``L.moe_block``; default the whole
    batch).
    """
    x = embed_inputs(params, cfg, tokens, img_embs)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    cache = _empty_cache(cfg, B, max_len, cfg.dtype, x.device, compact_local)
    for (kind, p), (_, c) in zip(_layers(params, cfg), _layers(cache, cfg)):
        x = block_prefill(p, c, x, cfg, kind=kind, positions=positions,
                          use_flash=use_flash, cap_tokens=cap_tokens)
    x = norm(x, params["ln_f"], cfg)
    return L.unembed(params, cfg, x), cache


def block_prefill(p, c, x, cfg, *, kind: str, positions, ring: bool = True,
                  use_flash: bool = False, cap_tokens: Optional[int] = None):
    """Full block (attn + FFN) over a whole prompt x [B, S, d]: the last
    min(S, T) positions' k/v go into the per-row cache ``c`` ([B, T, K,
    hd], written in place; T is the cache's ``max_len``, or a compact
    local layer's window), rolled so that position p sits at slot p % T when ``ring``
    (the dense layout), in order otherwise (the hybrid's shared sites, as
    the reference keeps them)."""
    B, S, _ = x.shape
    h = norm(x, p["ln1"], cfg)
    q, k, v = L._qkv(p["attn"], h, cfg, positions, _theta(cfg, kind))
    if use_flash:
        out = L.flash_attention(q, k, v, causal=True,
                                window=cfg.window_size if kind == "L" else 0,
                                cap=cfg.attn_softcap)
    else:
        out = L.best_attention(q, k, v, kind=kind, cfg=cfg)
    a = matmul(out.reshape(B, S, -1), p["attn"]["wo"])
    if "ln1_post" in p:
        a = norm(a, p["ln1_post"], cfg)
    x = x + a
    h = norm(x, p["ln2"], cfg)
    x = x + _mlp_section(p, h, cfg, cap_tokens)
    T = c["k"].shape[-3]
    keep = min(S, T)
    shift = (S - T) % T if ring and S >= T else 0
    for name, t in (("k", k), ("v", v)):
        t = t[:, S - keep:].to(cfg.dtype)
        if shift:
            t = torch.roll(t, shift, dims=1)
        c[name][:, :keep] = t
    return x


# ---------------------------------------------------------------------------
# continued prefill: suffix chunk against a prefilled prefix cache
# ---------------------------------------------------------------------------

def _masked_chunk(q, k_cache, v_cache, valid, cap):
    """q [B,S,H,D], cache [B,T,K,D], valid [B,S,T] bool (True = attend)."""
    B, S, H, D = q.shape
    K = k_cache.shape[2]
    qg = q.reshape(B, S, K, H // K, D)
    out = L._sdpa(qg, k_cache, v_cache, valid[:, None, None], cap)
    return out.reshape(B, S, H, D)


def block_prefill_from(p, c, x, cfg, *, kind: str, start: int, max_len: int,
                       cap_tokens: Optional[int] = None):
    """Full block (attn + FFN) over an S-token chunk whose first token sits
    at absolute position ``start``: the chunk's k/v are written into the
    per-row cache ``c`` ([B, T, K, hd], written in place) at slots
    [start, start+S), and queries attend to every cached slot <= their
    own position (windowed for local layers)."""
    B, S, _ = x.shape
    h = norm(x, p["ln1"], cfg)
    positions = (start + torch.arange(S, device=x.device)).expand(B, S)
    q, k, v = L._qkv(p["attn"], h, cfg, positions, _theta(cfg, kind))
    c["k"][:, start:start + S] = k.to(c["k"].dtype)
    c["v"][:, start:start + S] = v.to(c["v"].dtype)
    T = c["k"].shape[1]
    slots = torch.arange(T, device=x.device)[None, None, :]
    qpos = positions[:, :, None]
    valid = slots <= qpos
    if kind == "L":
        valid = valid & (slots > qpos - cfg.window_size)
    out = _masked_chunk(q, c["k"], c["v"], valid, cfg.attn_softcap)
    a = matmul(out.reshape(B, S, -1), p["attn"]["wo"])
    if "ln1_post" in p:
        a = norm(a, p["ln1_post"], cfg)
    x = x + a
    h = norm(x, p["ln2"], cfg)
    return x + _mlp_section(p, h, cfg, cap_tokens)


def prefill_from(params: Params, cfg, cache, tokens, start: int, *, max_len: int,
                 cap_tokens: Optional[int] = None):
    """Prefill only the suffix ``tokens`` [B,S] whose shared prefix
    (absolute positions [0, start)) is resident in ``cache``.

    ``cache`` is a contiguous cache of batch 1 (one prefix state for
    every row) or of batch B; it is not modified.  Returns (logits
    [B,S,V], the populated batch-B cache), as ``prefill`` on
    prefix+suffix would, spending trunk FLOPs on S tokens only."""
    x = L.embed(params, cfg, tokens)
    B = x.shape[0]
    start = int(start)

    def rows(a):                        # [..., Bc, T, K, hd] -> [..., B, ...]
        lead = a.shape[:-4]
        return a.expand(*lead, B, *a.shape[-3:]).clone()

    new = {sec: [{n: rows(t) for n, t in e.items()} for e in cache[sec]]
           for sec in ("blocks", "tail")}
    for (kind, p), (_, c) in zip(_layers(params, cfg), _layers(new, cfg)):
        x = block_prefill_from(p, c, x, cfg, kind=kind, start=start,
                               max_len=max_len, cap_tokens=cap_tokens)
    x = norm(x, params["ln_f"], cfg)
    return L.unembed(params, cfg, x), new


# ---------------------------------------------------------------------------
# contiguous KV cache: per-row decode at absolute slots
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, *, compact_local: bool = True,
               device="cuda"):
    """Cache tree mirroring the block structure ([R, batch, T, K, hd] per
    unit position), the layout ``prefill`` returns.  With
    ``compact_local`` a local (``"L"``) layer keeps a circular buffer of
    T = min(window, max_len) slots, position p at slot p % T (gemma3-1b's
    long-context decode keeps 22 of its 26 layers at 512 slots); every
    other layer, and every layer without it (the serving engine's layout,
    which serves rows of different lengths), keeps ``max_len`` absolute
    slots."""
    return _empty_cache(cfg, batch, max_len, cfg.dtype, device, compact_local)


def cache_spec(cfg, batch: int, max_len: int, *, compact_local: bool = True):
    """:func:`init_cache`'s tree on the ``meta`` device: shapes and dtypes,
    no storage (the dry run's)."""
    return init_cache(cfg, batch, max_len, compact_local=compact_local, device="meta")


def _decode_attn_block(p, c, x, cfg, *, kind: str, pos, max_len: int):
    """One decode block's attention: writes this step's k/v into ``c``
    ([B, T, K, hd], in place) at slot ``pos % T`` of each row and attends
    to the valid slots.  pos: [B] int, each row's own position.  A local
    layer whose T is below ``max_len`` is a compact circular buffer, every
    slot of which is valid once pos >= T; otherwise slots are absolute.
    A sharded ``c`` (a mesh engine's, or the dry run's placed cache) is
    written at the same slot and attended piece by piece where it lives
    (``models/sharded_cache.py``): ``valid`` is built whole on the first
    device, and each piece of a cache split along its positions takes its
    columns."""
    B = x.shape[0]
    h = norm(x, p["ln1"], cfg)
    T = c["k"].shape[-3]
    slots = torch.arange(T, device=x.device)[None, :]
    valid = slots <= pos[:, None]
    if kind == "L" and T < max_len:
        valid |= pos[:, None] >= T
    elif kind == "L":
        valid &= slots > pos[:, None] - cfg.window_size
    if isinstance(c["k"], ShardedTensor):
        a = SC.decode_attention(p["attn"], h, c, cfg, pos=pos, valid=valid,
                                theta=_theta(cfg, kind), cap=cfg.attn_softcap)
        return norm(a, p["ln1_post"], cfg) if "ln1_post" in p else a
    q, k, v = L._qkv(p["attn"], h, cfg, pos[:, None], _theta(cfg, kind))
    bidx, idx = torch.arange(B, device=x.device), pos % T
    c["k"][bidx, idx] = k[:, 0].to(c["k"].dtype)
    c["v"][bidx, idx] = v[:, 0].to(c["v"].dtype)
    out = _masked_decode(q, c["k"], c["v"], valid, cfg.attn_softcap)
    a = matmul(out.reshape(B, 1, -1), p["attn"]["wo"])
    if "ln1_post" in p:
        a = norm(a, p["ln1_post"], cfg)
    return a


def block_decode(p, c, x, cfg, *, kind: str, pos, max_len: int):
    """Full block (attn + FFN) for one decode token per row against the
    contiguous cache ``c`` ([B, T, K, hd], written in place)."""
    x = x + _decode_attn_block(p, c, x, cfg, kind=kind, pos=pos, max_len=max_len)
    h = norm(x, p["ln2"], cfg)
    return x + _mlp_section(p, h, cfg)


def decode_step(params: Params, cfg, cache, tokens, pos, *, max_len: int):
    """One token for every row of a contiguous cache.  tokens [B,1]; pos a
    scalar or [B] int (per-row positions).  Writes this step's K/V into
    ``cache`` in place; returns (logits [B,1,V], cache).  ``max_len`` is
    the cache's slot count (the reference's signature).  The linears go
    through ``matmul``, so the scoped kernel backend picks K2 or K4 for
    compressed weights; attention is the plain masked decode.  On a
    compact cache (``init_cache(compact_local=True)``) every row must
    have been prefilled at the same length: ``prefill`` rolls every row
    by the padded length."""
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, device=tokens.device).long().expand(B)
    x = L.embed(params, cfg, tokens)
    for (kind, p), (_, c) in zip(_layers(params, cfg), _layers(cache, cfg)):
        x = block_decode(p, c, x, cfg, kind=kind, pos=pos, max_len=max_len)
    x = norm(x, params["ln_f"], cfg)
    return L.unembed(params, cfg, x), cache


def insert_rows(cfg, state, rows, slot_idxs):
    """The contiguous serving layout's admission: the batch-n caches
    ``rows`` (from ``prefill``) written into the batch-slots cache
    ``state`` at ``slot_idxs`` (a tensor, or a mesh engine's
    ``sharded_cache.RowSplit``), in place."""
    for sec, axis in (("blocks", 1), ("tail", 0)):
        for pool, row in zip(state[sec], rows[sec]):
            for n in ("k", "v"):
                SC.write_rows(pool[n], axis, slot_idxs, row[n])
    return state


# ---------------------------------------------------------------------------
# paged KV cache
# ---------------------------------------------------------------------------
#
# The serving engine keeps one global pool of fixed-size blocks per layer
# — stacked entries [R, num_blocks, bs, K, hd], tail entries
# [num_blocks, bs, K, hd] — plus a per-slot block table [slots, T // bs]
# of block ids shared by every layer.  Admission scatters per-row prefill
# KV into the table's blocks; a shared template prefix is seeded once
# and aliased by table entries.  Decode runs batched over all slots and
# attends through the table: a gather in PyTorch (reference backend) or
# the paged CUDA kernel (cuda backend).

def init_paged_cache(cfg, num_blocks: int, block_size: int, device="cuda"):
    """Block-pool cache tree mirroring the block structure."""
    unit, R, tail = pattern_unit(cfg)
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim

    def entry(lead):
        shape = (*lead, num_blocks, block_size, K, hd)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}

    return {"blocks": [entry((R,)) for _ in unit],
            "tail": [entry(()) for _ in range(tail)]}


def paged_write_blocks(pool_entry, row_entry, write_ids, *, block_size: int):
    """Scatter contiguous per-row KV into pool blocks, in place.

    ``row_entry`` leaves are [R, n, T, K, hd] (stacked) or [n, T, K, hd]
    (tail), as ``prefill`` returns them; ``write_ids`` [n, T // bs] names
    the destination block per chunk (the engine points skipped chunks —
    prefix blocks already aliased — at its trash block)."""
    bs = block_size
    ids = torch.as_tensor(write_ids, device=pool_entry["k"].device).reshape(-1).long()
    for name in ("k", "v"):
        pool, rows = pool_entry[name], row_entry[name]
        K, hd = rows.shape[-2], rows.shape[-1]
        n, T = rows.shape[-4], rows.shape[-3]
        lead = rows.shape[:-4]
        r = rows.reshape(*lead, n * (T // bs), bs, K, hd).to(pool.dtype)
        pool.index_copy_(len(lead), ids, r)
    return pool_entry


def paged_insert(cfg, state, rows, write_ids, *, block_size: int):
    """Scatter an admission batch's row caches (from batched prefill)
    into the paged pools at ``write_ids`` [n, T // block_size]."""
    for sec in ("blocks", "tail"):
        for pool_entry, row_entry in zip(state[sec], rows[sec]):
            paged_write_blocks(pool_entry, row_entry, write_ids,
                               block_size=block_size)
    return state


def paged_seed(cfg, state, entry_state, write_ids, *, block_size: int):
    """Write a prefix-cache entry's KV (a batch-1 contiguous cache) into
    the shared blocks named by ``write_ids`` [1, T // block_size]."""
    return paged_insert(cfg, state, entry_state, write_ids, block_size=block_size)


def _masked_decode(q, k_cache, v_cache, valid, cap):
    """q [B,1,H,D], cache [B,T,K,D], valid [B,T] bool."""
    B, _, H, D = q.shape
    K = k_cache.shape[2]
    qg = q.reshape(B, 1, K, H // K, D)
    out = L._sdpa(qg, k_cache, v_cache, valid[:, None, None, None, :], cap)
    return out.reshape(B, 1, H, D)


def _paged_attn_block(p, c, x, cfg, *, kind: str, pos, tables,
                      block_size: int, max_len: int):
    """Decode attention against block pools ``c`` ({"k","v"}
    [nb, bs, K, hd]) through ``tables`` [B, T // bs].  pos: [B] int.
    The scoped kernel backend picks the attention, as it picks the int8
    matmul: the paged kernel on ``"cuda"``, a PyTorch gather otherwise."""
    B = x.shape[0]
    h = norm(x, p["ln1"], cfg)
    q, k, v = L._qkv(p["attn"], h, cfg, pos[:, None], _theta(cfg, kind))
    nb, bs, K, hd = c["k"].shape
    nblk = max_len // bs
    # write this step's k/v into each slot's current block; every slot
    # writes a distinct row (tables point active slots past any aliased
    # prefix blocks, idle slots at their private blocks)
    flat = tables[torch.arange(B, device=x.device), pos // bs].long() * bs + pos % bs
    c["k"].view(nb * bs, K, hd).index_copy_(0, flat, k[:, 0].to(c["k"].dtype))
    c["v"].view(nb * bs, K, hd).index_copy_(0, flat, v[:, 0].to(c["v"].dtype))
    win = cfg.window_size if kind == "L" else 0
    if current_backend(x.device) == "cuda":
        out = kops.paged_attention(q, c["k"], c["v"], tables, pos + 1,
                                   softcap=cfg.attn_softcap, window=win)
    else:
        tbl = tables.long()
        gk = c["k"][tbl].reshape(B, nblk * bs, K, hd)
        gv = c["v"][tbl].reshape(B, nblk * bs, K, hd)
        slots = torch.arange(nblk * bs, device=x.device)[None, :]
        valid = slots <= pos[:, None]
        if win:
            valid &= slots > pos[:, None] - win
        out = _masked_decode(q, gk, gv, valid, cfg.attn_softcap)
    a = matmul(out.reshape(B, 1, -1), p["attn"]["wo"])
    if "ln1_post" in p:
        a = norm(a, p["ln1_post"], cfg)
    return a


def paged_block_decode(p, c, x, cfg, *, kind: str, pos, tables, block_size: int,
                       max_len: int):
    """Full block (attn + FFN) for one decode token per slot against the
    block pools ``c`` ({"k","v"} [nb, bs, K, hd], written in place)."""
    x = x + _paged_attn_block(p, c, x, cfg, kind=kind, pos=pos, tables=tables,
                              block_size=block_size, max_len=max_len)
    h = norm(x, p["ln2"], cfg)
    return x + _mlp_section(p, h, cfg)


def paged_decode_step(params: Params, cfg, cache, tables, tokens, pos, *,
                      block_size: int, max_len: int):
    """One token for every slot against the paged pools.  tokens [B,1];
    pos [B] int; tables [B, max_len // block_size] int32.  Writes this
    step's K/V into ``cache`` in place; returns (logits [B,1,V], cache)."""
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, device=tokens.device).long().expand(B)
    x = L.embed(params, cfg, tokens)
    for (kind, p), (_, c) in zip(_layers(params, cfg), _layers(cache, cfg)):
        x = paged_block_decode(p, c, x, cfg, kind=kind, pos=pos, tables=tables,
                               block_size=block_size, max_len=max_len)
    x = norm(x, params["ln_f"], cfg)
    return L.unembed(params, cfg, x), cache
