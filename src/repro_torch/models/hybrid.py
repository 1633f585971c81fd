"""Zamba2-style hybrid: a Mamba2 backbone and one SHARED attention+MLP block.

Layout: ``n_layers`` block applications where every
(shared_attn_every + 1)-th position applies the *same* transformer block.
The reference scans over (K Mamba layers + the shared block) groups,
then over the remaining Mamba layers; the port loops over them in
Python and keeps the reference's param layout: ``mamba_groups`` leaves
[G, K, ...], ``shared`` one block, ``mamba_tail`` leaves [tail, ...] (or
``None``), ``ln_f``.

Decode state: each Mamba layer's SSD and conv state, plus one KV cache
per shared site (the same weights, distinct activations per site).  The
contiguous cache is ``{"mamba_groups": {"h", "conv"} [G, K, B, ...],
"shared_kv": {"k", "v"} [n_sites, B, T, Kh, hd], "mamba_tail": [tail, B,
...] or None}``.  The paged layout pools only ``shared_kv``
([n_sites, num_blocks, bs, Kh, hd], every site indexed by the same block
table) and keeps the recurrent states with the slot axis inside the
group axes.  Where the reference returns new states (jit donation), the
port writes them in place and returns the same dicts.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import sharded_cache as SC
from repro_torch.models import transformer as TF
from repro_torch.models.layers import norm
from repro_torch.models.transformer import layer_slice

Params = Dict[str, Any]


def layout(cfg):
    """(n_groups, group_k, n_tail_mamba, n_sites)."""
    k = cfg.shared_attn_every
    n_sites = cfg.n_layers // (k + 1)
    n_mamba = cfg.n_layers - n_sites
    tail = n_mamba - n_sites * k
    return n_sites, k, tail, n_sites


def init_params(gen: torch.Generator, cfg) -> Params:
    """Random params on ``gen.device``, drawn from ``gen``."""
    dtype = cfg.dtype
    G, K, tail, _ = layout(cfg)
    params = L.init_embed(gen, cfg, dtype)
    params["mamba_groups"] = M.init_layer(gen, cfg, dtype, lead=(G, K))
    params["shared"] = TF.init_block(gen, cfg, dtype)
    params["mamba_tail"] = M.init_layer(gen, cfg, dtype, lead=(tail,)) if tail else None
    params["ln_f"] = L.norm_init(cfg.d_model, dtype, cfg.norm_type, device=gen.device)
    return params


def _group(tree, g: int):
    """Group ``g`` of a [G, K, ...] state tree (a mesh engine's sharded
    leaves sliced piece by piece)."""
    return layer_slice(tree, g)


def _tail(params, cfg, cache, x, lengths=None):
    """The trailing Mamba layers, their states updated in place."""
    if params["mamba_tail"] is None:
        return x
    return M.stack_apply(params["mamba_tail"], cache["mamba_tail"], x, cfg,
                         lengths=lengths)[0]


def _head(params, cfg, x):
    return L.unembed(params, cfg, norm(x, params["ln_f"], cfg))


# ---------------------------------------------------------------------------
# forward (no cache)
# ---------------------------------------------------------------------------

def forward(params: Params, cfg, tokens, *, train: bool = False, remat: bool = True,
            capture: bool = False, use_flash: bool = False):
    """Returns (logits [B,S,V], aux dict).  With ``remat`` (and grad mode
    on) each group runs under ``torch.utils.checkpoint``, as
    ``jax.checkpoint`` of the reference's scan body.  The shared block's
    attention is ``best_attention``: the reference's hybrid takes no
    ``use_flash``.  ``capture`` adds ``aux["captures"]`` ({"blocks": [the
    groups' inputs, G x [B, S, d] stacked], "tail": []}) and
    ``aux["final_hidden"]``, as the reference's, and turns remat off."""
    x = L.embed(params, cfg, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    G, K, _, _ = layout(cfg)
    remat = remat and torch.is_grad_enabled() and not capture
    inputs = []

    def body(group, xc):
        for u in range(K):
            xc, _ = M.block_apply(layer_slice(group, u), xc, cfg)
        return TF.block_apply(params["shared"], xc, cfg, kind="G", positions=positions,
                              train=train)[0]

    for g in range(G):
        if capture:
            inputs.append(x)
        group = layer_slice(params["mamba_groups"], g)
        x = checkpoint(body, group, x, use_reentrant=False) if remat else body(group, x)
    if params["mamba_tail"] is not None:
        for i in range(params["mamba_tail"]["A_log"].shape[0]):
            x, _ = M.block_apply(layer_slice(params["mamba_tail"], i), x, cfg)
    h = norm(x, params["ln_f"], cfg)
    aux = {"moe_aux": torch.zeros((), dtype=torch.float32, device=x.device)}
    if capture:
        aux["captures"] = {"blocks": [torch.stack(inputs)], "tail": []}
        aux["final_hidden"] = h
    return L.unembed(params, cfg, h), aux


# ---------------------------------------------------------------------------
# contiguous cache / decode / prefill
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, *, compact_local: bool = True,
               device="cuda"):
    """Zero recurrent states and per-site KV at absolute slots (``device``
    may be ``"meta"``: the pool sizes a slot from the shapes alone).
    ``compact_local`` does not apply: the shared sites are global (the
    reference ignores it too)."""
    G, K, tail, n_sites = layout(cfg)
    Kh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (n_sites, batch, max_len, Kh, hd)
    return {"mamba_groups": M.init_layer_state(cfg, batch, cfg.dtype, device, lead=(G, K)),
            "shared_kv": {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                          "v": torch.zeros(shape, dtype=cfg.dtype, device=device)},
            "mamba_tail": (M.init_layer_state(cfg, batch, cfg.dtype, device, lead=(tail,))
                           if tail else None)}


def _site(kv, g: int):
    return layer_slice(kv, g)


def decode_step(params: Params, cfg, cache, tokens, pos, *, max_len: int):
    """One token for every row of a contiguous cache.  tokens [B,1]; pos a
    scalar or [B] int.  Updates ``cache`` in place; returns (logits
    [B,1,V], cache)."""
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, device=tokens.device).long().expand(B)
    x = L.embed(params, cfg, tokens)
    G = layout(cfg)[0]
    for g in range(G):
        states = _group(cache["mamba_groups"], g)
        x, _ = M.stack_apply(layer_slice(params["mamba_groups"], g), states, x, cfg)
        x = TF.block_decode(params["shared"], _site(cache["shared_kv"], g), x, cfg,
                            kind="G", pos=pos, max_len=max_len)
    x = _tail(params, cfg, cache, x)
    return _head(params, cfg, x), cache


def prefill(params: Params, cfg, tokens, *, max_len: int, lengths=None,
            compact_local: bool = True, use_flash: bool = False, cap_tokens=None):
    """Run the prompt, return (logits [B,S,V], populated cache).  Rows are
    right-padded; ``lengths`` [B] (their real token counts) keeps the
    padding out of the recurrent states.  The shared sites' attention is
    ``best_attention`` (K3 for long prompts on the cuda backend), as in
    the reference; ``compact_local``, ``use_flash`` and ``cap_tokens`` do
    not apply."""
    x = L.embed(params, cfg, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    cache = init_cache(cfg, B, max_len, device=x.device)
    G = layout(cfg)[0]
    for g in range(G):
        states = _group(cache["mamba_groups"], g)
        x, _ = M.stack_apply(layer_slice(params["mamba_groups"], g), states, x, cfg,
                             lengths=lengths)
        x = TF.block_prefill(params["shared"], _site(cache["shared_kv"], g), x, cfg,
                             kind="G", positions=positions, ring=False)
    x = _tail(params, cfg, cache, x, lengths)
    return _head(params, cfg, x), cache


def prefill_from(params: Params, cfg, cache, tokens, start: int, *, max_len: int,
                 lengths=None, cap_tokens=None):
    """Prefill only the suffix ``tokens`` [B,S] from a prefilled prefix
    ``cache`` (batch 1, broadcast to every row, or batch B; not
    modified): the Mamba states resume where the prefix left off, and the
    shared sites extend their KV at slots [start, start+S).  ``lengths``
    [B] are the suffixes' real token counts."""
    x = L.embed(params, cfg, tokens)
    B = x.shape[0]
    start = int(start)

    def rows(t, axis):                 # batch axis ``axis``: 1 or B -> B rows
        shape = list(t.shape)
        shape[axis] = B
        return t.expand(*shape).clone()

    new = {"mamba_groups": {n: rows(t, 2) for n, t in cache["mamba_groups"].items()},
           "shared_kv": {n: rows(t, 1) for n, t in cache["shared_kv"].items()},
           "mamba_tail": (None if cache["mamba_tail"] is None else
                          {n: rows(t, 1) for n, t in cache["mamba_tail"].items()})}
    G = layout(cfg)[0]
    for g in range(G):
        states = _group(new["mamba_groups"], g)
        x, _ = M.stack_apply(layer_slice(params["mamba_groups"], g), states, x, cfg,
                             lengths=lengths)
        x = TF.block_prefill_from(params["shared"], _site(new["shared_kv"], g), x, cfg,
                                  kind="G", start=start, max_len=max_len)
    x = _tail(params, cfg, new, x, lengths)
    return _head(params, cfg, x), new


_RECURRENT = (("mamba_groups", 2), ("mamba_tail", 1))       # (section, slot axis)


def _scatter(state, rows, slot_idxs, sections):
    """Write batch-n ``rows`` into ``state``'s slots ``slot_idxs`` (a
    tensor or a ``sharded_cache.RowSplit``), in place, for each (section,
    slot axis) of ``sections``; a mesh engine's sharded ``shared_kv``
    pieces each take their share."""
    for sec, axis in sections:
        if state[sec] is None:
            continue
        for n, t in state[sec].items():
            SC.write_rows(t, axis, slot_idxs, rows[sec][n])
    return state


def insert_rows(cfg, state, rows, slot_idxs):
    """The contiguous serving layout's admission: batch-n ``rows`` (from
    ``prefill``) written into the batch-slots ``state`` at ``slot_idxs``."""
    return _scatter(state, rows, slot_idxs, _RECURRENT + (("shared_kv", 1),))


# ---------------------------------------------------------------------------
# paged serving state
# ---------------------------------------------------------------------------

def init_paged_cache(cfg, slots: int, num_blocks: int, block_size: int, device="cuda"):
    """Slot-batched recurrent states ([G, K, slots, ...], [tail, slots,
    ...]) and the shared sites' KV block pools."""
    G, K, tail, n_sites = layout(cfg)
    Kh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (n_sites, num_blocks, block_size, Kh, hd)
    return {"mamba_groups": M.init_layer_state(cfg, slots, cfg.dtype, device, lead=(G, K)),
            "shared_kv": {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                          "v": torch.zeros(shape, dtype=cfg.dtype, device=device)},
            "mamba_tail": (M.init_layer_state(cfg, slots, cfg.dtype, device, lead=(tail,))
                           if tail else None)}


def paged_insert(cfg, state, rows, slot_idxs, write_ids, *, block_size: int):
    """Admit a batched prefill: recurrent states scatter into their slots,
    shared-site KV into the pool blocks at ``write_ids``; in place."""
    _scatter(state, rows, slot_idxs, _RECURRENT)
    TF.paged_write_blocks(state["shared_kv"], rows["shared_kv"], write_ids,
                          block_size=block_size)
    return state


def paged_seed(cfg, state, entry_state, write_ids, *, block_size: int):
    """Seed shared prefix blocks from a prefix-cache entry.  Only the
    attention KV is positional; the entry's recurrent states are consumed
    per row by ``prefill_from`` instead."""
    TF.paged_write_blocks(state["shared_kv"], entry_state["shared_kv"], write_ids,
                          block_size=block_size)
    return state


def paged_decode_step(params: Params, cfg, cache, tables, tokens, pos, *,
                      block_size: int, max_len: int):
    """One token for every slot: each site attends through ``tables`` on
    its own [num_blocks, bs, Kh, hd] pools (K1 on the cuda backend, one
    launch per site).  Updates ``cache`` in place."""
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, device=tokens.device).long().expand(B)
    x = L.embed(params, cfg, tokens)
    G = layout(cfg)[0]
    for g in range(G):
        states = _group(cache["mamba_groups"], g)
        x, _ = M.stack_apply(layer_slice(params["mamba_groups"], g), states, x, cfg)
        x = TF.paged_block_decode(params["shared"], _site(cache["shared_kv"], g), x, cfg,
                                  kind="G", pos=pos, tables=tables,
                                  block_size=block_size, max_len=max_len)
    x = _tail(params, cfg, cache, x)
    return _head(params, cfg, x), cache
