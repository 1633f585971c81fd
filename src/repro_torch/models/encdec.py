"""Whisper-style encoder-decoder backbone (the encdec family).

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``enc_inputs`` [B, Te, d_model].  Learned
absolute positions (``pos_enc``, ``pos_dec``), LayerNorm, ungated GELU
MLPs (the tanh form, ``jax.nn.gelu``'s default), MHA without rope.  The
layers are unrolled lists, ``enc_blocks`` and ``dec_blocks``, not a
stacked axis, so a weight's path carries its layer index
(``dec_blocks.3.xattn.wq``).

Serving keeps a contiguous cache: the decoder's self-attention K/V at
absolute slots ([B, max_len, K, hd] a layer), the cross-attention K/V
computed once from the encoder's output at ``prefill`` and padded or
truncated to ``enc_ctx`` positions, and ``enc_len`` [B] int32, the real
encoder length that decode masks the cross-attention by.  ``prefill``'s
own cross-attention attends to every encoder position, truncated or not,
as the reference's does.  The reference computes the cross K/V
projections twice in ``prefill`` (once for the cache, once inside its
``_mha``); the port computes them once and uses them for both, so an
admission runs each ``xattn.wk``/``wv`` once a layer.  Decode writes the
step's K/V into the cache in place and returns the same dicts.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.core.compressed import ShardedTensor
from repro_torch.distributed.data_parallel import checkpoint
from repro_torch.models import layers as L
from repro_torch.models import sharded_cache as SC
from repro_torch.models import transformer as TF
from repro_torch.models.layers import matmul, norm

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_gelu_mlp(gen, cfg, dtype):
    scale = 1.0 / math.sqrt(2 * (cfg.n_enc_layers + cfg.n_dec_layers))
    return {"wi": L.dense_init(gen, cfg.d_model, cfg.d_ff, dtype),
            "wo": L.dense_init(gen, cfg.d_ff, cfg.d_model, dtype, scale=scale)}


def _gelu_mlp(p, x):
    return matmul(torch.nn.functional.gelu(matmul(x, p["wi"]), approximate="tanh"), p["wo"])


def _ln(cfg, dtype, dev):
    return L.norm_init(cfg.d_model, dtype, cfg.norm_type, device=dev)


def _init_enc_block(gen, cfg, dtype):
    dev = gen.device
    return {"ln1": _ln(cfg, dtype, dev), "attn": L.init_attention(gen, cfg, dtype),
            "ln2": _ln(cfg, dtype, dev), "mlp": _init_gelu_mlp(gen, cfg, dtype)}


def _init_dec_block(gen, cfg, dtype):
    dev = gen.device
    return {"ln1": _ln(cfg, dtype, dev), "attn": L.init_attention(gen, cfg, dtype),
            "lnx": _ln(cfg, dtype, dev), "xattn": L.init_attention(gen, cfg, dtype),
            "ln2": _ln(cfg, dtype, dev), "mlp": _init_gelu_mlp(gen, cfg, dtype)}


def init_params(gen: torch.Generator, cfg) -> Params:
    """Random params on ``gen.device``, drawn from ``gen``."""
    dtype, dev = cfg.dtype, gen.device
    params = L.init_embed(gen, cfg, dtype)
    for name in ("pos_enc", "pos_dec"):
        w = torch.randn((cfg.max_seq, cfg.d_model), generator=gen, device=dev,
                        dtype=torch.float32)
        params[name] = (w * 0.01).to(dtype)
    params["enc_blocks"] = [_init_enc_block(gen, cfg, dtype) for _ in range(cfg.n_enc_layers)]
    params["dec_blocks"] = [_init_dec_block(gen, cfg, dtype) for _ in range(cfg.n_dec_layers)]
    params["ln_enc"] = _ln(cfg, dtype, dev)
    params["ln_f"] = _ln(cfg, dtype, dev)
    return params


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------

def _heads(t, cfg, n):
    B, S, _ = t.shape
    return t.reshape(B, S, n, cfg.resolved_head_dim)


def _mha(p, x, cfg, kv_x=None, *, causal: bool, kv=None):
    """Self- or cross-attention without rope -> (out, k, v).  ``kv``: the
    (k, v) of ``kv_x`` already projected."""
    B, S, _ = x.shape
    src = x if kv_x is None else kv_x
    q = _heads(matmul(x, p["wq"]), cfg, cfg.n_heads)
    if kv is None:
        kv = (_heads(matmul(src, p["wk"]), cfg, cfg.n_kv_heads),
              _heads(matmul(src, p["wv"]), cfg, cfg.n_kv_heads))
    k, v = kv
    out = L.best_attention(q, k, v, kind="G", cfg=cfg, causal=causal)
    return matmul(out.reshape(B, S, -1), p["wo"]), k, v


def _enc_block(p, x, cfg):
    a, _, _ = _mha(p["attn"], norm(x, p["ln1"], cfg), cfg, causal=False)
    x = x + a
    return x + _gelu_mlp(p["mlp"], norm(x, p["ln2"], cfg))


def _dec_block(p, x, enc_out, cfg):
    a, _, _ = _mha(p["attn"], norm(x, p["ln1"], cfg), cfg, causal=True)
    x = x + a
    a, _, _ = _mha(p["xattn"], norm(x, p["lnx"], cfg), cfg, kv_x=enc_out, causal=False)
    x = x + a
    return x + _gelu_mlp(p["mlp"], norm(x, p["ln2"], cfg))


def _run(blk, remat, *args):
    if remat and torch.is_grad_enabled():
        return checkpoint(blk, *args)
    return blk(*args)


def encode(params: Params, cfg, enc_inputs, *, remat: bool = True):
    """Encoder output [B, Te, d] (LayerNorm'd) of ``enc_inputs`` [B, Te, d];
    ``remat`` (with grad mode on) recomputes each block in the backward."""
    x = enc_inputs + params["pos_enc"][None, :enc_inputs.shape[1]]
    for p in params["enc_blocks"]:
        x = _run(lambda p_, x_: _enc_block(p_, x_, cfg), remat, p, x)
    return norm(x, params["ln_enc"], cfg)


def decode_train(params: Params, cfg, tokens, enc_out, pos_offset: int = 0, *,
                 remat: bool = True):
    """Decoder logits [B, S, V] of ``tokens`` [B, S] against ``enc_out``."""
    x = L.embed(params, cfg, tokens)
    x = x + params["pos_dec"][None, pos_offset:pos_offset + tokens.shape[1]]
    for p in params["dec_blocks"]:
        x = _run(lambda p_, x_, e_: _dec_block(p_, x_, e_, cfg), remat, p, x, enc_out)
    x = norm(x, params["ln_f"], cfg)
    return L.unembed(params, cfg, x)


def forward(params: Params, cfg, tokens, *, enc_inputs, train: bool = False,
            remat: bool = True, capture: bool = False, **_):
    """Returns (logits [B, S, V], aux dict).  ``capture`` is accepted and
    returns no captures, as the reference's encdec ``forward`` does."""
    enc_out = encode(params, cfg, enc_inputs, remat=remat and train)
    logits = decode_train(params, cfg, tokens, enc_out, remat=remat and train)
    return logits, {"moe_aux": torch.zeros((), dtype=torch.float32, device=logits.device)}


# ---------------------------------------------------------------------------
# serving: decoder self-attention KV + precomputed cross KV
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, *, compact_local: bool = True,
               device="cuda"):
    """The contiguous cache (``compact_local`` does not apply: there is no
    local layer to compact)."""
    dt, K, hd = cfg.dtype, cfg.n_kv_heads, cfg.resolved_head_dim

    def kv(T):
        return {"k": torch.zeros((batch, T, K, hd), dtype=dt, device=device),
                "v": torch.zeros((batch, T, K, hd), dtype=dt, device=device)}

    return {"self": [kv(max_len) for _ in range(cfg.n_dec_layers)],
            "cross": [kv(cfg.enc_ctx) for _ in range(cfg.n_dec_layers)],
            # the real encoder length: cross-attention skips padded slots
            "enc_len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _fit(t, n: int):
    """[B, Te, K, hd] padded with zeros or truncated to ``n`` positions."""
    Te = t.shape[1]
    if Te >= n:
        return t[:, :n].contiguous()
    return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n - Te))


def prefill(params: Params, cfg, tokens, *, enc_inputs, max_len: int, **_):
    """Encode, then run the decoder prompt ``tokens`` [B, S]; returns
    (logits [B, S, V], the populated cache)."""
    B, S = tokens.shape
    enc_out = encode(params, cfg, enc_inputs, remat=False)
    Te = enc_out.shape[1]
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    cache["enc_len"].fill_(min(Te, cfg.enc_ctx))
    x = L.embed(params, cfg, tokens)
    x = x + params["pos_dec"][None, :S]
    for p, cs, cx in zip(params["dec_blocks"], cache["self"], cache["cross"]):
        a, k, v = _mha(p["attn"], norm(x, p["ln1"], cfg), cfg, causal=True)
        x = x + a
        cs["k"][:, :S] = k.to(cs["k"].dtype)
        cs["v"][:, :S] = v.to(cs["v"].dtype)
        xp = p["xattn"]
        kv = (_heads(matmul(enc_out, xp["wk"]), cfg, cfg.n_kv_heads),
              _heads(matmul(enc_out, xp["wv"]), cfg, cfg.n_kv_heads))
        cx["k"], cx["v"] = (_fit(t, cfg.enc_ctx).to(cfg.dtype) for t in kv)
        a, _, _ = _mha(xp, norm(x, p["lnx"], cfg), cfg, kv_x=enc_out, causal=False, kv=kv)
        x = x + a
        x = x + _gelu_mlp(p["mlp"], norm(x, p["ln2"], cfg))
    x = norm(x, params["ln_f"], cfg)
    return L.unembed(params, cfg, x), cache


def _decode_attn(q, k_cache, v_cache, kv_len):
    """q [B,1,H,D] against cache [B,T,K,D], slots < ``kv_len`` [B]."""
    valid = torch.arange(k_cache.shape[1], device=q.device)[None, :] < kv_len[:, None]
    return TF._masked_decode(q, k_cache, v_cache, valid, 0.0)


def decode_step(params: Params, cfg, cache, tokens, pos, *, max_len: int):
    """One token for every row: tokens [B, 1], pos a scalar or [B] (each
    row's own position, which also indexes ``pos_dec``).  Writes the step's
    K/V into ``cache`` in place; returns (logits [B, 1, V], cache)."""
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, device=tokens.device).long().expand(B)
    H, K = cfg.n_heads, cfg.n_kv_heads
    x = L.embed(params, cfg, tokens)
    x = x + params["pos_dec"][pos][:, None]
    bidx = torch.arange(B, device=x.device)
    enc_len = cache["enc_len"]
    if not isinstance(enc_len, ShardedTensor):
        enc_len = enc_len.long()
    for p, cs, cx in zip(params["dec_blocks"], cache["self"], cache["cross"]):
        h = norm(x, p["ln1"], cfg)
        if isinstance(cs["k"], ShardedTensor):
            x = _sharded_decode_layer(p, cs, cx, x, h, cfg, pos, enc_len)
            continue
        q = _heads(matmul(h, p["attn"]["wq"]), cfg, H)
        k = _heads(matmul(h, p["attn"]["wk"]), cfg, K)
        v = _heads(matmul(h, p["attn"]["wv"]), cfg, K)
        cs["k"][bidx, pos] = k[:, 0].to(cs["k"].dtype)
        cs["v"][bidx, pos] = v[:, 0].to(cs["v"].dtype)
        out = _decode_attn(q, cs["k"], cs["v"], pos + 1)
        x = x + matmul(out.reshape(B, 1, -1), p["attn"]["wo"])
        h = norm(x, p["lnx"], cfg)
        qx = _heads(matmul(h, p["xattn"]["wq"]), cfg, H)
        out = _decode_attn(qx, cx["k"], cx["v"], enc_len)
        x = x + matmul(out.reshape(B, 1, -1), p["xattn"]["wo"])
        x = x + _gelu_mlp(p["mlp"], norm(x, p["ln2"], cfg))
    x = norm(x, params["ln_f"], cfg)
    return L.unembed(params, cfg, x), cache


def _sharded_decode_layer(p, cs, cx, x, h, cfg, pos, enc_len):
    """One decoder layer of ``decode_step`` over a mesh engine's sharded
    self and cross caches: both attentions run where their pieces live
    (``models/sharded_cache.py``); the cross cache is read only, and a
    slot-split ``enc_len`` masks each data position's rows with its own
    piece (pod x data pieces on the multi-pod mesh)."""
    T = cs["k"].shape[-3]
    valid = torch.arange(T, device=x.device)[None, :] <= pos[:, None]
    x = x + SC.decode_attention(p["attn"], h, cs, cfg, pos=pos, valid=valid)
    h = norm(x, p["lnx"], cfg)
    Tc = cx["k"].shape[-3]
    if isinstance(enc_len, ShardedTensor):     # each data position's rows, where they live
        valid = [torch.arange(Tc, device=e.device)[None, :] < e.long()[:, None]
                 for e in SC.dim_pieces(enc_len)]
    else:
        valid = torch.arange(Tc, device=x.device)[None, :] < enc_len[:, None]
    x = x + SC.decode_attention(p["xattn"], h, cx, cfg, pos=pos, valid=valid, write=False)
    return x + _gelu_mlp(p["mlp"], norm(x, p["ln2"], cfg))


def insert_rows(cfg, state, rows, slot_idxs):
    """The contiguous serving layout's admission: the batch-n caches
    ``rows`` (from ``prefill``) written into the batch-slots cache
    ``state`` at ``slot_idxs`` (a tensor, or a mesh engine's
    ``sharded_cache.RowSplit``), in place."""
    for sec in ("self", "cross"):
        for pool, row in zip(state[sec], rows[sec]):
            for n in ("k", "v"):
                SC.write_rows(pool[n], 0, slot_idxs, row[n])
    SC.write_rows(state["enc_len"], 0, slot_idxs, rows["enc_len"])
    return state
