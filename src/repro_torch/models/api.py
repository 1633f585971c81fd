"""Family dispatch: the entry points the serving engine and tests call.

Every family of the reference is ported: dense, MoE and vlm (all on
``models/transformer.py``; a vlm's ``img_embs`` go ahead of the text),
the hybrid (``models/hybrid.py``: Mamba2 layers and one shared attention
block), rwkv (``models/rwkv.py``: attention-free) and encdec
(``models/encdec.py``: whisper, its decoder fed by ``enc_inputs``).  rwkv,
vlm and encdec serve on the contiguous layout only, and vlm and encdec
without a prefix cache.  Every family trains through :func:`loss_fn`;
``forward(capture=True)`` returns the reference's per-layer captures
(none for encdec, as in the reference).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import encdec, hybrid, rwkv, transformer
from repro_torch.tree import value_and_grad


_RECURRENT = ("hybrid", "rwkv")       # families whose prefill takes ``lengths``


_MODULES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "encdec": encdec, "rwkv": rwkv, "hybrid": hybrid}


def family_module(cfg):
    if cfg.family not in _MODULES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _MODULES[cfg.family]


def init_params(gen, cfg):
    """Random params on ``gen.device`` drawn from the ``torch.Generator``."""
    return family_module(cfg).init_params(gen, cfg)


def forward(params, cfg, batch: Dict[str, Any], *, train: bool = False,
            remat: bool = True, capture: bool = False, use_flash: bool = False):
    """batch: {"tokens": [B, S]}, with ``enc_inputs`` [B, Te, d] (encdec)
    or, optionally, ``img_embs`` [B, n_img, d] (vlm).  Returns (logits,
    aux)."""
    kw: Dict[str, Any] = dict(train=train, remat=remat, capture=capture,
                              use_flash=use_flash)
    if cfg.family == "encdec":
        kw["enc_inputs"] = batch["enc_inputs"]
    elif cfg.family == "vlm":
        kw["img_embs"] = batch.get("img_embs")
    return family_module(cfg).forward(params, cfg, batch["tokens"], **kw)


def loss_fn(params, cfg, batch, *, xent_chunk: int = 0, remat: bool = True,
            aux_weight: float = 0.01):
    """Causal LM loss of ``batch`` {"tokens", "labels"} (scalar f32); a
    vlm's on its text positions, the other families' over every position
    of ``forward`` (the hybrid, rwkv and encdec ignore ``xent_chunk``, as
    in the reference)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        logits, aux = forward(params, cfg, batch, train=True, remat=remat)
        loss = transformer._xent(logits, batch["labels"]) / batch["labels"].numel()
        return loss + aux_weight * aux["moe_aux"]
    return family_module(cfg).loss_fn(params, cfg, batch["tokens"], batch["labels"],
                                      img_embs=batch.get("img_embs"),
                                      xent_chunk=xent_chunk, remat=remat,
                                      aux_weight=aux_weight)


def prefill(params, cfg, batch, *, max_len: int, compact_local: bool = True,
            use_flash: bool = False, lengths=None, cap_tokens=None):
    """``lengths`` [B] (real token count per right-padded row) keeps the
    padding out of a recurrent family's carried state; attention
    families ignore it (causality already isolates right-padding).
    ``cap_tokens``: the token count that decides MoE capacity (default
    the whole batch; the engine passes a row's, for per-row dispatch).
    ``batch`` carries ``enc_inputs`` (encdec) or ``img_embs`` (vlm), as
    in ``forward``; a vlm's logits then cover its image positions too.
    ``compact_local`` as in :func:`init_cache`; callers that serve rows of
    different lengths pass ``False``."""
    kw: Dict[str, Any] = dict(max_len=max_len, compact_local=compact_local,
                              use_flash=use_flash, cap_tokens=cap_tokens)
    if cfg.family in _RECURRENT:
        kw["lengths"] = lengths
    elif cfg.family == "encdec":
        kw["enc_inputs"] = batch["enc_inputs"]
    elif cfg.family == "vlm":
        kw["img_embs"] = batch.get("img_embs")
    return family_module(cfg).prefill(params, cfg, batch["tokens"], **kw)


def init_cache(cfg, batch: int, max_len: int, *, compact_local: bool = True,
               device="cuda"):
    """Contiguous cache.  With ``compact_local`` (the default, as the
    reference's) a transformer's local layers keep a circular buffer of
    min(window, max_len) slots, for rows of equal length; without it every
    layer keeps ``max_len`` absolute slots, the serving layout.  The other
    families ignore it.  An encdec's cache also holds each slot's
    cross-attention K/V at ``enc_ctx`` positions and its ``enc_len``."""
    return family_module(cfg).init_cache(cfg, batch, max_len,
                                         compact_local=compact_local, device=device)


def decode_step(params, cfg, cache, tokens, pos, *, max_len: int):
    """One token for every row of a contiguous cache; ``pos`` scalar or
    [B] (per-row positions).  Returns (logits [B,1,V], cache)."""
    return family_module(cfg).decode_step(params, cfg, cache, tokens, pos,
                                          max_len=max_len)


def insert_rows(cfg, state, rows, slot_idxs):
    """Write an admission batch's caches (from ``prefill``) into the
    contiguous slot state ``init_cache(cfg, slots, max_len)`` at
    ``slot_idxs``, in place."""
    return family_module(cfg).insert_rows(cfg, state, rows, slot_idxs)


# ---------------------------------------------------------------------------
# paged KV cache (serving: block pools + per-slot block tables)
# ---------------------------------------------------------------------------

def supports_paged(cfg) -> bool:
    """Whether the family serves from a paged (block pool + block table)
    KV layout; the others (rwkv: no positional KV; vlm and encdec, which
    take the full-prefill path) take the contiguous one."""
    return cfg.family in ("dense", "moe", "hybrid")


def init_paged_cache(cfg, slots: int, num_blocks: int, block_size: int,
                     device="cuda"):
    """KV block pools (every layer indexed by the same block-id space),
    plus, for the hybrid, slot-batched recurrent states."""
    if cfg.family == "hybrid":
        return hybrid.init_paged_cache(cfg, slots, num_blocks, block_size, device=device)
    return family_module(cfg).init_paged_cache(cfg, num_blocks, block_size,
                                               device=device)


def paged_decode_step(params, cfg, cache, tables, tokens, pos, *,
                      block_size: int, max_len: int):
    """One token for every slot, attending through ``tables``
    [slots, max_len // block_size].  The scoped ``kernel_backend``
    (``core/compressed.py``) picks attention and int8 matmuls alike:
    ``"auto"``, the default, runs the kernels on CUDA tensors."""
    return family_module(cfg).paged_decode_step(
        params, cfg, cache, tables, tokens, pos, block_size=block_size,
        max_len=max_len)


def paged_insert(cfg, state, rows, slot_idxs, write_ids, *, block_size: int):
    """Scatter a batched admission into the paged pools at ``write_ids``
    [n, max_len // block_size]; recurrent rows go to ``slot_idxs``."""
    if cfg.family == "hybrid":
        return hybrid.paged_insert(cfg, state, rows, slot_idxs, write_ids,
                                   block_size=block_size)
    return family_module(cfg).paged_insert(cfg, state, rows, write_ids,
                                           block_size=block_size)


def paged_seed(cfg, state, entry_state, write_ids, *, block_size: int):
    return family_module(cfg).paged_seed(cfg, state, entry_state, write_ids,
                                         block_size=block_size)


# ---------------------------------------------------------------------------
# prefix-sharing prefill
# ---------------------------------------------------------------------------

def supports_prefix(cfg) -> bool:
    """Whether the family can seed per-row state from a shared prefilled
    prompt prefix: not encdec, whose decoder needs its encoder inputs, nor
    vlm, whose image embeddings sit ahead of the text."""
    return cfg.family in ("dense", "moe", "hybrid", "rwkv")


def prefill_from(params, cfg, prefix_cache_entry, suffix_tokens, prefix_len,
                 *, max_len: int, lengths=None, cap_tokens=None):
    """Continue a prefill from a stored prefix state (batch 1, broadcast to
    every row, or one per row); returns (suffix logits [B,S,V],
    fully-populated batch-B cache).  ``lengths`` [B] are the suffixes'
    real token counts (the recurrent families' states need them);
    ``cap_tokens`` as in ``prefill``."""
    kw: Dict[str, Any] = dict(max_len=max_len, cap_tokens=cap_tokens)
    if cfg.family in _RECURRENT:
        kw["lengths"] = lengths
    return family_module(cfg).prefill_from(params, cfg, prefix_cache_entry,
                                           suffix_tokens, prefix_len, **kw)


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def build_train_step(cfg, optimizer, *, xent_chunk: int = 0,
                     grad_compress=None):
    """(params, opt_state, batch, step) -> (params, opt_state, metrics).

    ``optimizer`` from ``repro_torch.training.optimizer``;
    ``grad_compress`` an optional hook applied to the grads before the
    update, which the optimizer writes into the given params and state
    (the reference's step donates them to ``jax.jit``)."""
    def train_step(params, opt_state, batch, step):
        loss, grads = value_and_grad(
            lambda p: loss_fn(p, cfg, batch, xent_chunk=xent_chunk), params)
        if grad_compress is not None:
            grads = grad_compress(grads)
        params, opt_state = optimizer.update(params, grads, opt_state, step)
        gnorm = optimizer.global_norm(grads)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}
    return train_step


def build_prefill_step(cfg, shape_spec, *, compact_local: bool = True,
                       use_flash: bool = False):
    """(params, batch) -> (last-position logits [B, 1, V], cache) over a
    ``shape_spec.seq_len``-deep cache (``launch/roofline.py``
    ``ShapeSpec``); the engine gathers per-row lengths itself."""
    max_len = shape_spec.seq_len

    def prefill_step(params, batch):
        logits, cache = prefill(params, cfg, batch, max_len=max_len,
                                compact_local=compact_local, use_flash=use_flash)
        return logits[:, -1:], cache
    return prefill_step


def build_serve_step(cfg, shape_spec):
    """(params, cache, tokens [B, 1], pos) -> (greedy next token [B, 1],
    logits [B, 1, V], cache): one decode token against a
    ``shape_spec.seq_len``-deep cache (the dry run's ``decode_*`` and
    ``long_*`` cells)."""
    max_len = shape_spec.seq_len

    def serve_step(params, cache, tokens, pos):
        logits, cache = decode_step(params, cfg, cache, tokens, pos, max_len=max_len)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], logits, cache
    return serve_step
