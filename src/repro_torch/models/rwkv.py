"""RWKV6 "Finch": an attention-free LM with data-dependent per-channel decay.

WKV6 recurrence per head (state S in R^{N x N}, N = head dim):

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    o_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)

The reference's functions, in PyTorch: ``wkv6_sequential`` (decode and
the oracle) steps through time; ``wkv6_chunked`` (prefill) cuts T into
chunks and forms each chunk's pairwise decay factors exp(lb_i - la_j)
directly in log space, clamped at -60 and 1e-30 as in the reference (the
factored matmul form overflows under a strong decay).  The chunk shrinks
until it divides T, as in the reference, so a 162-token row runs chunks
of 27: the f32 results depend on that rule.  The state ``S`` is f32
whatever the model's dtype.  The recurrence has no TPU kernel in the
reference, and no CUDA kernel here; every linear goes through
``core.compressed.matmul`` (K2 for an int8 weight on the cuda backend),
the decay LoRA ``wa1``/``wa2`` too, which the pipeline never compresses.

The param layout is the reference's: ``blocks`` is a list of one
layer-stacked tree (leaves [n_layers, ...]; ``tm.w0`` and ``tm.u`` in
f32), ``tail`` is empty.  A cache is ``{"blocks": [{"S" [L, B, H, N, N],
"tm_x" [L, B, d], "cm_x" [L, B, d]}], "tail": []}``: ``init_cache`` keeps
the token-shift carries in f32 (``init_layer_state``'s default), while
``prefill`` returns them in the model's dtype, as in the reference;
``block_apply`` casts them to the activations' dtype, so both hold the
same values.  ``decode_step`` writes the new states into its cache in
place, where the reference returns new ones.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.compressed import ShardedTensor, piece_device
from repro_torch.distributed import collectives
from repro_torch.distributed.data_parallel import checkpoint
from repro_torch.models import layers as L
from repro_torch.models import sharded_cache as SC
from repro_torch.models.layers import matmul
from repro_torch.models.transformer import layer_slice

Params = Dict[str, Any]

_LORA = 64  # decay LoRA bottleneck


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg, dtype, lead: Tuple[int, ...] = ()) -> Params:
    """Random params of one RWKV6 layer (or a stack of them, ``lead`` axes
    first) on ``gen.device``."""
    d = cfg.d_model
    dev = gen.device
    depth_scale = 1.0 / math.sqrt(2 * cfg.n_layers)

    def draw(fn, *shape):
        return fn((*lead, *shape), generator=gen, device=dev, dtype=torch.float32)

    def dense(d_in, d_out, scale=1.0):
        return L.dense_init(gen, d_in, d_out, dtype, scale=scale, lead=lead)

    return {
        "ln1": L.norm_init(d, dtype, cfg.norm_type, device=dev, lead=lead),
        "ln2": L.norm_init(d, dtype, cfg.norm_type, device=dev, lead=lead),
        "tm": {
            # static lerp mixes for r, k, v, g and the decay's input
            "mu": (draw(torch.rand, 5, d) * 0.5 + 0.25).to(dtype),
            "wr": dense(d, d), "wk": dense(d, d), "wv": dense(d, d), "wg": dense(d, d),
            "wo": dense(d, d, depth_scale),
            # data-dependent decay: w = exp(-exp(w0 + tanh(x A1) A2))
            "w0": draw(torch.randn, d) * 0.5 - 0.6,
            "wa1": dense(d, _LORA),
            "wa2": dense(_LORA, d, 0.1),
            "u": draw(torch.randn, d) * 0.3,
            "gn": {"w": torch.ones((*lead, d), dtype=dtype, device=dev),
                   "b": torch.zeros((*lead, d), dtype=dtype, device=dev)},
        },
        "cm": {
            "mu": (draw(torch.rand, 2, d) * 0.5 + 0.25).to(dtype),
            "wk": dense(d, cfg.d_ff),
            "wv": dense(cfg.d_ff, d, depth_scale),
            "wr": dense(d, d),
        },
    }


def init_params(gen: torch.Generator, cfg) -> Params:
    """Random params on ``gen.device``, drawn from ``gen``."""
    params = L.init_embed(gen, cfg, cfg.dtype)
    params["blocks"] = [init_layer(gen, cfg, cfg.dtype, lead=(cfg.n_layers,))]
    params["tail"] = []
    params["ln_f"] = L.norm_init(cfg.d_model, cfg.dtype, cfg.norm_type, device=gen.device)
    return params


def depth(params) -> int:
    """Layers of the stack (``ln1`` is never compressed: a plain tensor)."""
    return params["blocks"][0]["ln1"]["w"].shape[0]


# ---------------------------------------------------------------------------
# WKV6 core
# ---------------------------------------------------------------------------

def wkv6_sequential(r, k, v, w, u, S0):
    """Oracle: token-by-token recurrence.

    r, k, v, w: [B,T,H,N]; u: [H,N]; S0: [B,H,N,N] -> (out [B,T,H,N], S_T),
    both f32."""
    r, k, v, w = (a.float() for a in (r, k, v, w))
    S = S0.float()
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]                 # [B,H,N,N]
        outs.append(torch.einsum("bhn,bhnm->bhm", r[:, t], S + u[None, :, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(outs, dim=1), S


def wkv6_chunked(r, k, v, w, u, S0, chunk: int = 32):
    """Chunked parallel WKV6, the semantics of ``wkv6_sequential``.  The
    log decays of every chunk are taken at once; the chunks' terms and the
    state carried between them follow in order, as the reference's scan."""
    B, T, H, N = r.shape
    C = min(chunk, T)
    while T % C:
        C -= 1
    nc = T // C
    rs, ks, vs, ws = (a.float().reshape(B, nc, C, H, N) for a in (r, k, v, w))
    # 1e-38 is subnormal and may flush to zero; clamp the log itself
    # (decays below e^-60 per token are numerically dead)
    logw = torch.clamp(torch.log(torch.clamp(ws, min=1e-30)), min=-60.0)
    las = torch.cumsum(logw, dim=2)                                    # inclusive
    lbs = las - logw                                                   # exclusive
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device), diagonal=-1)
    S = S0.float()
    outs = []
    for z in range(nc):
        rc, kc, vc, la, lb = rs[:, z], ks[:, z], vs[:, z], las[:, z], lbs[:, z]
        # inter-chunk: r_i decayed to the chunk start, applied to the carried state
        out = torch.einsum("bchn,bhnm->bchm", rc * torch.exp(lb), S)
        # intra-chunk: per-pair log-space decay, [B,C,C,H,N]
        E = lb[:, :, None] - la[:, None, :]
        A = (rc[:, :, None] * kc[:, None, :] * torch.exp(torch.clamp(E, max=0.0))).sum(-1)
        A = torch.where(mask[None, :, :, None], A, torch.zeros((), device=A.device))
        diag = (rc * kc * u).sum(-1)                                   # [B,C,H]
        out = out + torch.einsum("bijh,bjhn->bihn", A, vc) + diag[..., None] * vc
        # the state at the chunk's end
        decay_to_end = torch.exp(la[:, -1][:, None] - la)              # [B,C,H,N]
        S = torch.exp(la[:, -1])[..., None] * S \
            + torch.einsum("bchn,bchm->bhnm", kc * decay_to_end, vc)
        outs.append(out)
    return torch.stack(outs, dim=1).reshape(B, T, H, N), S


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _token_shift(x, prev):
    """x [B,T,d]; prev [B,d]: the carry of the last token (zeros initially)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _lerp(x, xx, mu):
    """x + (xx - x) * mu in f32, cast back to x's dtype."""
    xf = x.float()
    return (xf + (xx.float() - xf) * mu).to(x.dtype)


def _last_real(x, lengths):
    """x [B,T,d], lengths [B] -> x at each row's last REAL position."""
    idx = torch.clamp(lengths.long() - 1, 0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def time_mix(p, x, cfg, *, shift_prev, S0, chunk: int = 32, mask=None, lengths=None):
    """x: [B,T,d] (post-ln).  Returns (out, S_final, new_shift).

    ``mask``/``lengths`` make right-padding a state no-op: pad positions
    get decay w = 1 and key k = 0 (so S carries through unchanged) and
    the token-shift carry is taken at the last real position."""
    B, T, d = x.shape
    H, N = cfg.n_heads, cfg.rwkv_head_dim
    xx = _token_shift(x, shift_prev)
    mu = p["mu"].float()
    xr, xk, xv, xg, xw = (_lerp(x, xx, mu[i]) for i in range(5))
    r = matmul(xr, p["wr"]).reshape(B, T, H, N)
    k = matmul(xk, p["wk"]).reshape(B, T, H, N)
    v = matmul(xv, p["wv"]).reshape(B, T, H, N)
    g = F.silu(matmul(xg, p["wg"]))
    dd = matmul(torch.tanh(matmul(xw, p["wa1"])), p["wa2"]).float()
    w = torch.exp(-torch.exp(p["w0"][None, None] + dd)).reshape(B, T, H, N)
    if mask is not None:
        mm = mask[:, :, None, None]
        w = torch.where(mm, w, torch.ones((), device=w.device))
        k = torch.where(mm, k, torch.zeros((), dtype=k.dtype, device=k.device))
    u = p["u"].float().reshape(H, N)
    if T == 1:
        out, S = wkv6_sequential(r, k, v, w, u, S0)
    else:
        out, S = wkv6_chunked(r, k, v, w, u, S0, chunk=chunk)
    # per-head groupnorm (population variance), in f32
    mean = out.mean(-1, keepdim=True)
    var = ((out - mean) ** 2).mean(-1, keepdim=True)
    out = ((out - mean) * torch.rsqrt(var + 64e-5)).reshape(B, T, d)
    out = out * p["gn"]["w"].float() + p["gn"]["b"].float()
    out = (out * g.float()).to(x.dtype)
    carry = x[:, -1] if lengths is None else _last_real(x, lengths)
    return matmul(out, p["wo"]), S, carry


def channel_mix(p, x, *, shift_prev, lengths=None):
    xx = _token_shift(x, shift_prev)
    mu = p["mu"].float()
    xk, xr = _lerp(x, xx, mu[0]), _lerp(x, xx, mu[1])
    kk = torch.square(F.relu(matmul(xk, p["wk"])))
    out = torch.sigmoid(matmul(xr, p["wr"])) * matmul(kk, p["wv"])
    carry = x[:, -1] if lengths is None else _last_real(x, lengths)
    return out, carry


def init_layer_state(cfg, batch: int, dtype=torch.float32, device="cuda",
                     lead: Tuple[int, ...] = ()) -> Params:
    """Zero state of one layer (``lead`` axes first): ``S`` [batch, H, N,
    N] in f32, the token-shift carries ``tm_x``, ``cm_x`` [batch, d] in
    ``dtype``."""
    H, N, d = cfg.n_heads, cfg.rwkv_head_dim, cfg.d_model
    return {"S": torch.zeros((*lead, batch, H, N, N), dtype=torch.float32, device=device),
            "tm_x": torch.zeros((*lead, batch, d), dtype=dtype, device=device),
            "cm_x": torch.zeros((*lead, batch, d), dtype=dtype, device=device)}


def block_apply(p: Params, x, cfg, *, state: Optional[Params] = None, chunk: int = 32,
                lengths=None):
    """One RWKV layer.  ``state`` {"S", "tm_x", "cm_x"} or None (zeros).
    ``lengths`` [B]: the real (un-padded) token count of each row; pad
    positions leave the carried state untouched (see ``time_mix``)."""
    B, T, _ = x.shape
    if state is None:
        state = init_layer_state(cfg, B, x.dtype, device=x.device)
    mask = None
    if lengths is not None:
        lengths = lengths.to(x.device)
        mask = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
    h = L.norm(x, p["ln1"], cfg)
    a, S, tm_x = time_mix(p["tm"], h, cfg, shift_prev=state["tm_x"].to(h.dtype),
                          S0=state["S"], chunk=chunk, mask=mask, lengths=lengths)
    x = x + a
    h = L.norm(x, p["ln2"], cfg)
    m, cm_x = channel_mix(p["cm"], h, shift_prev=state["cm_x"].to(h.dtype), lengths=lengths)
    return x + m, {"S": S, "tm_x": tm_x, "cm_x": cm_x}


# ---------------------------------------------------------------------------
# model-level API (the family interface of models/api.py)
# ---------------------------------------------------------------------------

def _head(params, cfg, x):
    return L.unembed(params, cfg, L.norm(x, params["ln_f"], cfg))


def forward(params: Params, cfg, tokens, *, train: bool = False, remat: bool = True,
            capture: bool = False, use_flash: bool = False):
    """Returns (logits [B,S,V], aux dict).  With ``remat`` (and grad mode
    on) each layer runs under ``torch.utils.checkpoint``; ``use_flash``
    does not apply (no attention).  ``capture`` adds ``aux["captures"]``
    ({"blocks": [the layers' inputs, L x [B, S, d] stacked], "tail": []})
    and ``aux["final_hidden"]``, as the reference's, and turns remat off."""
    x = L.embed(params, cfg, tokens)
    remat = remat and torch.is_grad_enabled() and not capture
    inputs = []

    def body(p, xc):
        return block_apply(p, xc, cfg)[0]

    for r in range(depth(params)):
        if capture:
            inputs.append(x)
        p = layer_slice(params["blocks"][0], r)
        x = checkpoint(body, p, x) if remat else body(p, x)
    h = L.norm(x, params["ln_f"], cfg)
    aux = {"moe_aux": torch.zeros((), dtype=torch.float32, device=x.device)}
    if capture:
        aux["captures"] = {"blocks": [torch.stack(inputs)], "tail": []}
        aux["final_hidden"] = h
    return L.unembed(params, cfg, h), aux


def init_cache(cfg, batch: int, max_len: int, *, compact_local: bool = True,
               device="cuda"):
    """Zero recurrent states per layer, stacked along the layer axis, in
    ``init_layer_state``'s f32.  The state is O(1) in the sequence:
    ``max_len`` and ``compact_local`` do not apply.  ``device`` may be
    ``"meta"``: the pool sizes a slot from the shapes alone."""
    return {"blocks": [init_layer_state(cfg, batch, torch.float32, device,
                                        lead=(cfg.n_layers,))], "tail": []}


def _layers(params, cfg, x, states=None, lengths=None):
    """Every layer in order, from ``states`` ([L, B, ...] leaves, or None
    for zeros): (x, the new states as a list over layers)."""
    new = []
    for r in range(depth(params)):
        st = None if states is None else {n: t[r] for n, t in states.items()}
        x, s = block_apply(layer_slice(params["blocks"][0], r), x, cfg, state=st,
                           lengths=lengths)
        new.append(s)
    return x, new


def _stacked(states):
    return {"blocks": [{n: torch.stack([s[n] for s in states]) for n in states[0]}],
            "tail": []}


def decode_step(params: Params, cfg, cache, tokens, pos, *, max_len: int = 0):
    """One token for every row.  tokens [B,1]; ``pos`` is unused (the
    state is position-free).  Writes the new states into ``cache`` in
    place, in its dtypes; returns (logits [B,1,V], cache).  A mesh
    engine's sharded state (``models/sharded_cache.py``) takes
    :func:`_sharded_decode`."""
    states = cache["blocks"][0]
    if any(isinstance(t, ShardedTensor) for t in states.values()):
        return _sharded_decode(params, cfg, cache, tokens)
    x, new = _layers(params, cfg, L.embed(params, cfg, tokens), states)
    for r, st in enumerate(new):
        for n, t in st.items():
            states[n][r].copy_(t)
    return _head(params, cfg, x), cache


def _sharded_decode(params: Params, cfg, cache, tokens):
    """:func:`decode_step` over a mesh engine's slot state placed by
    ``cache_shardings``: ``S`` split over slots ("data") and heads
    ("model") where they divide, the token-shift carries over slots.
    Each layer's time mix runs where its ``S`` pieces live
    (:func:`_sharded_time_mix`); the carries of a slot-split state are
    gathered for the shift and written back into their pieces."""
    states = cache["blocks"][0]
    x = L.embed(params, cfg, tokens)
    for r in range(depth(params)):
        p = layer_slice(params["blocks"][0], r)
        st = layer_slice(states, r)
        h = L.norm(x, p["ln1"], cfg)
        a, tm_x = _sharded_time_mix(p["tm"], h, cfg, st["S"],
                                    SC.read_slots(st["tm_x"], h.device).to(h.dtype))
        SC.write_slots(st["tm_x"], tm_x)
        x = x + a
        h = L.norm(x, p["ln2"], cfg)
        m, cm_x = channel_mix(p["cm"], h,
                              shift_prev=SC.read_slots(st["cm_x"], h.device).to(h.dtype))
        SC.write_slots(st["cm_x"], cm_x)
        x = x + m
    return _head(params, cfg, x), cache


def _sharded_time_mix(p, x, cfg, S, shift_prev):
    """One decode token of :func:`time_mix` (x [B, 1, d], post-ln) against
    the sharded ``S``, written in place; returns (out, the shift carry).

    Where the heads split (``S`` over "model", M pieces), the rule table
    has cut ``wr``/``wk``/``wv``/``wg`` by columns in head order, so model
    position ``j`` computes its heads' r, k, v and g from its own pieces
    (no gather); the decay ``w`` (whole after ``wa2``'s row-parallel
    sum), ``u`` and the group norm's ``gn`` are sliced to its heads; each
    data position runs ``wkv6_sequential`` on its rows against its
    ``S`` piece and takes the per-head group norm there; position ``j``'s
    rows are gathered and multiplied by ``wo``'s row piece ``j``, and the
    partial products summed in f32 in mesh order.  Where the heads do not
    split, r/k/v/g are whole and each data position runs its rows."""
    B, T, d = x.shape
    H, N = cfg.n_heads, cfg.rwkv_head_dim
    n_d, n_m = SC.head_layout(S)
    b, hm = B // n_d, H // n_m
    first = x.device
    xx = _token_shift(x, shift_prev)
    mu = p["mu"].float()
    xr, xk, xv, xg, xw = (_lerp(x, xx, mu[i]) for i in range(5))
    dd = matmul(torch.tanh(matmul(xw, p["wa1"])), p["wa2"]).float()
    w = torch.exp(-torch.exp(p["w0"][None, None] + dd)).reshape(B, T, H, N)
    u = p["u"].float().reshape(H, N)
    gw, gb = (p["gn"][k].float().reshape(H, N) for k in ("w", "b"))
    names = ("wr", "wk", "wv", "wg")
    cuts = {n: SC.model_pieces(p[n], n_m, n) for n in names}
    outs = []                                      # per model position: [b, T, hm * N] rows
    for j in range(n_m):
        dev = piece_device(cuts["wr"][j]) if n_m > 1 else first
        r, k, v, g = (matmul(a.to(dev), cuts[n][j])
                      for a, n in zip((xr, xk, xv, xg), names))
        r, k, v = (t.reshape(B, T, hm, N) for t in (r, k, v))
        g = F.silu(g)
        hs = slice(j * hm, (j + 1) * hm)
        rows = []
        for i in range(n_d):
            Sij = SC.piece_of(S, i, j)
            at = Sij.device
            out, Snew = wkv6_sequential(*(SC.rows_of(t, i, b, n_d).to(at) for t in (r, k, v)),
                                        SC.rows_of(w[:, :, hs], i, b, n_d).to(at),
                                        u[hs].to(at), Sij)
            Sij.copy_(Snew)
            mean = out.mean(-1, keepdim=True)
            var = ((out - mean) ** 2).mean(-1, keepdim=True)
            out = (out - mean) * torch.rsqrt(var + 64e-5) * gw[hs].to(at) + gb[hs].to(at)
            gi = SC.rows_of(g, i, b, n_d).to(at)
            rows.append((out.reshape(b, T, hm * N) * gi.float()).to(x.dtype))
        outs.append(rows)
    wo = p["wo"]
    if n_m > 1 and isinstance(wo, ShardedTensor) and wo.axis == "model" and wo.dim == -2 \
            and len(wo.pieces) == n_m:
        parts = [matmul(SC.gather_heads([outs[j]], n_d, 1, piece_device(wo.pieces[j])),
                        wo.pieces[j]) for j in range(n_m)]
        return collectives.all_reduce_sum(parts, device=first), x[:, -1]
    return matmul(SC.gather_heads(outs, n_d, n_m, first, dim=-1), wo), x[:, -1]


def prefill(params: Params, cfg, tokens, *, max_len: int = 0, lengths=None,
            compact_local: bool = True, use_flash: bool = False, cap_tokens=None):
    """Run the prompt from zero states, return (logits [B,S,V], cache
    with the token-shift carries in the model's dtype).  Rows are
    right-padded; ``lengths`` [B] keeps the padding out of the states.
    ``compact_local``, ``use_flash`` and ``cap_tokens`` do not apply."""
    x, states = _layers(params, cfg, L.embed(params, cfg, tokens), lengths=lengths)
    return _head(params, cfg, x), _stacked(states)


def prefill_from(params: Params, cfg, cache, tokens, start, *, max_len: int = 0,
                 lengths=None, cap_tokens=None):
    """Prefill the suffix ``tokens`` [B,S] from the recurrent state in
    ``cache`` (a prefilled template prefix, batch 1, broadcast to every
    row, or batch B; not modified).  The state is O(1) and position-free,
    so seeding is exact by construction: ``start`` is unused beyond the
    shared signature.  ``lengths`` [B] are the suffixes' real token
    counts."""
    x = L.embed(params, cfg, tokens)
    B = x.shape[0]
    rows = {n: t.expand(t.shape[0], B, *t.shape[2:]) for n, t in cache["blocks"][0].items()}
    x, states = _layers(params, cfg, x, rows, lengths)
    return _head(params, cfg, x), _stacked(states)


def insert_rows(cfg, state, rows, slot_idxs):
    """The contiguous serving layout's admission: batch-n ``rows`` (from
    ``prefill``) written into the batch-slots ``state`` at ``slot_idxs`` (a
    tensor, or a mesh engine's ``sharded_cache.RowSplit``), in place, in
    the slot state's dtypes."""
    for n, t in state["blocks"][0].items():
        SC.write_rows(t, 1, slot_idxs, rows["blocks"][0][n])
    return state
