"""Mamba2 (SSD) block: a state-space layer with a scalar decay per head.

    h_t = a_t h_{t-1} + dt_t * x_t (x) B_t        a_t = exp(-dt_t e^{A_h})
    y_t = C_t . h_t + D_h x_t

The reference's functions, in PyTorch: ``ssd_sequential`` (decode and
the oracle) steps through time; ``ssd_chunked`` (prefill) cuts T into
chunks whose pairwise decay factors form a [C, C] matrix per head.  The
reference scans over the chunks; here every chunk's own terms are
computed at once and only the state recurrence between chunks loops.
The chunk shrinks until it divides T, as in the reference, so a prompt of
prime length runs chunks of one position.  The state ``h`` is f32
whatever the model's dtype; the conv window is in the model's dtype.
The scan has no TPU kernel in the reference, and no CUDA kernel here.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.compressed import ShardedTensor
from repro_torch.models import layers as L
from repro_torch.models import sharded_cache as SC
from repro_torch.models.layers import matmul

Params = Dict[str, Any]


def dims(cfg):
    """(d_inner, SSD heads H, head dim P, state size N)."""
    d_inner = cfg.expand * cfg.d_model
    H = d_inner // cfg.ssd_head_dim
    return d_inner, H, cfg.ssd_head_dim, cfg.d_state


def init_layer(gen: torch.Generator, cfg, dtype, lead: Tuple[int, ...] = ()) -> Params:
    """Random params of one Mamba2 block (or a stack of them, ``lead``
    axes first) on ``gen.device``."""
    d = cfg.d_model
    d_inner, H, P, N = dims(cfg)
    conv_ch = d_inner + 2 * N
    dev = gen.device
    depth_scale = 1.0 / math.sqrt(2 * max(cfg.n_layers, 1))
    f32 = torch.float32
    conv_w = torch.randn((*lead, cfg.conv_kernel, conv_ch), generator=gen, device=dev,
                         dtype=f32) * (1.0 / math.sqrt(cfg.conv_kernel))
    u = torch.rand((*lead, H), generator=gen, device=dev, dtype=f32)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return {
        "ln": L.norm_init(d, dtype, cfg.norm_type, device=dev, lead=lead),
        "in_proj": L.dense_init(gen, d, 2 * d_inner + 2 * N + H, dtype, lead=lead),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)).expand(*lead, H).clone(),
        "D": torch.ones((*lead, H), dtype=f32, device=dev),
        "dt_bias": torch.log(torch.expm1(dt)),
        "norm_y": {"w": torch.ones((*lead, d_inner), dtype=dtype, device=dev)},
        "out_proj": L.dense_init(gen, d_inner, d, dtype, scale=depth_scale, lead=lead),
    }


def init_layer_state(cfg, batch: int, dtype, device="cuda",
                     lead: Tuple[int, ...] = ()) -> Params:
    """Zero state of one block (``lead`` axes first): ``h`` [batch, H, P,
    N] in f32 and the conv window [batch, K - 1, d_inner + 2 N]."""
    d_inner, H, P, N = dims(cfg)
    return {"h": torch.zeros((*lead, batch, H, P, N), dtype=torch.float32, device=device),
            "conv": torch.zeros((*lead, batch, cfg.conv_kernel - 1, d_inner + 2 * N),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_sequential(x, dt, a, Bm, Cm, D, h0):
    """x [B,T,H,P]; dt, a [B,T,H]; Bm, Cm [B,T,N]; D [H]; h0 [B,H,P,N]
    -> (y [B,T,H,P] f32, h_T f32)."""
    x, dt, a, Bm, Cm = (v.float() for v in (x, dt, a, Bm, Cm))
    h = h0.float()
    ys = []
    for t in range(x.shape[1]):
        upd = (dt[:, t, :, None, None] * x[:, t, :, :, None]) * Bm[:, t, None, None, :]
        h = a[:, t, :, None, None] * h + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]) + D[None, :, None] * x[:, t])
    return torch.stack(ys, dim=1), h


def ssd_chunked(x, dt, a, Bm, Cm, D, h0, chunk: int = 64):
    """Chunked SSD, the semantics of ``ssd_sequential``."""
    B, T, H, P = x.shape
    C = min(chunk, T)
    while T % C:
        C -= 1
    nc = T // C

    def chunks(v):
        return v.float().reshape(B, nc, C, *v.shape[2:])

    xc, dtc, ac, bc, cc = (chunks(v) for v in (x, dt, a, Bm, Cm))
    la = torch.cumsum(torch.clamp(torch.log(torch.clamp(ac, min=1e-30)), min=-60.0),
                      dim=2)                                          # [B,nc,C,H]
    # intra: the causal pairs (j <= i) of each chunk
    scores = torch.einsum("bzin,bzjn->bzij", cc, bc)                  # [B,nc,C,C]
    ladiff = la[:, :, :, None] - la[:, :, None, :]                    # [B,nc,C,C,H]
    A = scores[..., None] * torch.exp(torch.clamp(ladiff, max=0.0)) * dtc[:, :, None]
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device))
    A = torch.where(mask[:, :, None], A, torch.zeros((), device=x.device))
    y_intra = torch.einsum("bzijh,bzjhp->bzihp", A, xc)
    # each chunk's own contribution to the state, and its decay
    dec = torch.exp(la[:, :, -1:] - la)                               # [B,nc,C,H]
    upd = torch.einsum("bzchp,bzcn->bzhpn", xc * (dtc * dec)[..., None], bc)
    decay = torch.exp(la[:, :, -1])[..., None, None]                  # [B,nc,H,1,1]
    h = h0.float()
    h_in = []
    for z in range(nc):
        h_in.append(h)
        h = decay[:, z] * h + upd[:, z]
    # inter: the state from the previous chunks
    y = torch.einsum("bzcn,bzhpn->bzchp", cc, torch.stack(h_in, dim=1)) \
        * torch.exp(la)[..., None]
    y = y + y_intra
    y = y + D[None, None, None, :, None] * xc
    return y.reshape(B, T, H, P), h


# ---------------------------------------------------------------------------
# block
# ---------------------------------------------------------------------------

def _conv1d(x, w, b, conv_state, lengths=None):
    """Causal depthwise conv.  x [B,T,ch]; w [K,ch]; conv_state [B,K-1,ch].

    With ``lengths`` [B] (right-padded rows) the carried window holds the
    last K-1 REAL inputs, reaching back into ``conv_state`` for a short
    row, not the padding tail."""
    K, T = w.shape[0], x.shape[1]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = xp[:, 0:T] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[i]
    if lengths is None:
        new_state = xp[:, xp.shape[1] - (K - 1):]
    else:
        # real inputs occupy xp[:, K-1 : K-1+len); the window of the last
        # K-1 of them starts at index len
        idx = lengths.long()[:, None] + torch.arange(K - 1, device=x.device)[None]
        new_state = torch.gather(xp, 1, idx[:, :, None].expand(-1, -1, xp.shape[2]))
    return out + b, new_state


def stack_apply(stacked_params, states, x, cfg, *, chunk: int = 64, lengths=None):
    """Apply K layer-stacked blocks (leaves with a leading [K] axis) in
    order from ``states`` ([K, ...] leaves), the cache-seeding primitive:
    a caller hands in carried states and the recurrence resumes where they
    left off.  The new states are written into ``states`` in place (the
    reference returns them stacked anew); returns (x, states)."""
    from repro_torch.models.transformer import layer_slice
    K = stacked_params["A_log"].shape[0]          # never compressed: a plain tensor
    sharded = any(isinstance(s, ShardedTensor) for s in states.values())
    for u in range(K):
        if sharded:             # a mesh engine's decode writes its pieces in place
            x = _sharded_decode(layer_slice(stacked_params, u), x, cfg,
                                layer_slice(states, u))
            continue
        x, st = block_apply(layer_slice(stacked_params, u), x, cfg,
                            state={n: s[u] for n, s in states.items()},
                            chunk=chunk, lengths=lengths)
        for n, s in st.items():
            states[n][u] = s
    return x, states


def _sharded_decode(p: Params, x, cfg, state):
    """One decode token of :func:`block_apply` against a mesh engine's
    state placed by ``cache_shardings`` (``h`` over slots and heads, the
    conv window over slots), written in place; returns x.

    ``in_proj``'s output ``[z | x B C | dt]`` does not fall on head
    boundaries, so the projection stays whole (gathered from its column
    pieces) and the conv window, gathered over slots where it is split,
    runs on it as before.  Each (data, model) position then runs
    ``ssd_sequential`` on its rows and heads (``xs``, ``dt``, ``A_log``
    and ``D`` sliced to them; ``B``/``C``, one group, whole) against its
    ``h`` piece; ``y`` is gathered over rows and heads before ``norm_y``,
    which normalizes over the whole ``d_inner``."""
    B, T, d = x.shape
    d_inner, H, P, N = dims(cfg)
    n_d, n_m = SC.head_layout(state["h"])
    b, hm = B // n_d, H // n_m
    first = x.device
    h_in = L.norm(x, p["ln"], cfg)
    proj = matmul(h_in, p["in_proj"])
    z, xbc, dt_raw = torch.split(proj, [d_inner, d_inner + 2 * N, H], dim=-1)
    xbc, conv_state = _conv1d(xbc, p["conv_w"], p["conv_b"], SC.read_slots(state["conv"], first))
    SC.write_slots(state["conv"], conv_state)
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    u = dt_raw.float() + p["dt_bias"]
    dt = torch.logaddexp(u, torch.zeros((), device=u.device))        # softplus
    a = torch.exp(-dt * torch.exp(p["A_log"]))
    xh = xs.reshape(B, T, H, P)
    ys = []                                        # per model position: [b, T, hm, P] rows
    for j in range(n_m):
        hs = slice(j * hm, (j + 1) * hm)
        rows = []
        for i in range(n_d):
            hij = SC.piece_of(state["h"], i, j)
            at = hij.device
            y, h_new = ssd_sequential(*(SC.rows_of(t, i, b, n_d).to(at)
                                        for t in (xh[:, :, hs], dt[..., hs], a[..., hs], Bm, Cm)),
                                      p["D"][hs].to(at), hij)
            hij.copy_(h_new)
            rows.append(y)
        ys.append(rows)
    y = SC.gather_heads(ys, n_d, n_m, first).reshape(B, T, d_inner)
    y = (y * F.silu(z.float())).to(x.dtype)
    y = L.rmsnorm(y, p["norm_y"])
    return x + matmul(y, p["out_proj"])


def block_apply(p: Params, x, cfg, *, state: Optional[Params] = None, chunk: int = 64,
                lengths=None):
    """One Mamba2 block with residual.  x [B,T,d] -> (x, new state).

    ``lengths`` [B] makes right-padding a no-op on the state: pad
    positions get dt = 0 (so a = 1 and h is frozen) and the conv window
    carries the last real inputs, so decode resumes from the unpadded
    prompt's state."""
    B, T, d = x.shape
    d_inner, H, P, N = dims(cfg)
    if state is None:
        state = init_layer_state(cfg, B, x.dtype, device=x.device)
    h_in = L.norm(x, p["ln"], cfg)
    proj = matmul(h_in, p["in_proj"])
    z, xbc, dt_raw = torch.split(proj, [d_inner, d_inner + 2 * N, H], dim=-1)
    xbc, conv_state = _conv1d(xbc, p["conv_w"], p["conv_b"], state["conv"], lengths)
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    u = dt_raw.float() + p["dt_bias"]
    dt = torch.logaddexp(u, torch.zeros((), device=u.device))        # softplus
    if lengths is not None:
        real = torch.arange(T, device=x.device)[None, :] < lengths.to(x.device)[:, None]
        dt = dt * real[:, :, None]
    a = torch.exp(-dt * torch.exp(p["A_log"]))
    xh = xs.reshape(B, T, H, P)
    if T == 1:
        y, h_new = ssd_sequential(xh, dt, a, Bm, Cm, p["D"], state["h"])
    else:
        y, h_new = ssd_chunked(xh, dt, a, Bm, Cm, p["D"], state["h"], chunk=chunk)
    y = y.reshape(B, T, d_inner)
    y = (y * F.silu(z.float())).to(x.dtype)
    y = L.rmsnorm(y, p["norm_y"])
    return x + matmul(y, p["out_proj"]), {"h": h_new, "conv": conv_state}
