"""Optimizers: AdamW and Adafactor, functional style, on trees of tensors.

The reference's optimizers (``training/optimizer.py``) as plain
functions: ``init(params)`` gives the state tree, ``update(params,
grads, state, step)`` the new params and state.  The state keeps the
reference's trees, ``{"m", "v"}`` for AdamW and ``{"f": {"vr", "vc"} |
{"v"}}`` for Adafactor, each mirroring the params, so a checkpoint of
``(params, state)`` lines up leaf for leaf across the two packages.
The maths runs in f32 under ``torch.no_grad()`` and casts back to the
param dtype; gradients are clipped at their global norm before the
update and weight decay applies only where ``ndim >= 2``.

A leaf stacked over layers is updated slice by slice along its leading
axes (``_slices``), so that the f32 temporaries of an update are those
of one slice: zamba2-7b's Mamba ``in_proj`` is one [11, 6, 3584, 14576]
leaf of 3.4 G elements, 13.8 GB in f32 per temporary.  Every operation
is elementwise or reduces over a matrix's own axes, so the slices give
the leaf's values; Adafactor's RMS rule over the whole leaf takes a
second pass.  The clip's scale is applied per slice too (rounded to the
gradient's dtype, as the clipped tree the reference builds).

``update`` writes the new params and state into the tensors it was
given and returns them: the counterpart of the reference's training
step, which donates both to ``jax.jit``, so that a trainer holds one
copy of its state instead of two.  A caller that needs the old params
after a step clones them first.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.tree import leaves, tree_map, tree_unzip


SLICE_ELEMS = 1 << 27        # the most elements of a leaf one update step holds in f32


def _slices(*ts):
    """Matching pieces of tensors that share ``ts[0]``'s leading axes:
    ``ts`` itself, or their entries along the first axis, cut again until
    each piece of ``ts[0]`` has at most SLICE_ELEMS elements; a matrix
    (the last two axes of ``ts[0]``) is never cut."""
    if ts[0].numel() <= SLICE_ELEMS or ts[0].dim() <= 2:
        yield ts
        return
    for i in range(ts[0].shape[0]):
        yield from _slices(*(t[i] for t in ts))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for l in leaves(tree) for (x,) in _slices(l)))


def _clip_scale(tree, max_norm: float) -> torch.Tensor:
    """The factor that brings ``tree`` to at most ``max_norm`` in global norm."""
    return torch.clamp(max_norm / torch.clamp(global_norm(tree), min=1e-9), max=1.0)


def _clipped(g, scale) -> torch.Tensor:
    """``g`` scaled by the clip's ``scale`` and rounded to its dtype, in f32."""
    return (g.float() * scale).to(g.dtype).float()


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]        # (params, grads, state, step), in place
    global_norm: Callable[[Any], torch.Tensor] = global_norm


def _warmup_cosine(lr: float, warmup: int, total: int):
    """Linear warmup to ``lr`` over ``warmup`` steps, then a cosine to 0
    at ``total``; the step's rate as an f32 scalar, computed in f32 as
    the reference does."""
    def sched(step):
        step = torch.tensor(float(step), dtype=torch.float32)
        warm = lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return sched


def _on_device_of(params, *scalars):
    """The f32 schedule scalars moved once to the params' device."""
    ls = leaves(params)
    dev = ls[0].device if ls else torch.device("cpu")
    return [x.to(dev) for x in scalars]


def _out(p, new_p):
    """``new_p`` written into ``p`` in ``p``'s dtype."""
    return p.copy_(new_p.to(p.dtype))


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip: float = 1.0, warmup: int = 100,
          total_steps: int = 10000) -> Optimizer:
    sched = _warmup_cosine(lr, warmup, total_steps)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(params, grads, state, step):
        scale = _clip_scale(grads, clip)
        t = torch.tensor(float(step), dtype=torch.float32) + 1
        lr_t, bc1, bc2 = _on_device_of(params, sched(step), 1.0 - b1 ** t, 1.0 - b2 ** t)

        def upd(p, g, m, v):
            for ps, gs, ms, vs in _slices(p, g, m, v):
                gf = _clipped(gs, scale)
                m2 = b1 * ms + (1 - b1) * gf
                v2 = b2 * vs + (1 - b2) * gf * gf
                u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
                if p.dim() >= 2:
                    u = u + weight_decay * ps.float()
                _out(ps, ps.float() - lr_t * u)
                ms.copy_(m2)
                vs.copy_(v2)
            return p, m, v

        out = tree_map(upd, params, grads, state["m"], state["v"])
        p2, m2, v2 = tree_unzip(out, 3, params)
        return p2, {"m": m2, "v": v2}

    return Optimizer(init=init, update=update)


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip: float = 1.0, weight_decay: float = 0.0,
              warmup: int = 100, total_steps: int = 10000) -> Optimizer:
    """Factored second-moment optimizer (rank-1 v for matrices)."""
    sched = _warmup_cosine(lr, warmup, total_steps)

    def init(params):
        def one(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return {"f": tree_map(one, params)}

    @torch.no_grad()
    def update(params, grads, state, step):
        scale = _clip_scale(grads, clip)
        t = torch.tensor(float(step), dtype=torch.float32) + 1.0
        lr_t, b = _on_device_of(params, sched(step), 1.0 - t ** (-decay))

        def moments(g, s):
            """The second moments ``s`` of a piece (factored for matrices)
            updated in place from its gradient ``g``."""
            gf = _clipped(g, scale)
            g2 = gf * gf + eps
            if "v" in s:
                s["v"].copy_(b * s["v"] + (1 - b) * g2)
            else:
                s["vr"].copy_(b * s["vr"] + (1 - b) * g2.mean(-1))
                s["vc"].copy_(b * s["vc"] + (1 - b) * g2.mean(-2))

        def direction(g, s):
            """``g`` over the square root of its second moment ``s``."""
            gf = _clipped(g, scale)
            if "v" in s:
                return gf * torch.rsqrt(s["v"] + eps)
            vr, vc = s["vr"], s["vc"]
            denom = vr[..., :, None] * vc[..., None, :] \
                / torch.clamp(vr.mean(-1)[..., None, None], min=eps)
            return gf * torch.rsqrt(denom + eps)

        def upd(p, g, s):
            keys = sorted(s)
            pieces = [(ps, gs, dict(zip(keys, ss)))
                      for ps, gs, *ss in _slices(p, g, *(s[k] for k in keys))]
            for _, gs, ss in pieces:
                moments(gs, ss)
            # update clipping (Adafactor RMS rule) over the whole leaf: a
            # leaf of several pieces takes each piece's direction twice
            us = [direction(gs, ss) for _, gs, ss in pieces] if len(pieces) == 1 \
                else [None] * len(pieces)
            sq = sum(torch.sum(torch.square(direction(gs, ss) if u is None else u))
                     for (_, gs, ss), u in zip(pieces, us))
            rms = torch.sqrt(sq / p.numel() + 1e-30)
            for (ps, gs, ss), u in zip(pieces, us):
                u = (direction(gs, ss) if u is None else u) / torch.clamp(rms, min=1.0)
                if p.dim() >= 2 and weight_decay:
                    u = u + weight_decay * ps.float()
                _out(ps, ps.float() - lr_t * u)
            return p, s

        out = tree_map(upd, params, grads, state["f"])
        p2, f2 = tree_unzip(out, 2, params)
        return p2, {"f": f2}

    return Optimizer(init=init, update=update)


__all__ = ["Optimizer", "adafactor", "adamw", "clip_by_global_norm", "global_norm"]
