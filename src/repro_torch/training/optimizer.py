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

A sharded leaf (a placed tree's ``ShardedTensor``) is updated piece by
piece, its state placed as the reference's ``opt_state_shardings``
says; Adafactor adds the partial statistics of the pieces that split a
matrix (:func:`adafactor`).

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

from repro_torch.core.compressed import ShardedTensor, piece_device
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import P, placed_zeros, spec_of
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


def _tensors(leaf) -> list:
    """A leaf's tensors: a sharded leaf's pieces, or the leaf itself."""
    return leaf.tensors() if isinstance(leaf, ShardedTensor) else [leaf]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32; a sharded leaf
    counts each of its pieces once, each piece's sum taken on its own
    device and added on the first leaf's."""
    ts = [t for l in leaves(tree) for t in _tensors(l)]
    dev = ts[0].device if ts else torch.device("cpu")
    return torch.sqrt(sum(torch.sum(torch.square(x.float())).to(dev)
                          for t in ts for (x,) in _slices(t)))


def _clip_scale(tree, max_norm: float) -> torch.Tensor:
    """The factor that brings ``tree`` to at most ``max_norm`` in global norm."""
    return torch.clamp(max_norm / torch.clamp(global_norm(tree), min=1e-9), max=1.0)


def _clipped(g, scale) -> torch.Tensor:
    """``g`` scaled by the clip's ``scale`` and rounded to its dtype, in f32."""
    return (g.float() * scale.to(g.device)).to(g.dtype).float()


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
    """The f32 schedule scalars moved once to the params' device (a
    sharded first leaf's: its first piece's); a piece elsewhere takes them
    to its own (:func:`_at`)."""
    ls = leaves(params)
    dev = piece_device(ls[0]) if ls else torch.device("cpu")
    return [x.to(dev) for x in scalars]


def _at(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The scalar ``x`` on ``t``'s device."""
    return x if x.device == t.device else x.to(t.device)


def _out(p, new_p):
    """``new_p`` written into ``p`` in ``p``'s dtype."""
    return p.copy_(new_p.to(p.dtype))


def _zeros(p):
    """f32 zeros placed as ``p`` is (a sharded leaf's pieces on their devices)."""
    if isinstance(p, ShardedTensor):
        return p.map(_zeros)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip: float = 1.0, warmup: int = 100,
          total_steps: int = 10000) -> Optimizer:
    sched = _warmup_cosine(lr, warmup, total_steps)

    def init(params):
        return {"m": tree_map(_zeros, params), "v": tree_map(_zeros, params)}

    @torch.no_grad()
    def update(params, grads, state, step):
        scale = _clip_scale(grads, clip)
        t = torch.tensor(float(step), dtype=torch.float32) + 1
        lr_t, bc1, bc2 = _on_device_of(params, sched(step), 1.0 - b1 ** t, 1.0 - b2 ** t)

        def upd(p, g, m, v):
            # elementwise: a sharded leaf is updated piece by piece
            decay = len(p.shape) >= 2
            for pt, gt, mt, vt in zip(*(_tensors(a) for a in (p, g, m, v))):
                lr, c1, c2 = (_at(x, pt) for x in (lr_t, bc1, bc2))
                for ps, gs, ms, vs in _slices(pt, gt, mt, vt):
                    gf = _clipped(gs, scale)
                    m2 = b1 * ms + (1 - b1) * gf
                    v2 = b2 * vs + (1 - b2) * gf * gf
                    u = (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
                    if decay:
                        u = u + weight_decay * ps.float()
                    _out(ps, ps.float() - lr * u)
                    ms.copy_(m2)
                    vs.copy_(v2)
            return p, m, v

        out = tree_map(upd, params, grads, state["m"], state["v"])
        p2, m2, v2 = tree_unzip(out, 3, params)
        return p2, {"m": m2, "v": v2}

    return Optimizer(init=init, update=update)


def _grid(leaf, coords=()) -> list:
    """[(coords, tensor)] of a (possibly sharded) leaf in mesh order:
    ``coords`` the sorted ((axis, index), ...) of the piece."""
    if isinstance(leaf, ShardedTensor):
        return [c for j, p in enumerate(leaf.pieces)
                for c in _grid(p, coords + ((leaf.axis, j),))]
    return [(tuple(sorted(coords)), leaf)]


def _split_axes(leaf) -> dict:
    """{dim: axis} of a (nested) ``ShardedTensor``'s splits."""
    out = {}
    while isinstance(leaf, ShardedTensor):
        out[leaf.dim] = leaf.axis
        leaf = leaf.pieces[0]
    return out


def _drop(coords, *axes) -> tuple:
    return tuple((a, i) for a, i in coords if a not in axes)


def _sum_over(parts, dev) -> torch.Tensor:
    """The f32 sum of the pieces' partial sums ``parts`` (mesh order) on
    ``dev``: one ``all_reduce_sum``, or the one part itself."""
    if len(parts) == 1:
        return parts[0].to(dev)
    return collectives.all_reduce_sum(parts, device=dev)


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip: float = 1.0, weight_decay: float = 0.0,
              warmup: int = 100, total_steps: int = 10000) -> Optimizer:
    """Factored second-moment optimizer (rank-1 v for matrices).

    A sharded matrix keeps the whole matrix's statistics, as the
    reference's update under ``opt_state_shardings``: ``vr`` (placed by
    the param's row spec) is the mean of g^2 over *all* columns, so the
    row sums of a column-split matrix's pieces are added
    (``collectives.all_reduce_sum``, in mesh order); ``vc`` likewise over
    all rows; the denominator's ``vr.mean(-1)`` runs over the whole
    ``vr`` and the RMS clip over the whole leaf."""
    sched = _warmup_cosine(lr, warmup, total_steps)

    def init(params):
        def one(p):
            if isinstance(p, ShardedTensor) and len(p.shape) >= 2:
                spec, shape = spec_of(p), tuple(p.shape)
                return {"vr": placed_zeros(shape[:-1], P(*spec[:-1]), p.mesh),
                        "vc": placed_zeros(shape[:-2] + shape[-1:], P(*spec[:-2], spec[-1]),
                                           p.mesh)}
            if isinstance(p, ShardedTensor):
                return {"v": _zeros(p)}
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

        def apply(ps, u, rms, nd):
            u = u / torch.clamp(_at(rms, u), min=1.0)
            if nd >= 2 and weight_decay:
                u = u + weight_decay * ps.float()
            _out(ps, ps.float() - _at(lr_t, ps) * u)

        def upd(p, g, s):
            """One leaf's update: its pieces (one for a plain leaf; a sharded
            leaf's, and those of its state, placed by ``opt_state_shardings``)
            in lockstep slices, every statistic of the whole matrix summed
            over the pieces that split it."""
            cells = _grid(p)
            coords = [c for c, _ in cells]
            n = len(cells)
            names = ("v",) if "v" in s else ("vr", "vc")
            grids = {k: _grid(s[k]) for k in names}
            keys = {k: [c for c, _ in grids[k]] for k in names}
            axes = _split_axes(p)
            col, row = axes.get(-1), axes.get(-2)
            # which piece of each state tensor a param piece reads
            own = {"v": [keys["v"].index(c) for c in coords] if "v" in names else None}
            if "vr" in names:
                own["vr"] = [keys["vr"].index(_drop(c, col)) for c in coords]
                own["vc"] = [keys["vc"].index(_drop(c, row)) for c in coords]
            flat = [t for _, t in cells] + [t for _, t in _grid(g)] \
                + [t for k in names for _, t in grids[k]]
            slices = list(_slices(*flat))

            def unpack(sl):
                ps, gs, rest = sl[:n], sl[n:2 * n], sl[2 * n:]
                st, at = {}, 0
                for k in names:
                    st[k] = rest[at:at + len(keys[k])]
                    at += len(keys[k])
                return ps, gs, st

            def directions(gs, st):
                """Each piece's gradient over the square root of its second moment."""
                gf = [_clipped(x, scale) for x in gs]
                if "v" in st:
                    return [gf[i] * torch.rsqrt(st["v"][own["v"][i]].to(gf[i].device) + eps)
                            for i in range(n)]
                # vr.mean(-1) over the whole vr: its pieces along the row axis added
                means = {}
                for j, c in enumerate(keys["vr"]):
                    means.setdefault(_drop(c, row), []).append(j)
                for m, js in means.items():
                    vrs = [st["vr"][j] for j in js]
                    means[m] = vrs[0].mean(-1) if len(js) == 1 else \
                        _sum_over([v.sum(-1) for v in vrs], vrs[0].device) / p.shape[-2]
                out = []
                for i in range(n):
                    dev = gf[i].device
                    vr = st["vr"][own["vr"][i]].to(dev)
                    vc = st["vc"][own["vc"][i]].to(dev)
                    mean = means[_drop(coords[i], col, row)].to(dev)
                    denom = vr[..., :, None] * vc[..., None, :] \
                        / torch.clamp(mean[..., None, None], min=eps)
                    out.append(gf[i] * torch.rsqrt(denom + eps))
                return out

            # the second moments (factored for matrices), in place
            for sl in slices:
                _, gs, st = unpack(sl)
                gf = [_clipped(x, scale) for x in gs]
                g2 = [f * f + eps for f in gf]
                for k in names:
                    red = {"v": None, "vr": -1, "vc": -2}[k]
                    for j, t in enumerate(st[k]):
                        mine = [i for i in range(n) if own[k][i] == j]
                        if red is None:
                            new = g2[mine[0]]
                        elif len(mine) == 1:
                            new = g2[mine[0]].mean(red)
                        else:
                            new = _sum_over([g2[i].sum(red) for i in mine], t.device) \
                                / p.shape[red]
                        bt = _at(b, t)
                        t.copy_(bt * t + (1 - bt) * new.to(t.device))
            # update clipping (Adafactor RMS rule) over the whole leaf: a leaf
            # of several slices takes each slice's directions twice
            us = directions(*unpack(slices[0])[1:]) if len(slices) == 1 else None
            sq = None
            for sl in slices:
                part = _sum_over([torch.sum(torch.square(u))
                                  for u in (us or directions(*unpack(sl)[1:]))], cells[0][1].device)
                sq = part if sq is None else sq + part
            rms = torch.sqrt(sq / math.prod(p.shape) + 1e-30)
            for sl in slices:
                ps, gs, st = unpack(sl)
                for pt, u in zip(ps, us or directions(gs, st)):
                    apply(pt, u, rms, len(p.shape))
            return p, s

        out = tree_map(upd, params, grads, state["f"])
        p2, f2 = tree_unzip(out, 2, params)
        return p2, {"f": f2}

    return Optimizer(init=init, update=update)


__all__ = ["Optimizer", "adafactor", "adamw", "clip_by_global_norm", "global_norm"]
