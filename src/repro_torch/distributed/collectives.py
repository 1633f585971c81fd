"""Collectives over the per-position tensors of one mesh axis.

The counterparts of the ``lax`` collectives in the reference's
``shard_map`` bodies, for a single controller: each takes the list of
one axis's per-position tensors (position ``j`` of the axis at index
``j``) and returns the result, as a tensor or a per-position list.

``all_reduce_sum`` adds the pieces in f32 in mesh order and casts once,
so a result never depends on timing.  Every call adds its result's bytes
to :data:`result_bytes` under its kind (the reference's convention in
``launch/hlo_analysis.py``: result-shape bytes per collective), which
``launch/roofline.py`` reads to hold its count of a sharded step, and one
to :data:`calls`.

Each collective is a ``torch.autograd.Function`` whose backward is its
conjugate, taken from the transpose rules of JAX's ``lax`` collectives,
and the conjugate goes through this module too, so a backward's
collectives are counted as the forward's are.  A tensor the controller
holds whole is *invariant* over the axis; a per-position piece is
*varying*:

- :func:`all_gather` (varying pieces to one whole tensor,
  ``all_gather_invariant``) transposes to a slice: each piece's part of
  the whole gradient, no collective;
- :func:`all_gather_each` (varying pieces to a whole copy at every
  position, ``all_gather``) transposes to :func:`reduce_scatter` of the
  copies' gradients;
- :func:`all_reduce_sum` (varying pieces to one whole sum, ``psum``)
  transposes to the hand-off of the whole gradient to each piece, no
  collective;
- :func:`replicate` (a whole tensor handed to each position's piece,
  ``pvary``) transposes to :func:`all_reduce_sum` of the pieces'
  gradients, in mesh order;
- :func:`split` (a whole tensor cut into per-position parts) transposes
  to :func:`all_gather` of the parts' gradients;
- :func:`reduce_scatter` (``psum_scatter``) transposes to each position
  receiving every part's gradient, counted as one all-gather;
- :func:`all_to_all` transposes to the all-to-all back, and
  :func:`ppermute` to the inverse permutation.

The hand-offs (:func:`replicate`, :func:`split`) move no bytes that the
count sees: the whole tensor is where the controller holds it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
result_bytes: Dict[str, int] = {k: 0 for k in KINDS}
calls: Dict[str, int] = {k: 0 for k in KINDS}


def reset_result_bytes() -> None:
    """Zero :data:`result_bytes` and :data:`calls`."""
    for k in KINDS:
        result_bytes[k] = 0
        calls[k] = 0


def _count(kind: str, ts) -> None:
    result_bytes[kind] += sum(int(t.numel() * t.element_size()) for t in ts)
    calls[kind] += 1


def _on(t: torch.Tensor, device, dtype=None) -> torch.Tensor:
    if device is None and dtype is None:
        return t
    return t.to(device=device, dtype=dtype)


def _float(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


def _grad_in(g, like) -> Optional[torch.Tensor]:
    """A gradient for the input ``like`` (meta: (dtype, device, float)),
    ``None`` for an integer input."""
    dtype, device, is_float = like
    return _on(g, device, dtype) if is_float else None


def _meta(t: torch.Tensor):
    return (t.dtype, t.device, _float(t))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, device, stack, *pieces):
        ctx.dim, ctx.stack = dim, stack
        ctx.sizes = [p.shape[dim] for p in pieces] if not stack else None
        ctx.metas = [_meta(p) for p in pieces]
        moved = [_on(p, device) for p in pieces]
        out = torch.stack(moved, dim) if stack else torch.cat(moved, dim)
        _count("all-gather", [out])
        return out

    @staticmethod
    def backward(ctx, g):
        parts = torch.unbind(g, ctx.dim) if ctx.stack else torch.split(g, ctx.sizes, ctx.dim)
        return (None, None, None, *(_grad_in(p, m) for p, m in zip(parts, ctx.metas)))


def all_gather(pieces: Sequence[torch.Tensor], dim: int = 0, *, device=None,
               stack: bool = False) -> torch.Tensor:
    """The pieces concatenated along ``dim`` (or stacked as a new ``dim``
    with ``stack``), on ``device`` (default: the first piece's).  Its
    gradient is sliced back to the pieces (no collective)."""
    device = pieces[0].device if device is None else device
    return _AllGather.apply(dim, device, stack, *pieces)


class _AllGatherEach(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, devices, *pieces):
        ctx.dim, ctx.sizes = dim, [p.shape[dim] for p in pieces]
        ctx.metas = [_meta(p) for p in pieces]
        out = tuple(torch.cat([_on(p, d) for p in pieces], dim) for d in devices)
        _count("all-gather", out)
        return out

    @staticmethod
    def backward(ctx, *gs):
        parts = [list(torch.split(g, ctx.sizes, ctx.dim)) for g in gs]
        back = reduce_scatter(parts, dtype=ctx.metas[0][0], devices=[m[1] for m in ctx.metas])
        return (None, None, *(_grad_in(b, m) for b, m in zip(back, ctx.metas)))


def all_gather_each(pieces: Sequence[torch.Tensor], dim: int = 0, *,
                    devices=None) -> List[torch.Tensor]:
    """The pieces concatenated along ``dim`` onto every position (position
    ``j``'s copy on ``devices[j]``, default the pieces' own): a gather whose
    result varies over the axis, one call counting every position's copy.
    Its gradient sums the copies' gradients over the positions and hands
    each piece its part: :func:`reduce_scatter`."""
    devices = [p.device for p in pieces] if devices is None else list(devices)
    return list(_AllGatherEach.apply(dim, devices, *pieces))


def _sum_f32(pieces, device, dtype) -> torch.Tensor:
    acc = _on(pieces[0], device).float()
    for p in pieces[1:]:
        acc = acc + _on(p, device).float()
    return acc.to(dtype)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dtype, device, *pieces):
        ctx.metas = [_meta(p) for p in pieces]
        out = _sum_f32(pieces, device, dtype)
        _count("all-reduce", [out])
        return out

    @staticmethod
    def backward(ctx, g):
        return (None, None, *replicate(g, [m[1] for m in ctx.metas],
                                       dtypes=[m[0] for m in ctx.metas]))


def all_reduce_sum(pieces: Sequence[torch.Tensor], *, dtype=None,
                   device=None) -> torch.Tensor:
    """The sum of the pieces, added in f32 in mesh order and cast once to
    ``dtype`` (default: the pieces' dtype), on ``device`` (default: the
    first piece's).  Its gradient is handed whole to every piece."""
    device = pieces[0].device if device is None else device
    dtype = pieces[0].dtype if dtype is None else dtype
    return _AllReduceSum.apply(dtype, device, *pieces)


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, dtypes, x):
        ctx.meta = _meta(x)
        return tuple(x.to(device=d, dtype=t).view_as(x) if t is None or t == x.dtype
                     else x.to(device=d, dtype=t) for d, t in zip(devices, dtypes))

    @staticmethod
    def backward(ctx, *gs):
        dtype, device, is_float = ctx.meta
        if not is_float:
            return None, None, None
        return None, None, all_reduce_sum(gs, dtype=dtype, device=device)


def replicate(x: torch.Tensor, devices: Sequence, *, dtypes=None) -> List[torch.Tensor]:
    """``x`` handed to each position (one per entry of ``devices``, in
    ``dtypes`` where given): its gradient is the :func:`all_reduce_sum` of
    the positions' gradients, in mesh order, in ``x``'s dtype."""
    dtypes = [None] * len(devices) if dtypes is None else list(dtypes)
    return list(_Replicate.apply(list(devices), dtypes, x))


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sizes, dim, devices, x):
        ctx.dim, ctx.meta = dim, _meta(x)
        return tuple(p.to(d) for p, d in zip(torch.split(x, sizes, dim), devices))

    @staticmethod
    def backward(ctx, *gs):
        dtype, device, _ = ctx.meta
        return None, None, None, all_gather([g.to(dtype) for g in gs], ctx.dim, device=device)


def split(x: torch.Tensor, sizes: Sequence[int], dim: int, devices: Sequence) -> List[torch.Tensor]:
    """``x`` cut along ``dim`` into parts of ``sizes``, part ``j`` on
    ``devices[j]``: its gradient is the :func:`all_gather` of the parts'
    gradients."""
    return list(_Split.apply(list(sizes), dim, list(devices), x))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, dtype, devices, *flat):
        ctx.n = n
        ctx.metas = [_meta(t) for t in flat]
        parts = [[flat[j * n + k] for k in range(n)] for j in range(len(flat) // n)]
        out = tuple(_sum_f32([p[k] for p in parts], devices[k], dtype) for k in range(n))
        _count("reduce-scatter", out)
        return out

    @staticmethod
    def backward(ctx, *gs):
        _count("all-gather", gs)
        senders = len(ctx.metas) // ctx.n
        return (None, None, None, *(_grad_in(gs[k], ctx.metas[j * ctx.n + k])
                                    for j in range(senders) for k in range(ctx.n)))


def reduce_scatter(parts: Sequence[Sequence[torch.Tensor]], *, dtype=None,
                   devices=None) -> List[torch.Tensor]:
    """``parts[j][k]`` is what position ``j`` holds for position ``k``:
    position ``k`` receives the sum over ``j`` of ``parts[j][k]``, added in
    f32 in mesh order and cast once to ``dtype`` (default: the parts'), on
    ``devices[k]`` (default: ``parts[0][k]``'s).  Its gradient hands each
    position every part's gradient (an all-gather)."""
    n = len(parts[0])
    dtype = parts[0][0].dtype if dtype is None else dtype
    devices = [p.device for p in parts[0]] if devices is None else list(devices)
    return list(_ReduceScatter.apply(n, dtype, devices, *(t for p in parts for t in p)))


def _all_to_all(pieces, split_dim, concat_dim):
    n = len(pieces)
    chunks = [torch.chunk(p, n, dim=split_dim) for p in pieces]
    out = [torch.cat([_on(chunks[i][j], pieces[j].device) for i in range(n)], concat_dim)
           for j in range(n)]
    _count("all-to-all", out)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split_dim, concat_dim, *pieces):
        ctx.dims, ctx.metas = (split_dim, concat_dim), [_meta(p) for p in pieces]
        return tuple(_all_to_all(pieces, split_dim, concat_dim))

    @staticmethod
    def backward(ctx, *gs):
        split_dim, concat_dim = ctx.dims
        back = all_to_all(gs, split_dim=concat_dim, concat_dim=split_dim)
        return (None, None, *(_grad_in(g, m) for g, m in zip(back, ctx.metas)))


def all_to_all(pieces: Sequence[torch.Tensor], split_dim: int = 0,
               concat_dim: int = 0) -> List[torch.Tensor]:
    """Position ``i`` sends the ``j``-th of its ``n`` chunks along
    ``split_dim`` to position ``j``, which concatenates what it receives
    along ``concat_dim`` in sender order (``lax.all_to_all`` with
    ``tiled=False`` when ``split_dim == concat_dim == 0`` and each piece
    has n rows).  Its gradient is the all-to-all back."""
    return list(_AllToAll.apply(split_dim, concat_dim, *pieces))


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, perm, *pieces):
        ctx.perm, ctx.metas = perm, [_meta(p) for p in pieces]
        out: List[torch.Tensor] = [torch.zeros_like(p) for p in pieces]
        for src, dst in perm:
            out[dst] = _on(pieces[src], pieces[dst].device)
        _count("collective-permute", [out[dst] for _, dst in perm])
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        back = ppermute(gs, [(dst, src) for src, dst in ctx.perm])
        return (None, *(_grad_in(g, m) for g, m in zip(back, ctx.metas)))


def ppermute(pieces: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> List[Optional[torch.Tensor]]:
    """Position ``src`` sends its tensor to ``dst`` for each pair; a
    position nothing is sent to receives zeros, as ``lax.ppermute``.  Its
    gradient goes through the inverse permutation."""
    return list(_Ppermute.apply([tuple(p) for p in perm], *pieces))


__all__ = ["KINDS", "all_gather", "all_gather_each", "all_reduce_sum", "all_to_all", "calls",
           "ppermute", "reduce_scatter", "replicate", "reset_result_bytes", "result_bytes", "split"]
