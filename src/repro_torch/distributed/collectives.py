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
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

KINDS = ("all-gather", "all-reduce", "all-to-all", "collective-permute")
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


def _on(t: torch.Tensor, device) -> torch.Tensor:
    return t if device is None else t.to(device)


def all_gather(pieces: Sequence[torch.Tensor], dim: int = 0, *, device=None,
               stack: bool = False) -> torch.Tensor:
    """The pieces concatenated along ``dim`` (or stacked as a new ``dim``
    with ``stack``), on ``device`` (default: the first piece's)."""
    device = pieces[0].device if device is None else device
    moved = [_on(p, device) for p in pieces]
    out = torch.stack(moved, dim) if stack else torch.cat(moved, dim)
    _count("all-gather", [out])
    return out


def all_reduce_sum(pieces: Sequence[torch.Tensor], *, dtype=None,
                   device=None) -> torch.Tensor:
    """The sum of the pieces, added in f32 in mesh order and cast once to
    ``dtype`` (default: the pieces' dtype), on ``device`` (default: the
    first piece's)."""
    device = pieces[0].device if device is None else device
    dtype = pieces[0].dtype if dtype is None else dtype
    acc = _on(pieces[0], device).float()
    for p in pieces[1:]:
        acc = acc + _on(p, device).float()
    out = acc.to(dtype)
    _count("all-reduce", [out])
    return out


def all_to_all(pieces: Sequence[torch.Tensor], split_dim: int = 0,
               concat_dim: int = 0) -> List[torch.Tensor]:
    """Position ``i`` sends the ``j``-th of its ``n`` chunks along
    ``split_dim`` to position ``j``, which concatenates what it receives
    along ``concat_dim`` in sender order (``lax.all_to_all`` with
    ``tiled=False`` when ``split_dim == concat_dim == 0`` and each piece
    has n rows)."""
    n = len(pieces)
    chunks = [torch.chunk(p, n, dim=split_dim) for p in pieces]
    out = [torch.cat([_on(chunks[i][j], pieces[j].device) for i in range(n)], concat_dim)
           for j in range(n)]
    _count("all-to-all", out)
    return out


def ppermute(pieces: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> List[Optional[torch.Tensor]]:
    """Position ``src`` sends its tensor to ``dst`` for each pair; a
    position nothing is sent to receives zeros, as ``lax.ppermute``."""
    out: List[Optional[torch.Tensor]] = [torch.zeros_like(p) for p in pieces]
    for src, dst in perm:
        out[dst] = _on(pieces[src], pieces[dst].device)
    _count("collective-permute", [out[dst] for _, dst in perm])
    return out


__all__ = ["KINDS", "all_gather", "all_reduce_sum", "all_to_all", "calls", "ppermute",
           "reset_result_bytes", "result_bytes"]
