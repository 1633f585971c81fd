"""A mesh engine's slot state sharded over the mesh, and decode attention
run where each piece of it lives.

The counterpart of the reference's ``cache_shardings`` placement of a
tensor-parallel engine's slot state (``distributed/sharding.py``): every
leaf whose spec splits it becomes a ``ShardedTensor``
(:func:`place_slot_state`).  An attention ``k``/``v`` leaf [..., B, T,
K, hd] has its slots over "data" where they divide, its KV heads over
"model" where they divide, else its ``head_dim``; rwkv ``S`` [..., B, H,
N, N] and mamba ``h`` [..., B, H, P, N] their slots over "data" and
their heads over "model"; the token-shift carries ``tm_x``/``cm_x``,
the conv window and whisper's ``enc_len`` their slots over "data".  A
leaf split over both is a "data" ``ShardedTensor`` of "model" ones; a
leaf its spec replicates stays whole on the mesh's first device.  A
sequence split (slots that do not divide "data" while the positions do)
is not handled and raises.

The recurrent pieces are read where they live by rwkv's and mamba's
``_sharded_decode`` (model position ``j`` runs the scan over its heads,
data position ``i`` over its rows; :func:`head_layout`,
:func:`piece_of`), and a slot-split carry is gathered over its slots
for the step and written back (:func:`read_slots`,
:func:`write_slots`).  Decode attention over a sharded k/v cache
(:func:`decode_attention`, called by ``transformer._decode_attn_block``
and encdec's decode, the only readers of a sharded k/v leaf) runs piece
by piece:

* KV heads split (K divides M): the rule table cuts ``wq``, ``wk`` and
  ``wv`` by columns in the same head order, so model position ``j``
  computes its query heads' q and its KV heads' k/v from its pieces
  (rope per head), writes k/v into its cache piece, attends there, and
  multiplies the result by ``wo``'s row piece ``j``; the partial
  products are summed in f32 in mesh order.  No q/k/v gather.
* ``head_dim`` split (K does not divide M, ``wk``/``wv`` replicated): q,
  k and v are whole on the first device; each piece takes its ``hd``
  slice of k/v, the scores are the f32 sum in mesh order of every
  piece's partial ``q[..., hd_j] . k_j``, softcap, mask and softmax run
  once, and each piece's ``p @ v_j`` is gathered along ``hd``.  The
  cache is never gathered.
* "data": each data position attends for its own slots (a contiguous
  block of ``B / D`` rows); the rows' outputs are gathered before
  ``wo``.

Admission (:func:`write_rows`) splits each prefilled row's state into
the pieces by the same rules; the engine hands the rows of each data
position over as device tensors (:class:`RowSplit`), computed on the
host outside the step methods.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.compressed import ShardedTensor, matmul, param_bytes, piece_device
from repro_torch.distributed import collectives
from repro_torch.models import layers as L
from repro_torch.tree import flatten_with_path, unflatten_like


class RowSplit(NamedTuple):
    """An admission's slot indices ``idx`` [n] and, for each data
    position, ``(rows, local)``: which rows of the admission it takes and
    their slot indices within its piece (device tensors), or ``None``."""
    idx: torch.Tensor
    parts: List[Optional[Tuple[torch.Tensor, torch.Tensor]]]


def split_rows(slot_idxs, slots: int, n_data: int, to_device) -> RowSplit:
    """:class:`RowSplit` of the host slot indices ``slot_idxs`` over
    ``n_data`` data positions of ``slots / n_data`` slots each;
    ``to_device`` moves a numpy array to the engine's device."""
    slot_idxs = np.asarray(slot_idxs)
    b = slots // n_data
    parts = []
    for i in range(n_data):
        rows = np.nonzero(slot_idxs // b == i)[0]
        parts.append((to_device(rows), to_device(slot_idxs[rows] - i * b)) if len(rows)
                     else None)
    return RowSplit(to_device(slot_idxs), parts)


def _kv_leaf(path, t) -> bool:
    names = [k for k in path if isinstance(k, str)]
    return bool(names) and names[-1] in ("k", "v") and t.dim() >= 4


def place_slot_state(state, cfg, mesh):
    """``state`` (a contiguous slot state on the mesh's first device) with
    every leaf placed by the reference's ``cache_shardings`` through
    ``sharding.place``: k/v over slots and KV heads (or head_dim), rwkv
    ``S`` and mamba ``h`` over slots and heads, the other recurrent leaves
    and ``enc_len`` over slots; a leaf whose spec splits nothing stays
    where it is."""
    from repro_torch.distributed.sharding import P, NamedSharding, cache_shardings, place
    specs = cache_shardings(cfg, state, mesh)
    flat = flatten_with_path(state)
    spec_of = dict(flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P)))
    shardings = []
    for path, t in flat:
        spec = spec_of[path]
        if all(ax is None for ax in spec):
            shardings.append(None)
            continue
        if _kv_leaf(path, t) and spec[-3] is not None:
            raise NotImplementedError(
                f"{'.'.join(map(str, path))}: a sequence-split slot state ({spec}): "
                "give the engine a slot count the 'data' axis divides")
        shardings.append(NamedSharding(mesh, spec))
    return place(state, unflatten_like(state, shardings))


def state_position_bytes(state, i: int) -> int:
    """Bytes mesh position ``i`` holds of a slot state placed by
    :func:`place_slot_state`, by the reference's accounting (as
    ``compressed.position_bytes`` counts params): its piece of each
    sharded leaf, and every leaf the spec replicates whole (the port keeps
    one copy of it, on the mesh's first device)."""
    return sum(param_bytes(t.piece_at(i)) if isinstance(t, ShardedTensor) else param_bytes(t)
               for _, t in flatten_with_path(state))


def data_split(state) -> int:
    """How many data positions split the slots of ``state``."""
    for _, t in flatten_with_path(state):
        if isinstance(t, ShardedTensor) and t.axis == "data":
            return len(t.pieces)
    return 1


def write_rows(leaf, axis: int, slot_idxs, rows) -> None:
    """Write the batch-n ``rows`` (slot axis ``axis``) into ``leaf`` at
    ``slot_idxs`` (a tensor, or a :class:`RowSplit` where "data" splits
    the slots), in place: a sharded leaf's pieces each take their rows and
    their share of the heads or of ``head_dim``."""
    if not isinstance(leaf, ShardedTensor):
        idx = slot_idxs.idx if isinstance(slot_idxs, RowSplit) else slot_idxs
        idx = torch.as_tensor(idx, device=leaf.device).long()
        leaf.index_copy_(axis, idx, rows.to(leaf.device, leaf.dtype))
        return
    if leaf.axis == "data" and leaf.dim == axis - rows.dim():
        if not isinstance(slot_idxs, RowSplit):
            raise ValueError("a slot state split over 'data' is written through a RowSplit")
        for piece, part in zip(leaf.pieces, slot_idxs.parts):
            if part is not None:
                sel, local = part
                write_rows(piece, axis, local, rows.index_select(axis, sel.to(rows.device)))
        return
    if leaf.axis == "model":
        for piece, r in zip(leaf.pieces, torch.chunk(rows, len(leaf.pieces), dim=leaf.dim)):
            write_rows(piece, axis, slot_idxs, r)
        return
    raise NotImplementedError(f"a slot-state leaf sharded along dim {leaf.dim} "
                              f"over {leaf.axis!r}")


def read_slots(leaf, device) -> torch.Tensor:
    """A recurrent leaf's rows for every slot on ``device``: a data-split
    leaf's pieces gathered along its slots, a whole one as it is."""
    if not isinstance(leaf, ShardedTensor):
        return leaf.to(device)
    return collectives.all_gather(list(leaf.pieces), dim=leaf.dim, device=device)


def write_slots(leaf, value: torch.Tensor) -> None:
    """``value`` (every slot's rows, on the first device) written into the
    leaf in place, in its dtype: each data piece takes its own rows."""
    if not isinstance(leaf, ShardedTensor):
        leaf.copy_(value)
        return
    for piece, rows in zip(leaf.pieces, torch.chunk(value, len(leaf.pieces), dim=leaf.dim)):
        piece.copy_(rows)


def head_layout(leaf) -> Tuple[int, int]:
    """(data pieces, model pieces) of one layer's recurrent state over
    heads, rwkv ``S`` [B, H, N, N] or mamba ``h`` [B, H, P, N]: slots over
    "data", heads over "model"."""
    n_d, n_m = 1, 1
    t = leaf
    while isinstance(t, ShardedTensor):
        if t.axis == "data" and t.dim == -4:
            n_d = len(t.pieces)
        elif t.axis == "model" and t.dim == -3:
            n_m = len(t.pieces)
        else:
            raise NotImplementedError(f"a recurrent leaf sharded along dim {t.dim} "
                                      f"over {t.axis!r}")
        t = t.pieces[0]
    return n_d, n_m


def gather_heads(outs, n_d: int, n_m: int, device, dim: int = -2):
    """Per model position ``j`` its data positions' rows ``outs[j]``
    ([b, ..., heads of j, ...] each): the rows gathered, then the heads
    along ``dim``, on ``device``."""
    per_j = [_gather_rows(o, n_d, device) for o in outs]
    return per_j[0] if n_m == 1 else collectives.all_gather(per_j, dim=dim, device=device)


def layout(leaf) -> Tuple[int, Optional[int], int]:
    """(data pieces, the model split's dim or None, model pieces) of one
    layer's sharded k/v leaf [B, T, K, hd]."""
    n_d, mdim, n_m = 1, None, 1
    t = leaf
    while isinstance(t, ShardedTensor):
        if t.axis == "data" and t.dim == -4:
            n_d = len(t.pieces)
        elif t.axis == "model" and t.dim in (-2, -1):
            mdim, n_m = t.dim, len(t.pieces)
        else:
            raise NotImplementedError(f"a slot-state leaf sharded along dim {t.dim} "
                                      f"over {t.axis!r}")
        t = t.pieces[0]
    return n_d, mdim, n_m


def piece_of(leaf, i: int, j: int) -> torch.Tensor:
    """Data position ``i``'s, model position ``j``'s piece of a leaf."""
    t = leaf
    if isinstance(t, ShardedTensor) and t.axis == "data":
        t = t.pieces[i]
    if isinstance(t, ShardedTensor):
        t = t.pieces[j]
    return t


def model_pieces(w, n: int, what: str) -> list:
    """``w``'s ``n`` column pieces along "model" (``[w]`` when ``n`` is 1)."""
    if n == 1:
        return [w]
    if isinstance(w, ShardedTensor) and w.axis == "model" and w.dim == -1 \
            and len(w.pieces) == n:
        return w.pieces
    raise NotImplementedError(f"{what} is not cut into the cache's {n} head pieces: {w!r}")


def rows_of(t, i: int, b: int, n_d: int):
    return t if n_d == 1 else t[i * b:(i + 1) * b]


def _valid_rows(valid, i: int, b: int, n_d: int):
    """Data position ``i``'s rows of ``valid``: a whole [B, T] mask, or a
    list holding each data position's own (built where its rows live)."""
    return valid[i] if isinstance(valid, (list, tuple)) else rows_of(valid, i, b, n_d)


def _gather_rows(pieces, n_d: int, device):
    """One data position's rows each, concatenated on ``device``."""
    if n_d == 1:
        return pieces[0].to(device)
    return collectives.all_gather(pieces, dim=0, device=device)


def decode_attention(p, h, c, cfg, *, pos, valid, theta: Optional[float] = None,
                     cap: float = 0.0, write: bool = True):
    """One decode token a row through attention ``p`` (``wq``/``wk``/``wv``/
    ``wo``) over the sharded cache ``c`` ({"k", "v"}, one layer's [B, T,
    K, hd] leaves), then ``wo``: the [B, 1, d] result on the mesh's first
    device.  ``h`` [B, 1, d] is the normed input, ``pos`` [B] each row's
    position, ``valid`` [B, T] the slots each row attends to; ``theta``
    applies rope; ``write`` stores this step's k/v at slot ``pos % T`` (a
    compact local cache is a circular buffer of T slots; an absolute one
    has ``pos < T``; a cross cache is read only)."""
    n_d, mdim, n_m = layout(c["k"])
    if mdim == -1:
        return _decode_hd_split(p, h, c, cfg, pos=pos, valid=valid, theta=theta, cap=cap,
                                write=write, n_d=n_d, n_m=n_m)
    B, hd = h.shape[0], cfg.resolved_head_dim
    b = B // n_d
    first = h.device
    wq = model_pieces(p["wq"], n_m, "wq")
    wk = model_pieces(p["wk"], n_m, "wk") if write else None
    wv = model_pieces(p["wv"], n_m, "wv") if write else None
    outs = []                                    # per model position: [B, 1, H/M, hd]
    for j in range(n_m):
        dev = piece_device(wq[j]) if n_m > 1 else first
        hj, posj = h.to(dev), pos.to(dev)
        q = matmul(hj, wq[j]).reshape(B, 1, -1, hd)
        if theta is not None:
            q = L.apply_rope(q, posj[:, None], theta)
        if write:
            k = matmul(hj, wk[j]).reshape(B, 1, -1, hd)
            v = matmul(hj, wv[j]).reshape(B, 1, -1, hd)
            if theta is not None:
                k = L.apply_rope(k, posj[:, None], theta)
        rows_out = []
        for i in range(n_d):
            ck, cv = piece_of(c["k"], i, j), piece_of(c["v"], i, j)
            at = ck.device
            pi = rows_of(pos, i, b, n_d).to(at) % ck.shape[1]
            if write:
                bidx = torch.arange(b, device=at)
                ck[bidx, pi] = rows_of(k, i, b, n_d)[:, 0].to(at, ck.dtype)
                cv[bidx, pi] = rows_of(v, i, b, n_d)[:, 0].to(at, cv.dtype)
            qg = rows_of(q, i, b, n_d).to(at)
            G = qg.shape[2] // ck.shape[2]
            o = L._sdpa(qg.reshape(b, 1, ck.shape[2], G, hd), ck, cv,
                        _valid_rows(valid, i, b, n_d).to(at)[:, None, None, None, :], cap)
            rows_out.append(o.reshape(b, 1, -1, hd))
        outs.append(rows_out)
    wo = p["wo"]
    if n_m > 1 and isinstance(wo, ShardedTensor) and wo.axis == "model" and wo.dim == -2 \
            and len(wo.pieces) == n_m:
        parts = [matmul(_gather_rows(outs[j], n_d, piece_device(wo.pieces[j])).reshape(B, 1, -1),
                        wo.pieces[j]) for j in range(n_m)]
        return collectives.all_reduce_sum(parts, device=first)
    heads = [_gather_rows(outs[j], n_d, first) for j in range(n_m)]
    out = heads[0] if n_m == 1 else collectives.all_gather(heads, dim=-2, device=first)
    return matmul(out.reshape(B, 1, -1), wo)


def _decode_hd_split(p, h, c, cfg, *, pos, valid, theta, cap, write, n_d, n_m):
    """:func:`decode_attention` over a cache cut along ``head_dim``."""
    B, hd, H, K = h.shape[0], cfg.resolved_head_dim, cfg.n_heads, c["k"].shape[-2]
    b, hj = B // n_d, hd // n_m
    first = h.device
    q = matmul(h, p["wq"]).reshape(B, 1, H, hd)
    if theta is not None:
        q = L.apply_rope(q, pos[:, None], theta)
    if write:
        k = matmul(h, p["wk"]).reshape(B, 1, K, hd)
        v = matmul(h, p["wv"]).reshape(B, 1, K, hd)
        if theta is not None:
            k = L.apply_rope(k, pos[:, None], theta)
    scale = 1.0 / math.sqrt(hd)
    rows_out = []
    for i in range(n_d):
        qg = rows_of(q, i, b, n_d).reshape(b, 1, K, H // K, hd)
        pi = rows_of(pos, i, b, n_d) % c["k"].shape[-3]
        partial = []
        for j in range(n_m):
            ck, cv = piece_of(c["k"], i, j), piece_of(c["v"], i, j)
            at, sl = ck.device, slice(j * hj, (j + 1) * hj)
            if write:
                bidx = torch.arange(b, device=at)
                ck[bidx, pi.to(at)] = rows_of(k, i, b, n_d)[:, 0, :, sl].to(at, ck.dtype)
                cv[bidx, pi.to(at)] = rows_of(v, i, b, n_d)[:, 0, :, sl].to(at, cv.dtype)
            partial.append(torch.einsum("bskgd,btkd->bkgst", qg[..., sl].to(at).float(),
                                        ck.float()))
        logits = collectives.all_reduce_sum(partial, dtype=torch.float32, device=first) * scale
        logits = L.softcap(logits, cap)
        mask = _valid_rows(valid, i, b, n_d).to(first)
        logits = logits.masked_fill(~mask[:, None, None, None, :], L.NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        pv = []
        for j in range(n_m):
            cv = piece_of(c["v"], i, j)
            pv.append(torch.einsum("bkgst,btkd->bskgd", probs.to(cv.device, cv.dtype).float(),
                                   cv.float()).to(cv.dtype))
        rows_out.append(collectives.all_gather(pv, dim=-1, device=first).reshape(b, 1, H, hd))
    out = _gather_rows(rows_out, n_d, first)
    return matmul(out.reshape(B, 1, -1), p["wo"])


__all__ = ["RowSplit", "data_split", "decode_attention", "gather_heads", "head_layout",
           "layout", "model_pieces", "piece_of", "place_slot_state", "read_slots", "rows_of",
           "split_rows", "state_position_bytes", "write_rows", "write_slots"]
