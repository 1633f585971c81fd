"""A mesh engine's slot state sharded over the mesh, and decode attention
run where each piece of it lives.

The counterpart of the reference's ``cache_shardings`` placement of a
tensor-parallel engine's slot state (``distributed/sharding.py``): every
leaf whose spec splits it becomes a ``ShardedTensor``
(:func:`place_slot_state`).  An attention ``k``/``v`` leaf [..., B, T,
K, hd] has its slots over the data axes ("data", or "pod" and "data" on
the multi-pod mesh) where they divide, else its positions over "data"
where those divide (the reference's sequence parallelism), and its KV
heads over "model" where they divide, else its ``head_dim``; rwkv ``S``
[..., B, H, N, N] and mamba ``h`` [..., B, H, P, N] their slots over
the data axes and their heads over "model"; the token-shift carries
``tm_x``/``cm_x``, the conv window and whisper's ``enc_len`` their slots
over the data axes.  A leaf split over several axes is a nested
``ShardedTensor``, outermost first (slots over "pod" of "data" pieces of
"model" ones); a leaf its spec replicates stays whole on the mesh's
first device.  A split over "pod" and "data" is read as one split of
pod x data pieces, pod-major (:func:`dim_pieces`), as the reference's
``P(("pod", "data"), ...)`` and a row-major device grid place them.

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
* slots over the data axes: each data position attends for its own slots
  (a contiguous block of ``B / D`` rows); the rows' outputs are gathered
  before ``wo``.
* positions over "data" (the sequence split): data position ``i`` holds
  slots ``[i T/D, (i+1) T/D)`` of every row (buffer slots of a compact
  local layer, positions otherwise).  This step's k/v goes only into the
  piece that holds slot ``pos % T``, at its local offset.  Each piece
  computes its f32 scores (summed over the ``head_dim`` pieces first
  where those split), softcaps and masks them, and keeps its max
  ``m_i`` and ``l_i = sum exp(s - m_i)``.  The pieces merge in mesh
  order: ``m = max m_i`` (:func:`position_weights`), ``den = sum l_i
  e^{m_i - m}``, and ``o = sum_i (exp(s - m_i) e^{m_i - m} / den) v_i``,
  ``sum o_i e^{m_i - m} / den`` with each piece's probabilities rounded
  to v's dtype as the unsharded softmax rounds its own (a bf16 step
  then parts from the unsharded one by little more than the summation
  order).  A piece with no valid slot has ``m_i = NEG_INF`` and weight
  0, and no piece divides by its own sum.

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


_DATA_AXES = ("pod", "data")
# the dim of each slot-state leaf that holds its slots
_SLOT_DIM = {"k": -4, "v": -4, "S": -4, "h": -4, "conv": -3, "tm_x": -2, "cm_x": -2,
            "enc_len": -1}


class RowSplit(NamedTuple):
    """An admission's slot indices ``idx`` [n] and, for each data
    position, ``(rows, local)``: which rows of the admission it takes and
    their slot indices within its piece (device tensors), or ``None``."""
    idx: torch.Tensor
    parts: List[Optional[Tuple[torch.Tensor, torch.Tensor]]]


def split_rows(slot_idxs, slots: int, n_data: int, to_device) -> RowSplit:
    """:class:`RowSplit` of the host slot indices ``slot_idxs`` over
    ``n_data`` data positions (pod x data on the multi-pod mesh, pod-major)
    of ``slots / n_data`` slots each; ``to_device`` moves a numpy array to
    the engine's device."""
    slot_idxs = np.asarray(slot_idxs)
    b = slots // n_data
    parts = []
    for i in range(n_data):
        rows = np.nonzero(slot_idxs // b == i)[0]
        parts.append((to_device(rows), to_device(slot_idxs[rows] - i * b)) if len(rows)
                     else None)
    return RowSplit(to_device(slot_idxs), parts)


def dim_pieces(t) -> list:
    """A sharded leaf's pieces along its outermost split dim, in mesh
    order: where a second axis splits the same dim (slots over "pod", then
    "data"), its pieces flattened, major in the first axis."""
    out = []
    for p in t.pieces:
        out.extend(dim_pieces(p) if isinstance(p, ShardedTensor) and p.dim == t.dim else [p])
    return out


def place_slot_state(state, cfg, mesh):
    """``state`` (a contiguous slot state on the mesh's first device) with
    every leaf placed by the reference's ``cache_shardings`` through
    ``sharding.place``: k/v over slots (or, where the slots do not divide
    "data", over positions) and KV heads (or head_dim), rwkv ``S`` and
    mamba ``h`` over slots and heads, the other recurrent leaves and
    ``enc_len`` over slots, slots over "pod" and "data" on the multi-pod
    mesh; a leaf whose spec splits nothing stays where it is."""
    from repro_torch.distributed.sharding import P, NamedSharding, cache_shardings, place
    specs = cache_shardings(cfg, state, mesh)
    spec_of = dict(flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P)))
    shardings = [None if all(ax is None for ax in spec_of[path])
                 else NamedSharding(mesh, spec_of[path])
                 for path, _ in flatten_with_path(state)]
    return place(state, unflatten_like(state, shardings))


def state_position_bytes(state, i: int) -> int:
    """Bytes mesh position ``i`` holds of a slot state placed by
    :func:`place_slot_state`, by the reference's accounting (as
    ``compressed.position_bytes`` counts params): its piece of each
    sharded leaf, and every leaf the spec replicates whole (the port keeps
    one copy of it, on the mesh's first device)."""
    return sum(param_bytes(t.piece_at(i)) if isinstance(t, ShardedTensor) else param_bytes(t)
               for _, t in flatten_with_path(state))


def _slot_split(path, t) -> bool:
    """Whether the data axes split the slots of the leaf ``t`` at ``path``
    (not a k/v leaf's positions)."""
    return (isinstance(t, ShardedTensor) and t.axis in _DATA_AXES
            and t.dim == _SLOT_DIM.get(path[-1]))


def data_split(state) -> int:
    """How many data positions (pod x data) split the slots of ``state``:
    1 where none do, a sequence split's included."""
    for path, t in flatten_with_path(state):
        if _slot_split(path, t):
            return len(dim_pieces(t))
    return 1


def write_rows(leaf, axis: int, slot_idxs, rows) -> None:
    """Write the batch-n ``rows`` (slot axis ``axis``) into ``leaf`` at
    ``slot_idxs`` (a tensor, or a :class:`RowSplit` where the data axes
    split the slots), in place: a sharded leaf's pieces each take their
    rows, their positions (a sequence split), and their share of the
    heads or of ``head_dim``."""
    if not isinstance(leaf, ShardedTensor):
        idx = slot_idxs.idx if isinstance(slot_idxs, RowSplit) else slot_idxs
        idx = torch.as_tensor(idx, device=leaf.device).long()
        leaf.index_copy_(axis, idx, rows.to(leaf.device, leaf.dtype))
        return
    if leaf.axis in _DATA_AXES and leaf.dim == axis - rows.dim():
        if not isinstance(slot_idxs, RowSplit):
            raise ValueError("a slot state split over 'data' is written through a RowSplit")
        for piece, part in zip(dim_pieces(leaf), slot_idxs.parts):
            if part is not None:
                sel, local = part
                write_rows(piece, axis, local, rows.index_select(axis, sel.to(rows.device)))
        return
    if leaf.axis == "model" or (leaf.axis == "data" and leaf.dim == axis + 1 - rows.dim()):
        for piece, r in zip(leaf.pieces, torch.chunk(rows, len(leaf.pieces), dim=leaf.dim)):
            write_rows(piece, axis, slot_idxs, r)
        return
    raise NotImplementedError(f"a slot-state leaf sharded along dim {leaf.dim} "
                              f"over {leaf.axis!r}")


def read_slots(leaf, device) -> torch.Tensor:
    """A recurrent leaf's rows for every slot on ``device``: a slot-split
    leaf's pieces gathered along its slots, a whole one as it is."""
    if not isinstance(leaf, ShardedTensor):
        return leaf.to(device)
    return collectives.all_gather(dim_pieces(leaf), dim=leaf.dim, device=device)


def write_slots(leaf, value: torch.Tensor) -> None:
    """``value`` (every slot's rows, on the first device) written into the
    leaf in place, in its dtype: each data piece takes its own rows."""
    if not isinstance(leaf, ShardedTensor):
        leaf.copy_(value)
        return
    pieces = dim_pieces(leaf)
    for piece, rows in zip(pieces, torch.chunk(value, len(pieces), dim=leaf.dim)):
        piece.copy_(rows)


def head_layout(leaf) -> Tuple[int, int]:
    """(data pieces, model pieces) of one layer's recurrent state over
    heads, rwkv ``S`` [B, H, N, N] or mamba ``h`` [B, H, P, N]: slots over
    the data axes (pod x data pieces), heads over "model"."""
    n_d, n_m = 1, 1
    t = leaf
    while isinstance(t, ShardedTensor):
        if t.axis in _DATA_AXES and t.dim == -4:
            n_d *= len(t.pieces)
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


class KVLayout(NamedTuple):
    """How one layer's sharded k/v leaf [B, T, K, hd] is cut."""
    data: int                   # pieces over the data axes (pod x data)
    model_dim: Optional[int]    # -2 (KV heads) or -1 (head_dim) over "model", or None
    model: int                  # pieces over "model"
    data_dim: Optional[int]     # -4 (slots) or -3 (positions: the sequence split), or None


def layout(leaf) -> KVLayout:
    """:class:`KVLayout` of one layer's sharded k/v leaf [B, T, K, hd]."""
    n_d, ddim, mdim, n_m = 1, None, None, 1
    t = leaf
    while isinstance(t, ShardedTensor):
        if t.axis in _DATA_AXES and t.dim in (-4, -3):
            n_d, ddim = n_d * len(t.pieces), t.dim
        elif t.axis == "model" and t.dim in (-2, -1):
            mdim, n_m = t.dim, len(t.pieces)
        else:
            raise NotImplementedError(f"a slot-state leaf sharded along dim {t.dim} "
                                      f"over {t.axis!r}")
        t = t.pieces[0]
    return KVLayout(n_d, mdim, n_m, ddim)


def piece_of(leaf, i: int, j: int) -> torch.Tensor:
    """Data position ``i``'s (pod x data, pod-major), model position
    ``j``'s piece of a leaf."""
    t = leaf
    if isinstance(t, ShardedTensor) and t.axis in _DATA_AXES:
        t = dim_pieces(t)[i]
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


def _write_slot(ck, cv, k, v, slot, s: int, n_s: int) -> None:
    """This step's ``k``/``v`` [b, K', hd'] into the cache pieces ``ck``/
    ``cv`` [b, Ts, K', hd'], in place, at slot ``slot`` [b] (``pos % T``).
    The pieces hold slots ``[s Ts, (s+1) Ts)`` of ``n_s`` position pieces:
    a row whose slot lies in another piece rewrites its entry at the
    clamped offset unchanged, so no row index leaves the device."""
    at, Ts = ck.device, ck.shape[1]
    bidx = torch.arange(ck.shape[0], device=at)
    local = slot.to(at)
    if n_s == 1:
        ck[bidx, local] = k.to(at, ck.dtype)
        cv[bidx, local] = v.to(at, cv.dtype)
        return
    local = local - s * Ts
    hit = ((local >= 0) & (local < Ts))[:, None, None]
    local = local.clamp(0, Ts - 1)
    for cache, new in ((ck, k), (cv, v)):
        cache[bidx, local] = torch.where(hit, new.to(at, cache.dtype), cache[bidx, local])


def _piece_sums(scores, mask, cap: float):
    """One position piece's f32 ``scores`` [b, K, G, 1, Ts] softcapped and
    masked (``NEG_INF`` where ``mask`` [b, Ts] is False): their max ``m_i``
    [b, K, G, 1, 1], ``exp(s - m_i)`` and ``l_i``, its sum.  A piece with
    no valid slot has ``m_i = NEG_INF`` and ``l_i = Ts``; the merge weighs
    it by 0 (:func:`position_weights`), so it adds nothing."""
    s = L.softcap(scores, cap).masked_fill(~mask[:, None, None, None, :], L.NEG_INF)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    return m, e, e.sum(-1, keepdim=True)


def position_weights(ms, device) -> torch.Tensor:
    """``e^{m_i - m}``, ``m = max_i m_i``: each position piece's weight in
    the merge, stacked [n_s, ...] on ``device`` (the pieces' maxima
    gathered in mesh order)."""
    m = collectives.all_gather(ms, dim=0, device=device, stack=True)
    return torch.exp(m - m.amax(0, keepdim=True))


def _denominator(sums, w, device) -> torch.Tensor:
    """``sum_i l_i w_i`` in f32 on ``device``."""
    return collectives.all_reduce_sum([l * w[i].to(l.device) for i, (_, _, l) in enumerate(sums)],
                                      dtype=torch.float32, device=device)


def _pv(e, w, den, cv) -> torch.Tensor:
    """One position piece's share of the row's attention output: its
    probabilities over the whole row, ``exp(s - m_i) w_i / den``, rounded
    to v's dtype (as ``L._sdpa`` rounds its probabilities), times its v
    [b, Ts, K, hd]: [b, K, G, 1, hd] in f32."""
    at = cv.device
    p = e.to(at) * (w.to(at) / den.to(at))
    return torch.einsum("bkgst,btkd->bkgsd", p.to(cv.dtype).float(), cv.float())


def _merged(parts, device, dtype) -> torch.Tensor:
    """The position pieces' shares summed in f32 in mesh order on
    ``device``, cast to ``dtype``: [b, 1, K, G, hd]."""
    o = collectives.all_reduce_sum(parts, dtype=torch.float32, device=device)
    return o.to(dtype).permute(0, 3, 1, 2, 4)


def decode_attention(p, h, c, cfg, *, pos, valid, theta: Optional[float] = None,
                     cap: float = 0.0, write: bool = True):
    """One decode token a row through attention ``p`` (``wq``/``wk``/``wv``/
    ``wo``) over the sharded cache ``c`` ({"k", "v"}, one layer's [B, T,
    K, hd] leaves), then ``wo``: the [B, 1, d] result on the mesh's first
    device.  ``h`` [B, 1, d] is the normed input, ``pos`` [B] each row's
    position, ``valid`` [B, T] the slots each row attends to (a piece of
    a sequence split takes its columns); ``theta`` applies rope; ``write``
    stores this step's k/v at slot ``pos % T`` (a compact local cache is a
    circular buffer of T slots; an absolute one has ``pos < T``; a cross
    cache is read only)."""
    lay = layout(c["k"])
    if lay.model_dim == -1:
        return _decode_hd_split(p, h, c, cfg, pos=pos, valid=valid, theta=theta, cap=cap,
                                write=write, lay=lay)
    n_d = lay.data if lay.data_dim == -4 else 1            # slot pieces
    n_s = lay.data if lay.data_dim == -3 else 1            # position pieces
    n_m = lay.model
    B, hd = h.shape[0], cfg.resolved_head_dim
    b = B // n_d
    first = h.device
    slot = pos % c["k"].shape[-3]
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
        if n_s > 1:
            sums = []
            for s in range(n_s):
                ck, cv = piece_of(c["k"], s, j), piece_of(c["v"], s, j)
                at, Ts, Kj = ck.device, ck.shape[1], ck.shape[2]
                if write:
                    _write_slot(ck, cv, k[:, 0], v[:, 0], slot, s, n_s)
                scores = torch.einsum("bskgd,btkd->bkgst",
                                      q.to(at).reshape(B, 1, Kj, -1, hd).float(),
                                      ck.float()) * (1.0 / math.sqrt(hd))
                sums.append(_piece_sums(scores, valid[:, s * Ts:(s + 1) * Ts].to(at), cap))
            w = position_weights([m for m, _, _ in sums], dev)
            den = _denominator(sums, w, dev)
            o = _merged([_pv(e, w[s], den, piece_of(c["v"], s, j))
                         for s, (_, e, _) in enumerate(sums)], dev, c["v"].dtype)
            outs.append([o.reshape(B, 1, -1, hd)])
            continue
        rows_out = []
        for i in range(n_d):
            ck, cv = piece_of(c["k"], i, j), piece_of(c["v"], i, j)
            at = ck.device
            if write:
                _write_slot(ck, cv, rows_of(k, i, b, n_d)[:, 0], rows_of(v, i, b, n_d)[:, 0],
                            rows_of(slot, i, b, n_d), 0, 1)
            qg = rows_of(q, i, b, n_d).to(at)
            G = qg.shape[2] // ck.shape[2]
            o = L._sdpa(qg.reshape(b, 1, ck.shape[2], G, hd), ck, cv,
                        _valid_rows(valid, i, b, n_d).to(at)[:, None, None, None, :], cap)
            rows_out.append(o.reshape(b, 1, -1, hd))
        outs.append(rows_out)
    n_rows = n_d if n_s == 1 else 1
    wo = p["wo"]
    if n_m > 1 and isinstance(wo, ShardedTensor) and wo.axis == "model" and wo.dim == -2 \
            and len(wo.pieces) == n_m:
        parts = [matmul(_gather_rows(outs[j], n_rows, piece_device(wo.pieces[j]))
                        .reshape(B, 1, -1), wo.pieces[j]) for j in range(n_m)]
        return collectives.all_reduce_sum(parts, device=first)
    heads = [_gather_rows(outs[j], n_rows, first) for j in range(n_m)]
    out = heads[0] if n_m == 1 else collectives.all_gather(heads, dim=-2, device=first)
    return matmul(out.reshape(B, 1, -1), wo)


def _decode_hd_split(p, h, c, cfg, *, pos, valid, theta, cap, write, lay):
    """:func:`decode_attention` over a cache cut along ``head_dim``: the
    scores summed over the ``hd`` pieces, then, over a sequence split,
    each position piece's sums merged."""
    n_d = lay.data if lay.data_dim == -4 else 1
    n_s = lay.data if lay.data_dim == -3 else 1
    n_m = lay.model
    B, hd, H, K = h.shape[0], cfg.resolved_head_dim, cfg.n_heads, c["k"].shape[-2]
    b, hj = B // n_d, hd // n_m
    first = h.device
    slot = pos % c["k"].shape[-3]
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
        si = rows_of(slot, i, b, n_d)
        scores = []                          # per position piece: [b, K, G, 1, Ts] f32
        for s in range(n_s):
            partial = []
            for j in range(n_m):           # data piece i + s: a block of rows or of positions
                ck, cv = piece_of(c["k"], i + s, j), piece_of(c["v"], i + s, j)
                at, sl = ck.device, slice(j * hj, (j + 1) * hj)
                if write:
                    _write_slot(ck, cv, rows_of(k, i, b, n_d)[:, 0, :, sl],
                                rows_of(v, i, b, n_d)[:, 0, :, sl], si, s, n_s)
                partial.append(torch.einsum("bskgd,btkd->bkgst", qg[..., sl].to(at).float(),
                                            ck.float()))
            scores.append(collectives.all_reduce_sum(partial, dtype=torch.float32,
                                                     device=first) * scale)
        mask = _valid_rows(valid, i, b, n_d).to(first)
        if n_s > 1:
            Ts = scores[0].shape[-1]
            sums = [_piece_sums(sc, mask[:, s * Ts:(s + 1) * Ts], cap)
                    for s, sc in enumerate(scores)]
            w = position_weights([m for m, _, _ in sums], first)
            den = _denominator(sums, w, first)
            pv = [_merged([_pv(e, w[s], den, piece_of(c["v"], s, j))
                           for s, (_, e, _) in enumerate(sums)], first, c["v"].dtype)
                  for j in range(n_m)]
        else:
            logits = L.softcap(scores[0], cap)
            logits = logits.masked_fill(~mask[:, None, None, None, :], L.NEG_INF)
            probs = torch.softmax(logits, dim=-1)
            pv = []
            for j in range(n_m):
                cv = piece_of(c["v"], i, j)
                pv.append(torch.einsum("bkgst,btkd->bskgd",
                                       probs.to(cv.device, cv.dtype).float(),
                                       cv.float()).to(cv.dtype))
        rows_out.append(collectives.all_gather(pv, dim=-1, device=first).reshape(b, 1, H, hd))
    out = _gather_rows(rows_out, n_d, first)
    return matmul(out.reshape(B, 1, -1), p["wo"])


__all__ = ["KVLayout", "RowSplit", "data_split", "decode_attention", "dim_pieces",
           "gather_heads", "head_layout", "layout", "model_pieces", "piece_of",
           "place_slot_state", "position_weights", "read_slots", "rows_of", "split_rows",
           "state_position_bytes", "write_rows", "write_slots"]
