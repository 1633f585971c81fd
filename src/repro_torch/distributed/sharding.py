"""Per-architecture partition rules: DP / TP / EP / SP on one mesh.

The counterpart of the reference's ``distributed/sharding.py``, on plain
Python: the same rule table, computing the same specs.  A spec is a
:class:`P` (a tuple subclass standing in for ``PartitionSpec``): one
entry per dim, an axis name, a tuple of axis names, or ``None``
(replicated).  The functions return specs where the reference returns
``NamedSharding``s; :func:`shard_params` applies them to a param tree.

Axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod.  Batch parallelism runs over ("pod","data"); tensor
parallelism over "model"; expert parallelism places experts on "data";
sequence parallelism puts the KV-cache/sequence axis on "data" when the
batch axis cannot use it.

Rules are divisibility-guarded: a dim is sharded only when the axis size
divides it, otherwise it degrades to replication.

Megatron-style attention TP: wq column-parallel over heads, wk/wv
column-parallel only when kv-heads divide the model axis (else KV is
replicated, the GQA fallback), wo row-parallel.  MLP: wi/wg column-, wo
row-parallel.  Embedding vocab-sharded, unembed vocab-column-sharded.

The reference's ``OPT`` switches are all off by default; the port
computes what the reference computes with every one off, and has no
switch.  ``constrain``/``constrain_moe`` are no-ops with every switch
off and are not ported.

:func:`shard_params` (the counterpart of ``param_shardings`` followed by
``jax.device_put``) replaces each sharded leaf by a ``ShardedTensor``
holding one piece per position along each sharded axis.  Where a
row-parallel ``QTensor``'s pieces would start inside a quantization
group (``(d_in / n) % group != 0``: the reference shards its codes and
replicates its scales), the port keeps that ``QTensor`` whole along that
axis (:func:`replicated_qtensor_leaves` lists them).

A placed tree trains as it is (``training/``): :func:`placed_zeros`
builds an optimizer state placed by :func:`opt_state_shardings` with no
whole copy, :func:`spec_of` and :func:`shardings_of` read a placed
tree's layout back (a checkpoint is restored onto it), and
:func:`gather` and :func:`split_like` take a leaf whole and cut it
again (a checkpoint's write, the compressed all-reduce's whole leaves).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.compressed import (BlockSparseTensor, QEmbed, QTensor,
                                         ShardedTensor, idx_from_mask, piece_device)
from repro_torch.tree import flatten_with_path, tree_map, unflatten_like


class P(tuple):
    """A partition spec: ``P(None, "model")``.  A one-axis tuple entry is
    that axis, as ``PartitionSpec`` normalizes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return "P" + super().__repr__()


def _is_spec(x) -> bool:
    return isinstance(x, P)


def dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def axis_size(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    n = 1
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    for a in names:
        n *= sizes[a]
    return int(n)


def _div(dim: int, n: int) -> bool:
    return n > 1 and dim % n == 0


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

_COL = {"wq", "wi", "wg", "in_proj", "wa1", "unembed"}   # d_out -> model
_ROW = {"wo", "out_proj", "wa2"}                          # d_in  -> model
_KV = {"wk", "wv"}                                        # guarded by kv div
_REPL = {"router", "mu", "w0", "u", "gn", "conv_w", "conv_b", "A_log", "D",
         "dt_bias", "pos_enc", "pos_dec"}


def _leaf_name(path) -> str:
    """Last string key (skips a container's child index, e.g. QTensor.q)."""
    for k in reversed(path):
        if isinstance(k, str):
            return k
    return ""


def _path_str(path) -> str:
    return ".".join(str(k) for k in path)


def param_spec_fn(cfg, mesh, *, fsdp: bool = False) -> Callable:
    """Returns fn(path, shape_tuple) -> P for raw params.  ``path`` is the
    tuple of dict keys and sequence indices from the root; a compressed
    container's children carry their index (``QTensor``: 0 q, 1 scale,
    2 in_scale; ``BlockSparseTensor``: 0 w, 1 mask, 2 idx; ``QEmbed``: 0
    q, 1 scale), as the reference's pytree paths do."""
    M = axis_size(mesh, "model")
    D = axis_size(mesh, "data")
    kv_ok = _div(cfg.n_kv_heads, M)

    def spec(path, shape) -> P:
        name = _leaf_name(path)
        pstr = _path_str(path)
        rank = len(shape)
        lead = rank - 2          # stacked layer axes before the matrix
        pre = (None,) * max(lead, 0)

        def guard(s: P) -> P:
            """Drop shardings that don't divide; optionally add FSDP."""
            out = []
            for i, ax in enumerate(s):
                d = shape[lead + i] if lead >= 0 else shape[i]
                if ax is None:
                    out.append(None)
                elif _div(d, axis_size(mesh, ax)):
                    out.append(ax)
                else:
                    out.append(None)
            # FSDP: shard the remaining replicated matrix dim over data
            if fsdp and rank >= 2:
                for i in range(len(out)):
                    d = shape[lead + i]
                    if out[i] is None and _div(d, D):
                        out[i] = "data"
                        break
            return P(*pre, *out)

        if name == "embed":
            return guard(P("model", None)) if rank == 2 else P()
        if rank < 2 or name in _REPL or "ln" in name or name == "w" \
                or name == "b":
            return P(*(None,) * rank)
        # MoE expert stacks: [.., E, d_in, d_out]
        if ".moe." in f".{pstr}." and name in ("wi", "wg", "wo"):
            E = shape[lead - 1] if lead >= 1 else shape[0]
            e_ax = "data" if _div(E, D) else None
            epre = (None,) * max(lead - 1, 0)
            if name == "wo":
                body = ("model" if _div(shape[-2], M) else None, None)
            else:
                body = (None, "model" if _div(shape[-1], M) else None)
            return P(*epre, e_ax, *body)
        if name in _COL:
            return guard(P(None, "model"))
        if name in _ROW:
            return guard(P("model", None))
        if name in _KV:
            if ".cm." in f".{pstr}.":        # rwkv channel-mix: plain MLP
                return guard(P(None, "model") if name == "wk"
                             else P("model", None))
            if kv_ok:
                return guard(P(None, "model"))
            return guard(P(None, None))      # replicate KV (GQA fallback)
        if name in ("wr", "wg2"):
            return guard(P(None, "model"))
        return P(*(None,) * rank)

    return spec


def _children(leaf) -> Optional[List[Tuple[int, Any]]]:
    """A compressed container's tensors with their child index (the
    reference's pytree children, ``None`` dropped); None for a tensor."""
    if isinstance(leaf, QTensor):
        kids = [leaf.q, leaf.scale, leaf.in_scale]
    elif isinstance(leaf, BlockSparseTensor):
        kids = [leaf.w, leaf.mask, leaf.idx]
    elif isinstance(leaf, QEmbed):
        kids = [leaf.q, leaf.scale]
    else:
        return None
    return [(i, t) for i, t in enumerate(kids) if t is not None]


class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``."""

    def __init__(self, mesh, spec: P):
        self.mesh = mesh
        self.spec = spec

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"


class ChildShardings(list):
    """The shardings of a compressed container's children, in child order."""


def _is_sharding(x) -> bool:
    return isinstance(x, (NamedSharding, ChildShardings))


def param_shardings(cfg, params, mesh, *, fsdp: bool = False):
    """A tree like ``params`` whose leaves are ``NamedSharding``s (a
    compressed container's leaf is a ``ChildShardings`` of its children's)."""
    fn = param_spec_fn(cfg, mesh, fsdp=fsdp)
    flat = flatten_with_path(params)
    out = []
    for path, leaf in flat:
        kids = _children(leaf)
        out.append(NamedSharding(mesh, fn(path, tuple(leaf.shape))) if kids is None
                   else ChildShardings(NamedSharding(mesh, fn(path + (i,), tuple(t.shape)))
                                       for i, t in kids))
    return unflatten_like(params, out)


def opt_state_shardings(param_shardings_tree, mesh, kind: str = "adamw"):
    """Optimizer-state shardings derived from param shardings.

    adamw: m/v mirror params.  adafactor: vr keeps the row spec, vc the
    column spec of the factored matrix.
    """
    if kind == "adamw":
        return {"m": param_shardings_tree, "v": param_shardings_tree}

    def factored(sh):
        spec = sh.spec
        if len(spec) >= 2:
            return {"vr": NamedSharding(mesh, P(*spec[:-1])),
                    "vc": NamedSharding(mesh, P(*spec[:-2], spec[-1]))}
        return {"v": sh}

    return {"f": tree_map(factored, param_shardings_tree, is_leaf=_is_sharding)}


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def batch_shardings(cfg, batch_shapes: Dict[str, Any], mesh) -> Dict[str, P]:
    """Token/label/frontend-stub input specs (DP, falling back to SP)."""
    dp = dp_axes(mesh)
    dpn = axis_size(mesh, dp)

    def one(name, sds):
        shape = tuple(sds.shape)
        rank = len(shape)
        B = shape[0]
        bspec = dp if _div(B, dpn) else None
        if rank == 2:        # tokens / labels [B, S]
            S = shape[1]
            sspec = None
            if bspec is None and _div(S, axis_size(mesh, "data")) and S > 1:
                sspec = "data"       # sequence parallelism for batch=1 cells
            return P(bspec, sspec)
        if rank == 3:        # frame/patch embeddings [B, T, d]
            return P(bspec, None,
                     "model" if _div(shape[-1], axis_size(mesh, "model")) else None)
        return P(bspec, *(None,) * (rank - 1))

    return {k: one(k, v) for k, v in batch_shapes.items()}


def cache_shardings(cfg, cache_shapes, mesh):
    """KV-cache / recurrent-state specs, as a tree like ``cache_shapes``.

    Attention k/v leaves [..., B, T, K, hd]: batch over DP when it
    divides, else the sequence axis goes to "data" (SP); KV heads over
    "model" when they divide, else head_dim.  Recurrent states (rwkv S,
    mamba h/conv): batch over DP.
    """
    dp = dp_axes(mesh)
    dpn = axis_size(mesh, dp)
    M = axis_size(mesh, "model")
    Dn = axis_size(mesh, "data")

    def one(path, shape) -> P:
        rank = len(shape)
        name = _leaf_name(path)
        if name in ("k", "v") and rank >= 4:
            B, T, K, hd = shape[-4], shape[-3], shape[-2], shape[-1]
            pre = (None,) * (rank - 4)
            bspec = dp if _div(B, dpn) else None
            tspec = None
            if bspec is None and _div(T, Dn):
                tspec = "data"
            kspec, hspec = None, None
            if _div(K, M):
                kspec = "model"
            elif _div(hd, M):
                hspec = "model"
            return P(*pre, bspec, tspec, kspec, hspec)
        if name in ("S", "h") and rank >= 4:  # rwkv S / mamba h [..,B,H,*,*]
            pre = (None,) * (rank - 4)
            B, H = shape[-4], shape[-3]
            bspec = dp if _div(B, dpn) else None
            hspec = "model" if _div(H, M) else None
            return P(*pre, bspec, hspec, None, None)
        if name == "conv" and rank >= 3:      # mamba conv state [..,B,K-1,ch]
            pre = (None,) * (rank - 3)
            bspec = dp if _div(shape[-3], dpn) else None
            return P(*pre, bspec, None, None)
        if name in ("tm_x", "cm_x") and rank >= 2:  # rwkv shifts [..,B,d]
            pre = (None,) * (rank - 2)
            bspec = dp if _div(shape[-2], dpn) else None
            return P(*pre, bspec, None)
        if name == "enc_len":
            B = shape[-1]
            return P(dp if _div(B, dpn) else None)
        return P(*(None,) * rank)

    flat = flatten_with_path(cache_shapes)
    return unflatten_like(cache_shapes, [one(p, tuple(t.shape)) for p, t in flat])


def logits_sharding(cfg, mesh, batch: int) -> P:
    dp = dp_axes(mesh)
    bspec = dp if _div(batch, axis_size(mesh, dp)) else None
    vspec = "model" if _div(cfg.vocab_size, axis_size(mesh, "model")) else None
    return P(bspec, None, vspec)


# ---------------------------------------------------------------------------
# placing a param tree on a mesh
# ---------------------------------------------------------------------------

def spec_bytes(shape, itemsize: float, spec: P, mesh) -> float:
    """Bytes one position holds of a tensor of ``shape`` under ``spec``."""
    n = float(np.prod(shape)) * itemsize
    for ax in spec:
        if ax is not None:
            n /= axis_size(mesh, ax)
    return n


def _device_at(mesh, coords: Dict[str, int]) -> torch.device:
    idx = tuple(coords.get(a, 0) for a in mesh.axis_names)
    return mesh.devices[idx]


def _split(t: torch.Tensor, dim: int, n: int) -> List[torch.Tensor]:
    return list(torch.chunk(t, n, dim=dim))


def _place(t, device):
    return None if t is None else t.contiguous().to(device)


def _qtensor_pieces(w: QTensor, dim: int, n: int, device_of) -> Optional[list]:
    """``w`` cut into ``n`` pieces along matrix/expert dim ``dim``, or
    None where a piece would start inside a quantization group."""
    if dim == -2:
        d_in = w.shape[-2]
        if d_in % n or (d_in // n) % w.group:
            return None
        qs, ss = _split(w.q, -2, n), _split(w.scale, -2, n)
        ins = [None] * n if w.in_scale is None else _split(w.in_scale, -1, n)
        shape = (d_in // n, w.shape[-1])
    elif dim == -1:
        qs, ss = _split(w.q, -1, n), _split(w.scale, -1, n)
        ins = [w.in_scale] * n
        shape = (w.shape[-2], w.shape[-1] // n)
    else:                                # the expert axis of a stack
        qs, ss = _split(w.q, -3, n), _split(w.scale, -3, n)
        ins = [None] * n if w.in_scale is None else _split(w.in_scale, -2, n)
        shape = w.shape
    return [QTensor(_place(q, device_of(j)), _place(s, device_of(j)), w.bits, w.group,
                    shape, _place(i, device_of(j)))
            for j, (q, s, i) in enumerate(zip(qs, ss, ins))]


def _block_sparse_pieces(w: BlockSparseTensor, dim: int, n: int, device_of):
    """``w`` cut along d_out (idx split with it) or d_in (idx rebuilt per
    piece, which needs the same kept-block count in every column of every
    piece), or None where the blocks do not allow it."""
    bs = w.bs
    if dim == -1:
        if (w.shape[-1] // bs) % n:
            return None
        return [BlockSparseTensor(_place(a, device_of(j)), _place(m, device_of(j)), bs,
                                  _place(i, device_of(j)))
                for j, (a, m, i) in enumerate(zip(_split(w.w, -1, n), _split(w.mask, -1, n),
                                                  _split(w.idx, -2, n)))]
    if dim == -2:
        if (w.shape[-2] // bs) % n:
            return None
        pieces = []
        for j, (a, m) in enumerate(zip(_split(w.w, -2, n), _split(w.mask, -2, n))):
            try:
                idx = idx_from_mask(m)
            except ValueError:
                return None
            pieces.append(BlockSparseTensor(_place(a, device_of(j)), _place(m, device_of(j)),
                                            bs, _place(idx, device_of(j))))
        return pieces
    return None


def _shard_leaf(leaf, splits, mesh, coords):
    """``leaf`` split along ``splits`` ([(dim, axis)], outermost first) into
    nested ShardedTensors, pieces on their positions' devices; a split
    the container cannot take is dropped (that axis replicates)."""
    if not splits:
        if torch.is_tensor(leaf):
            return _place(leaf, _device_at(mesh, coords))
        return leaf.to(_device_at(mesh, coords))
    (dim, axis), rest = splits[0], splits[1:]
    n = axis_size(mesh, axis)

    def device_of(j):
        return _device_at(mesh, {**coords, axis: j})

    if isinstance(leaf, QTensor):
        pieces = _qtensor_pieces(leaf, dim, n, device_of)
    elif isinstance(leaf, BlockSparseTensor):
        pieces = _block_sparse_pieces(leaf, dim, n, device_of)
    elif isinstance(leaf, QEmbed):
        pieces = [QEmbed(_place(q, device_of(j)), _place(s, device_of(j)))
                  for j, (q, s) in enumerate(zip(_split(leaf.q, -2, n),
                                                  _split(leaf.scale, -1, n)))]
    else:
        pieces = _split(leaf, dim, n)
    if pieces is None:
        return _shard_leaf(leaf, rest, mesh, coords)
    return ShardedTensor([_shard_leaf(p, rest, mesh, {**coords, axis: j})
                          for j, p in enumerate(pieces)], dim, axis, mesh)


def _splits(spec: P) -> List[Tuple[int, str]]:
    """[(negative dim, axis)] of a spec's sharded dims, outermost first.  A
    dim sharded over several axes (the multi-pod mesh's ``("pod",
    "data")``) is split along each in turn, the first outermost: its
    pieces are major in the first axis, as a ``PartitionSpec`` tuple and
    a row-major device grid place them."""
    rank = len(spec)
    return [(i - rank, a) for i, ax in enumerate(spec) if ax is not None
            for a in ((ax,) if isinstance(ax, str) else ax)]


def place(tree, shardings):
    """``tree`` placed by ``shardings`` (a tree like :func:`param_shardings`
    gives; a ``None`` sharding leaves its leaf as it is): each sharded
    leaf a ``ShardedTensor`` (nested where a leaf is sharded over two
    axes, an expert stack's experts over "data" and its matrix over
    "model", or one dim over two, a slot state's slots over "pod" and
    then "data"), every other leaf on the mesh's first device.  A compressed
    leaf is split by its main tensor's spec (``QTensor.q``,
    ``BlockSparseTensor.w``, ``QEmbed.q``), and kept whole along an axis
    whose pieces it cannot take (a row-parallel ``QTensor`` cut inside a
    group; a block-sparse weight whose pieces keep uneven block counts)."""
    flat = flatten_with_path(tree)
    by_path = dict(flatten_with_path(shardings, is_leaf=_is_sharding))
    out = []
    for path, leaf in flat:
        sh = by_path.get(path)
        if sh is None:
            out.append(leaf)
            continue
        if isinstance(sh, ChildShardings):
            sh = sh[0]
        out.append(_shard_leaf(leaf, _splits(sh.spec), sh.mesh, {}))
    return unflatten_like(tree, out)


def spec_of(leaf) -> P:
    """The spec a placed leaf was cut by: each split of a (nested)
    ``ShardedTensor`` names its axis at its dim (a tuple of axes, outermost
    first, where several split one dim); a whole leaf's is all ``None``."""
    entries = [None] * len(leaf.shape)
    while isinstance(leaf, ShardedTensor):
        k = len(entries) + leaf.dim
        entries[k] = leaf.axis if entries[k] is None else (
            (entries[k],) if isinstance(entries[k], str) else entries[k]) + (leaf.axis,)
        leaf = leaf.pieces[0]
    return P(*entries)


def shardings_of(tree):
    """The shardings of a placed tree, read back from its leaves: a
    ``NamedSharding`` of :func:`spec_of` for each ``ShardedTensor`` leaf,
    ``None`` for a whole one (it stays where ``restore`` puts it, the
    mesh's first device).  ``checkpoint.restore(..., shardings=)`` places
    a checkpoint onto the layout of a tree already placed."""
    return tree_map(lambda t: NamedSharding(t.mesh, spec_of(t))
                    if isinstance(t, ShardedTensor) else None, tree)


def placed_zeros(shape, spec: P, mesh, dtype=torch.float32):
    """Zeros of ``shape`` placed by ``spec`` (as :func:`place` would cut
    them), each piece made on its own device: no whole copy is built."""
    def build(shape, splits, coords):
        if not splits:
            return torch.zeros(shape, dtype=dtype, device=_device_at(mesh, coords))
        (dim, axis), rest = splits[0], splits[1:]
        n = axis_size(mesh, axis)
        sub = list(shape)
        sub[dim] //= n
        return ShardedTensor([build(tuple(sub), rest, {**coords, axis: j}) for j in range(n)],
                             dim, axis, mesh)
    return build(tuple(shape), _splits(spec), {})


def gather(leaf, device=None) -> torch.Tensor:
    """A sharded leaf of tensor pieces gathered whole (``all_gather`` along
    each split, innermost first) on ``device`` (default the first
    piece's); a whole tensor as it is."""
    from repro_torch.distributed import collectives
    if not isinstance(leaf, ShardedTensor):
        return leaf if device is None else leaf.to(device)
    device = leaf.device if device is None else device
    return collectives.all_gather([gather(p, device) for p in leaf.pieces], dim=leaf.dim,
                                  device=device)


def split_like(t: torch.Tensor, like):
    """The whole tensor ``t`` cut as the placed leaf ``like`` is, each piece
    on the device of ``like``'s piece; ``t`` itself where ``like`` is
    whole."""
    if not isinstance(like, ShardedTensor):
        return t
    return ShardedTensor([split_like(c.contiguous().to(piece_device(p)), p)
                          for c, p in zip(torch.chunk(t, len(like.pieces), dim=like.dim),
                                          like.pieces)], like.dim, like.axis, like.mesh)


def shard_params(params, cfg, mesh):
    """``params`` placed on ``mesh`` by the rule table (:func:`place` of
    :func:`param_shardings`, without FSDP): the counterpart of the
    reference's ``param_shardings`` followed by ``jax.device_put``."""
    return place(params, param_shardings(cfg, params, mesh))


def replicated_qtensor_leaves(params, cfg, mesh) -> List[Dict[str, Any]]:
    """The ``QTensor`` leaves whose codes the rule table shards along d_in
    while their pieces would start inside a group: the port keeps them
    whole along that axis.  Each entry: the path, the axis, and the bytes
    per position the port holds beyond the reference's accounting (the
    codes and input scales it does not split)."""
    fn = param_spec_fn(cfg, mesh)
    out = []
    for path, leaf in flatten_with_path(params):
        if not isinstance(leaf, QTensor):
            continue
        spec = fn(path + (0,), tuple(leaf.q.shape))
        for dim, axis in _splits(spec):
            n = axis_size(mesh, axis)
            if dim == -2 and (leaf.shape[-2] % n or (leaf.shape[-2] // n) % leaf.group):
                # the reference splits the codes (its scales stay whole): a
                # position holds n times the reference's share of them
                extra = spec_bytes(leaf.q.shape, leaf.q.element_size(), spec, mesh) * (n - 1)
                out.append({"path": _path_str(path), "axis": axis,
                            "shape": tuple(leaf.q.shape), "group": leaf.group,
                            "extra_bytes_per_position": extra})
    return out


__all__ = ["ChildShardings", "NamedSharding", "P", "axis_size", "batch_shardings", "cache_shardings", "dp_axes",
           "gather", "logits_sharding", "opt_state_shardings", "param_shardings",
           "param_spec_fn", "place", "placed_zeros",
           "replicated_qtensor_leaves", "shard_params", "shardings_of", "spec_bytes",
           "spec_of", "split_like"]
