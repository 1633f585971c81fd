"""Compressed-parameter containers and the universal matmul dispatch.

The instance-optimization pipeline rewrites selected weight matrices of
a model's param tree into :class:`QTensor` (group-wise quantized,
optionally with SmoothQuant input scales).  Every linear layer in
``repro_torch.models`` calls :func:`matmul`, which dispatches on the
container type, so compression is transparent to the model code.

The plain formulas here are the portable path and the oracle; the int8
and block-sparse CUDA kernels (``kernels/ops.py``) take over when the
scoped :func:`kernel_backend` resolves to ``"cuda"`` for the input's
device.

MoE expert stacks ``[E, d_in, d_out]`` (raw, or a ``QTensor`` whose
tensors carry the expert axis) go through :func:`expert_matmul`: one
int8 kernel launch covers every expert of a linear on the card.

Calibration: ``set_record_hook`` installs an observer that the matmul
dispatch (and the MoE block, through :func:`record`) feeds with
(weight, activation) pairs of raw weights, and ``set_route_hook`` one
that the MoE block feeds with routing statistics;
``repro_torch.core.calibrate`` uses them to gather Hessians, channel
norms and expert routing counts without any model-code changes.  A hook
observes the thread (context) that installed it: another thread's model
calls run unobserved.

:class:`ShardedTensor` is a weight placed on a mesh: one piece per
position along one axis, each piece a tensor or one of the containers
above (or, for a leaf sharded over two axes, a ``ShardedTensor`` itself).
:func:`matmul` and :func:`expert_matmul` run every piece through the same
dispatch, so each piece launches its kernel at its own shape, and combine
the pieces' outputs with ``distributed/collectives.py``.

:class:`QEmbed` is an int8 embedding table with per-row scales
(``Recipe.quant_embed``): ``models/layers.py`` gathers rows from it and,
when the embedding is tied, takes the logits from its codes.
:func:`tied_logits` is that product on a plain table: f32 logits from
bf16 operands with f32 accumulation, never rounded through bf16.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.backend import normalize_backend, resolve_backend

_BACKEND: contextvars.ContextVar = contextvars.ContextVar(
    "kernel_backend", default=None)


@contextlib.contextmanager
def kernel_backend(backend):
    """Scope a KernelBackend over a block of compute (engines wrap every
    tick in this, so the dispatch below picks the engine's backend and
    no global state survives the ``with`` block)."""
    token = _BACKEND.set(normalize_backend(backend))
    try:
        yield
    finally:
        _BACKEND.reset(token)


def current_backend(device="cuda") -> str:
    """The backend in effect for tensors on ``device``: ``"reference"``
    or ``"cuda"``."""
    b = _BACKEND.get()
    return resolve_backend(b if b is not None else "auto", device)


_RECORD_HOOK: contextvars.ContextVar = contextvars.ContextVar("record_hook", default=None)
_ROUTE_HOOK: contextvars.ContextVar = contextvars.ContextVar("route_hook", default=None)


def set_record_hook(fn: Optional[Callable]) -> None:
    """fn(w, x, valid) observes the matmuls of raw weights; x is
    [..., d_in] and ``valid`` None, or, for a stacked expert weight, x is
    [E, C, d_in] and ``valid`` [E] the filled rows of each expert."""
    _RECORD_HOOK.set(fn)


def set_route_hook(fn: Optional[Callable]) -> None:
    """fn(router_w, counts, probs_mean) observes MoE routing statistics."""
    _ROUTE_HOOK.set(fn)


def record(w, x, valid=None) -> None:
    """Explicit calibration record (the MoE block's expert inputs)."""
    hook = _RECORD_HOOK.get()
    if hook is not None:
        hook(w, x, valid)


def record_routing(router_w, counts, probs_mean) -> None:
    hook = _ROUTE_HOOK.get()
    if hook is not None:
        hook(router_w, counts, probs_mean)


class QTensor:
    """Group-wise quantized weight matrix ``[d_in, d_out]``.

    q         int8 codes ``[d_in, d_out]`` (int4: packed two-per-byte along
              d_in -> ``[d_in // 2, d_out]`` uint8)
    scale     f32 per-(group, out-channel) scales ``[d_in // group, d_out]``
    in_scale  optional f32 ``[d_in]`` SmoothQuant per-channel input scale
              (x is multiplied by it before the quantized matmul; the
              inverse was folded into the stored codes at quantization)
    bits      4 or 8

    Tensors may carry leading axes: a layer axis when stacked, and an
    expert axis for MoE expert stacks (``q`` [R, E, d_in, d_out]);
    ``shape`` stays the matrix's [d_in, d_out].  :meth:`layer` slices the
    first leading axis (a layer, or an expert of one layer's stack).
    """

    def __init__(self, q, scale, bits: int, group: int, shape, in_scale=None):
        self.q = q
        self.scale = scale
        self.in_scale = in_scale
        self.bits = int(bits)
        self.group = int(group)
        self.shape = tuple(shape)

    @property
    def dtype(self):
        return torch.bfloat16

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nbytes(self) -> int:
        """Stored bytes, computed from the actual tensors (stacked-safe)."""
        b = self.q.numel() * self.q.element_size()
        b += self.scale.numel() * self.scale.element_size()
        if self.in_scale is not None:
            b += self.in_scale.numel() * self.in_scale.element_size()
        return int(b)

    def layer(self, r: int) -> "QTensor":
        """Entry ``r`` of the first leading axis: a layer of a stacked
        QTensor, or an expert of one layer's expert stack."""
        return QTensor(self.q[r], self.scale[r], self.bits, self.group,
                       self.shape[-2:],
                       None if self.in_scale is None else self.in_scale[r])

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device), self.bits,
                       self.group, self.shape,
                       None if self.in_scale is None else self.in_scale.to(device))

    def unpack(self) -> torch.Tensor:
        """int8 logical codes [..., d_in, d_out] (unpacks int4)."""
        if self.bits == 8:
            return self.q
        u = self.q
        lo = (u & 0xF).to(torch.int8)
        hi = (u >> 4).to(torch.int8)
        lo = torch.where(lo >= 8, lo - 16, lo)
        hi = torch.where(hi >= 8, hi - 16, hi)
        return torch.stack([lo, hi], dim=-2).reshape(*u.shape[:-2], self.shape[-2],
                                                     self.shape[-1])

    def dequantize(self) -> torch.Tensor:
        """Dense bf16 reconstruction of the weight (folds in_scale back)."""
        g = self.group
        d_in, d_out = self.shape[-2], self.shape[-1]
        w = self.unpack().float().reshape(d_in // g, g, d_out) * self.scale[:, None, :]
        w = w.reshape(d_in, d_out)
        if self.in_scale is not None:
            w = w * self.in_scale[:, None]
        return w.to(torch.bfloat16)


class _TiedLogits(torch.autograd.Function):
    """``x @ table.T`` with an f32 output from bf16 operands on the card.
    ``torch.mm(..., out_dtype=torch.float32)`` has no derivative, so the
    backward products run in the operands' dtype (f32 accumulation), as
    those of a bf16 product whose output is upcast do."""

    @staticmethod
    def forward(ctx, x, table):
        ctx.save_for_backward(x, table)
        return torch.mm(x, table.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = torch.mm(g, table) if ctx.needs_input_grad[0] else None
        gt = torch.mm(g.t(), x) if ctx.needs_input_grad[1] else None
        return gx, gt


def tied_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """f32 logits ``x [..., d] @ table [V, d].T`` with f32 accumulation,
    as the reference's ``preferred_element_type=float32`` product.  bf16
    operands on the card take ``torch.mm``'s f32 output (the table is
    never upcast); elsewhere the product of the operands upcast to f32."""
    if x.is_cuda and x.dtype == table.dtype == torch.bfloat16:
        y = _TiedLogits.apply(x.reshape(-1, x.shape[-1]), table)
        return y.reshape(*x.shape[:-1], table.shape[0])
    return torch.matmul(x.float(), table.float().t())


class QEmbed:
    """Int8 embedding table with per-row (per-vocab-entry) scales.

    q      int8 codes ``[V, d]``
    scale  f32 ``[V]``: row ``v`` is ``q[v] * scale[v]``

    It serves the two operations an embedding needs: the row gather
    (:meth:`lookup`, bf16 whatever the model's dtype, as in the
    reference) and the tied unembedding's logits ``x @ W.T = (x @ q.T) *
    s`` (:meth:`logits`): the per-row scale factors out of the reduction,
    so the product runs on the codes, converted to bf16 (exact: |q| <=
    127) on every call, as the reference's does.
    """

    def __init__(self, q, scale):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.dim()

    @property
    def dtype(self):
        return torch.bfloat16

    @property
    def device(self):
        return self.q.device

    @property
    def nbytes(self) -> int:
        return int(self.q.numel() + self.scale.numel() * 4)

    def to(self, device) -> "QEmbed":
        return QEmbed(self.q.to(device), self.scale.to(device))

    def lookup(self, tokens) -> torch.Tensor:
        return (self.q[tokens].float() * self.scale[tokens][..., None]).to(torch.bfloat16)

    def logits(self, x) -> torch.Tensor:
        return tied_logits(x.to(torch.bfloat16), self.q.to(torch.bfloat16)) * self.scale


def quantize_embed(table, bits: int = 8) -> QEmbed:
    """Per-row absmax int8 quantization of an embedding table [V, d]:
    ``s = max|w| / 127 + 1e-12``, codes ``rint(w / s)`` clipped to +-127."""
    if bits != 8:
        raise ValueError("embedding tables are int8 only")
    w = table.float()
    s = w.abs().amax(1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(w / s[:, None]), -127, 127).to(torch.int8)
    return QEmbed(q, s)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7], even first dim -> packed uint8 pairs."""
    lo = (codes[0::2].to(torch.int16) & 0xF).to(torch.uint8)
    hi = (codes[1::2].to(torch.int16) & 0xF).to(torch.uint8)
    return lo | (hi << 4)


class BlockSparseTensor:
    """Block-sparse weight ``[d_in, d_out]`` with ``bs x bs`` zero blocks.

    w     the dense zero-filled bf16 weight (the plain path's operand)
    mask  f32 0/1 block bitmap ``[d_in/bs, d_out/bs]``
    idx   int32 ``[d_out/bs, keep]``: the kept input-block rows of each
          output block column, ascending (uniform ``keep``, the kernel's
          gather length)

    Tensors carry a leading layer axis when stacked, and so does ``idx``:
    every layer keeps its own indices (:meth:`layer`).
    """

    def __init__(self, w, mask, bs: int, idx=None):
        self.w = w
        self.mask = mask
        self.bs = int(bs)
        self.idx = idx_from_mask(mask) if idx is None else idx

    @property
    def shape(self):
        return tuple(self.w.shape)

    @property
    def ndim(self) -> int:
        return self.w.dim()

    @property
    def dtype(self):
        return self.w.dtype

    @property
    def nbytes(self) -> int:
        """Kept blocks plus a one-bit-per-block bitmap (stacked-safe)."""
        nnz = float(self.mask.sum().item())
        return int(nnz * self.bs * self.bs * self.w.element_size()
                   + self.mask.numel() / 8 + 1)

    def density(self) -> float:
        return float(self.mask.mean().item())

    def layer(self, r: int) -> "BlockSparseTensor":
        """The ``r``-th matrix of a layer-stacked BlockSparseTensor."""
        return BlockSparseTensor(self.w[r], self.mask[r], self.bs, self.idx[r])

    def to(self, device) -> "BlockSparseTensor":
        return BlockSparseTensor(self.w.to(device), self.mask.to(device), self.bs,
                                 self.idx.to(device))


def idx_from_mask(mask: torch.Tensor) -> torch.Tensor:
    """Kept input-block rows per output block column, ascending:
    ``mask`` [..., nb_in, nb_out] -> int32 [..., nb_out, keep]."""
    m = mask.transpose(-1, -2) > 0
    counts = m.sum(-1)
    keep = int(counts.reshape(-1)[0].item())
    if not bool((counts == keep).all()):
        raise ValueError("block mask keeps a different number of blocks per column")
    rows = torch.nonzero(m)[:, -1]
    return rows.reshape(*m.shape[:-1], keep).to(torch.int32)


def check_idx(idx: torch.Tensor, shape, bs: int) -> torch.Tensor:
    """``idx`` itself, once checked against a weight of ``shape``
    [..., d_in, d_out]: integer [..., d_out/bs, keep] with 1 <= keep <=
    d_in/bs and entries in [0, d_in/bs).  The kernel reads out of bounds
    on any other, so gather indices from outside are checked here once."""
    nb_in, nb_out = shape[-2] // bs, shape[-1] // bs
    if (idx.is_floating_point() or tuple(idx.shape[:-1]) != (*shape[:-2], nb_out)
            or not 1 <= idx.shape[-1] <= nb_in):
        raise ValueError(f"idx {tuple(idx.shape)} does not fit a {tuple(shape)} "
                         f"weight of {bs} x {bs} blocks")
    if bool((idx < 0).any()) or bool((idx >= nb_in).any()):
        raise ValueError(f"idx entries must lie in [0, {nb_in})")
    return idx


class ShardedTensor:
    """A weight or a slot-state leaf placed on a mesh: ``pieces[j]`` is
    position ``j``'s piece along mesh axis ``axis``, cut along ``dim``.  A
    weight is cut along ``-1`` (column: d_out, or the vocabulary of an
    unembedding), ``-2`` (row: d_in, or the vocabulary of an embedding
    table) or ``-3`` (the expert axis of an expert stack); a mesh engine's
    attention k/v leaf [..., B, T, K, hd] along ``-4`` (its slots, over
    "data"), ``-2`` (its KV heads) or ``-1`` (its head_dim, both over
    "model"), a recurrent leaf along its slots and rwkv ``S``/mamba ``h``
    along ``-3`` (their heads, over "model").  Each piece lives on its
    position's device and is a tensor, a ``QTensor``, a
    ``BlockSparseTensor``, a ``QEmbed`` or, for a leaf sharded over a
    second axis (FSDP's "data" split of a weight, a slot state's slots),
    a ``ShardedTensor``.

    :meth:`layer` slices every piece, as ``QTensor.layer`` does, and
    :meth:`map` maps a function over the pieces of matching leaves (a
    gradient, an optimizer's state).  Nothing else reads a sharded leaf:
    :func:`matmul`, :func:`expert_matmul` and ``models/layers.py``'s
    ``embed``/``unembed`` take a weight piece by piece (differentiably:
    ``tree.value_and_grad`` trains a placed tree), the optimizers update
    it piece by piece, and ``models/sharded_cache.py`` reads a slot state
    (its ``decode_attention``, the recurrent decodes' helpers and its
    ``write_rows`` at admission).  Any other use fails (it is not a
    tensor), so a model path that reads a leaf directly shows up instead
    of gathering it silently."""

    def __init__(self, pieces, dim: int, axis: str, mesh):
        if dim not in (-1, -2, -3, -4):
            raise ValueError(f"a leaf is sharded along dim -1, -2, -3 or -4, not {dim}")
        self.pieces = list(pieces)
        self.dim = int(dim)
        self.axis = axis
        self.mesh = mesh

    @property
    def shape(self):
        """The unsharded leaf's ``shape`` (a ``QTensor``'s is its matrix's)."""
        shape = list(self.pieces[0].shape)
        if -self.dim <= len(shape):
            shape[self.dim] = sum(p.shape[self.dim] for p in self.pieces)
        return tuple(shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self):
        return self.pieces[0].dtype

    @property
    def device(self) -> torch.device:
        return piece_device(self.pieces[0])

    @property
    def nbytes(self) -> int:
        return sum(param_bytes(p) for p in self.pieces)

    def layer(self, r: int) -> "ShardedTensor":
        return ShardedTensor([p.layer(r) if hasattr(p, "layer") else p[r]
                              for p in self.pieces], self.dim, self.axis, self.mesh)

    def map(self, fn, *others) -> "ShardedTensor":
        """``fn(piece, *matching pieces)`` over the innermost pieces of this
        leaf and of ``others`` (``ShardedTensor``s cut the same way), as a
        ``ShardedTensor`` of the same layout: an optimizer's elementwise
        update, a gradient's cast."""
        return ShardedTensor([p.map(fn, *qs) if isinstance(p, ShardedTensor) else fn(p, *qs)
                              for p, *qs in zip(self.pieces, *(o.pieces for o in others))],
                             self.dim, self.axis, self.mesh)

    def tensors(self) -> list:
        """The innermost pieces, in mesh order."""
        return [t for p in self.pieces
                for t in (p.tensors() if isinstance(p, ShardedTensor) else [p])]

    def piece_at(self, i: int):
        """The piece flat mesh position ``i`` holds (recursively)."""
        p = self.pieces[self.mesh.coords(i)[self.axis]]
        return p.piece_at(i) if isinstance(p, ShardedTensor) else p

    def __repr__(self) -> str:
        return (f"ShardedTensor(dim {self.dim} over {self.axis!r}, {len(self.pieces)} pieces, "
                f"shape={self.shape})")


def piece_device(p) -> torch.device:
    """The device a piece's tensors live on."""
    if isinstance(p, ShardedTensor):
        return p.device
    if isinstance(p, (QTensor, QEmbed)):
        return p.q.device
    if isinstance(p, BlockSparseTensor):
        return p.w.device
    return p.device


def param_bytes(tree) -> int:
    """Total stored bytes of a (possibly compressed or sharded) param tree;
    a sharded leaf counts each of its pieces once."""
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_bytes(v) for v in tree)
    if isinstance(tree, (QTensor, BlockSparseTensor, QEmbed, ShardedTensor)):
        return tree.nbytes
    return 0 if tree is None else int(tree.numel() * tree.element_size())


def position_bytes(tree, i: int) -> int:
    """Bytes mesh position ``i`` holds of a sharded param tree: its piece
    of each sharded leaf and the whole of every replicated one (a slot
    state: ``sharded_cache.state_position_bytes``)."""
    if isinstance(tree, dict):
        return sum(position_bytes(v, i) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(position_bytes(v, i) for v in tree)
    if isinstance(tree, ShardedTensor):
        return param_bytes(tree.piece_at(i))
    return param_bytes(tree)


def _q_matmul_plain(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """``(x * in_scale) @ bf16(codes * scale)``: the kernel's semantics.
    (The reference's jnp path folds ``in_scale`` into the weight *and*
    scales x by it; the port applies it once.)"""
    return kref.quant_matmul(x, w.unpack(), w.scale, group=w.group,
                             in_scale=w.in_scale)


def _sharded_matmul(x: torch.Tensor, w: ShardedTensor, fn) -> torch.Tensor:
    """``fn(x, w)`` over the pieces of ``w``, the result on the mesh's
    first device (a split step's piece's: ``data_parallel.home_device``):
    a column-sharded weight's ``x`` handed to each piece
    (``collectives.replicate``) and the outputs gathered along the last
    dim; a row-sharded one's ``x`` split along its last dim
    (``collectives.split``) and the partial products summed in f32 in mesh
    order (one cast); an expert stack's rows of ``x`` [E, C, d] split by
    expert and gathered back.  Inside a split train step a split FSDP made
    over "data" is gathered where it is used (``data_parallel.unshard``);
    elsewhere it is a row or column split like the others."""
    from repro_torch.distributed import collectives, data_parallel
    w = data_parallel.unshard(w)
    if not isinstance(w, ShardedTensor):
        return fn(x, w)
    home = data_parallel.home_device(w)
    devices = [piece_device(p) for p in w.pieces]
    if w.dim == -1:
        outs = [fn(xj, p) for xj, p in zip(collectives.replicate(x, devices), w.pieces)]
        return collectives.all_gather(outs, dim=-1, device=home)
    sizes = [p.shape[-2] if w.dim == -2 else _experts(p) for p in w.pieces]
    xs = collectives.split(x, sizes, -1 if w.dim == -2 else -3, devices)
    outs = [fn(xj, p) for xj, p in zip(xs, w.pieces)]
    if w.dim == -2:
        return collectives.all_reduce_sum(outs, device=home)
    return collectives.all_gather(outs, dim=-3, device=home)


def _experts(p) -> int:
    """Experts in one piece of an expert stack."""
    if isinstance(p, ShardedTensor):
        return _experts(p.pieces[0])
    return (p.q if isinstance(p, QTensor) else p).shape[-3]


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """Universal ``x @ w`` over raw / quantized / block-sparse / sharded
    weights."""
    if isinstance(w, ShardedTensor):
        return _sharded_matmul(x, w, matmul)
    if isinstance(w, QTensor):
        if w.bits == 8 and current_backend(x.device) == "cuda":
            return kops.quant_matmul(x, w.q, w.scale, group=w.group,
                                     in_scale=w.in_scale)
        return _q_matmul_plain(x, w)
    if isinstance(w, BlockSparseTensor):
        if current_backend(x.device) == "cuda":
            return kops.block_sparse_matmul(x, w.w, w.idx, bs=w.bs)
        return torch.matmul(x, w.w.to(x.dtype))
    hook = _RECORD_HOOK.get()
    if hook is not None:
        hook(w, x, None)
    return torch.matmul(x, w.to(x.dtype))


def expert_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """Batched per-expert matmul ``[E, C, d_in] @ [E, d_in, d_out]`` over a
    raw or quantized expert stack (the MoE block calls this).  An int8
    stack on the ``"cuda"`` backend runs K2 over experts, one launch for
    every expert; int4 stacks and the other backends take the plain
    version, which applies ``in_scale`` once, as the kernel does.  A
    sharded stack runs every piece so (K2 over experts at each piece's
    shape)."""
    if isinstance(w, ShardedTensor):
        return _sharded_matmul(x, w, expert_matmul)
    if isinstance(w, QTensor):
        if w.bits == 8 and current_backend(x.device) == "cuda":
            return kops.quant_matmul_experts(x, w.q, w.scale, group=w.group,
                                             in_scale=w.in_scale)
        return _q_matmul_plain(x, w)
    return torch.matmul(x, w.to(x.dtype))


def is_weight_leaf(x) -> bool:
    """Whether ``x`` is a weight leaf of a param tree: a compressed
    container or anything with a shape."""
    return isinstance(x, (QTensor, BlockSparseTensor)) or hasattr(x, "shape")
