"""The reference's data-parallel train step on a mesh, for one controller.

The reference's train step on a mesh is an SPMD program: the batch's rows
are split over the mesh's dp axes (``sharding.batch_shardings``:
``("pod", "data")`` on a multi-pod mesh, ``("data",)`` otherwise), every
device runs the forward and backward of its rows, and XLA inserts the
collectives: the model axis's gathers and reductions and their
transposes, the per-use gathers of the weights FSDP (the reference's
ZeRO-3 rule) splits over "data", and the reduction of the gradients over
the dp axes.  :func:`split_value_and_grad` is that step on a placed
param tree (``sharding.place``): one *piece* per position of the dp
axes, each running ``loss`` on its rows.

- **The hand-off.**  Every weight the dp axes do not split is handed to
  each piece (invariant to varying; on a host where the positions are
  cards, a copy onto the piece's row of the mesh).  Its gradient is the
  hand-off's conjugate, :func:`collectives.all_reduce_sum` of the pieces'
  gradients in mesh order, run once a step after each piece has
  accumulated its microbatches (the reduction is linear, so reducing the
  accumulated sums is the sum of the reduced ones).
- **FSDP.**  A weight split over "data" along a matrix dim stays split;
  where a piece uses it, :func:`unshard` gathers it onto the piece
  (``collectives.all_gather``, counted per use, and again where the
  backward recomputes a checkpointed block).  Each piece's gradient of a
  shard is a slice of its gathered weight's; the gather's conjugate sums
  them over the pieces onto the shard's position,
  :func:`collectives.reduce_scatter`, run once a step with the other
  gradients.
- **Experts over "data".**  An expert stack split over "data" (expert
  parallelism) is not handed off: every piece sends its expert rows to
  the expert's position (``collectives.split``), whose gradient therefore
  sums the pieces' contributions where it lives, with no collective; on a
  multi-pod mesh the pods' sums are all-reduced over "pod".
- **The loss.**  Each piece's ``loss`` is its own rows' mean; the pieces'
  losses, each weighted by its share of the rows, are summed by
  :func:`collectives.all_reduce_sum` (a counted 4-byte all-reduce a
  microbatch), so the loss and the gradient are the global mean's.
- **Microbatches** split the global rows first and the dp axes second:
  microbatch ``i`` is rows ``[i B/M, (i+1) B/M)``, and piece ``j`` takes
  the ``j``-th of its ``n`` row blocks, as the reference's ``lax.scan``
  over ``[M, B/M, ...]`` with the batch split over the dp axes does.
  Where a microbatch's rows do not divide the ``n`` positions, it goes in
  ``n / gcd(n, M)`` blocks, as XLA places the reshape (:class:`Split`):
  the positions that held its rows split it, the others run a block again
  (a replica: the same values; every piece's loss weighted ``1 / n``, so
  the reduction over every position gives the mean).
- **Positions over "data".**  Where the rows do not divide the dp axes,
  ``batch_shardings`` puts the positions over "data"; a dense, MoE, vlm
  or encdec model's step then splits every row's text positions
  (``tokens`` and ``labels``) over the "data" positions (a "pod" position
  runs its block again).  The pieces run in lockstep: at each causal
  attention layer they exchange k and v (:func:`gather_positions`:
  ``collectives.all_gather_each`` within each "pod" position, whose
  gradient is the reduce-scatter of the K/V gradients), and each piece's
  positions, causal mask and window start at its first position; its
  loss is its labels' mean, weighted by its share.  A row's other inputs
  are not its text's positions: every piece holds them whole (as
  ``batch_shardings`` replicates them over "data") and runs what they
  feed whole.  A vlm's image goes ahead of each piece's block: the piece
  runs the image positions itself and keeps their K/V ahead of the
  gathered text K/V.  An encdec's piece runs the encoder over its rows'
  whole frames (``enc_inputs``), and its decoder's cross-attention reads
  all of them.  Each copy's gradient
  comes from its own piece's text only, so the reduction over the pieces
  sums the whole gradient.  The recomputation of a checkpointed block
  gathers the forward's pieces again (counted), its own recomputed k and
  v in place.
- **The MoE block** (:func:`moe_exchange`) computes what the reference's
  step computes over the global batch: the pieces run in lockstep (one
  thread each, one running at a time, :class:`_Lockstep`), and at every
  MoE layer they all-gather their gates and expert choices in the
  microbatch's token order (so each piece ranks its entries against
  every block's, for the capacity of the microbatch's token count; a
  replica's are left out) and all-reduce their router probabilities'
  sums (the Switch aux loss' mean); the expert fractions follow from the
  gathered choices.  The backward's recomputation of a checkpointed block
  reads the exchange's results back instead of exchanging again.

Left out of the count (they run on the controller, as scalar or
optimizer work): the gradient norm's sums (``optimizer.global_norm``)
and the optimizers' own reductions (Adafactor's statistics go through
``collectives.all_reduce_sum`` and are counted there, outside the step's
forward, backward and gradients).

:func:`checkpoint` is the models' remat: ``torch.utils.checkpoint``
without early stopping inside a mesh step (so the recomputation re-runs
each checkpointed block whole, and its collectives are counted the same
every time), with the piece's context restored around the recomputation.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import inspect
import math
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint as _ckpt

from repro_torch.core.compressed import ShardedTensor
from repro_torch.distributed import collectives
from repro_torch.tree import leaves, unflatten_like


@dataclass
class Piece:
    """One position of the dp axes in a split step: its flat index over
    the dp axes (pod-major), their count, its coordinates, the mesh, the
    lockstep group it exchanges through (None when the pieces run one
    after another), the log of its exchanges' results, and, inside a
    recomputation, the cursor into that log.  ``block`` of ``blocks`` is
    the part of each microbatch it runs (see :class:`Split`); ``span``,
    for a split of the positions, is (its first text position, each row's
    text positions in all)."""
    index: int
    n: int
    coords: Dict[str, int]
    mesh: Any
    group: Optional["_Lockstep"] = None
    log: List[Any] = field(default_factory=list)
    replay: Optional[List[int]] = None
    block: int = 0
    blocks: int = 1
    span: Optional[Tuple[int, int]] = None

    def device_at(self, coords: Dict[str, int]) -> torch.device:
        full = {**coords, **self.coords}
        return self.mesh.devices[tuple(full.get(a, 0) for a in self.mesh.axis_names)]

    @property
    def device(self) -> torch.device:
        return self.device_at({})

    def token_index(self, rows: int, seq: int) -> torch.Tensor:
        """Where this piece's ``rows`` x ``seq`` tokens (row-major) stand
        in the microbatch's tokens (row-major over every block)."""
        local = torch.arange(rows * seq, device=self.device)
        if self.span is None:
            return local + self.block * rows * seq
        first, total = self.span
        return (local // seq) * total + first + local % seq


_PIECE: contextvars.ContextVar = contextvars.ContextVar("dp_piece", default=None)
_MESH_STEP: contextvars.ContextVar = contextvars.ContextVar("mesh_step", default=False)


def active() -> Optional[Piece]:
    """The piece whose forward (or recomputation) is running, or None."""
    return _PIECE.get()


def home_device(w) -> torch.device:
    """Where a sharded weight's gathered or summed output goes: the
    running piece's device in a split step, the mesh's first otherwise."""
    piece = _PIECE.get()
    return piece.device if piece is not None else w.mesh.first_device


def _is_fsdp(w) -> bool:
    return isinstance(w, ShardedTensor) and w.axis == "data" and w.dim in (-1, -2)


def unshard(w):
    """``w`` with every split FSDP made over "data" gathered onto the
    running piece (an all-gather of the shards per model piece), inside a
    split step; ``w`` itself otherwise."""
    piece = _PIECE.get()
    if piece is None or not isinstance(w, ShardedTensor):
        return w
    return _unshard(w, piece, {})


def _unshard(w, piece: Piece, coords):
    if not isinstance(w, ShardedTensor):
        return w
    if _is_fsdp(w):
        first = w.pieces[0]
        if isinstance(first, ShardedTensor):     # "data" outermost: gather each inner piece
            inner = [ShardedTensor([p.pieces[m] for p in w.pieces], w.dim, w.axis, w.mesh)
                     for m in range(len(first.pieces))]
            return ShardedTensor([_unshard(s, piece, {**coords, first.axis: m})
                                  for m, s in enumerate(inner)], first.dim, first.axis,
                                 first.mesh)
        if not all(torch.is_tensor(p) for p in w.pieces):
            raise NotImplementedError("an FSDP split of a compressed leaf")
        return collectives.all_gather(w.pieces, dim=w.dim, device=piece.device_at(coords))
    return ShardedTensor([_unshard(p, piece, {**coords, w.axis: i})
                          for i, p in enumerate(w.pieces)], w.dim, w.axis, w.mesh)


# ---------------------------------------------------------------------------
# lockstep pieces and the MoE exchange
# ---------------------------------------------------------------------------

class _Aborted(Exception):
    """Another piece failed; this one stops at its next exchange."""


class _Lockstep:
    """The pieces' forwards on one thread each, one running at a time in
    turn: a piece runs until it reaches an exchange, deposits what it
    brings and hands the turn on; the last piece to arrive runs the
    exchange's collectives once, and every piece reads the result when its
    turn comes back.  So the pieces meet at each exchange as SPMD devices
    do, and the run is as deterministic as one thread's."""

    def __init__(self, n: int, pieces: Optional[Sequence[Piece]] = None):
        self.n = n
        self.pieces = pieces
        self.cv = threading.Condition()
        self.turn = 0
        self.finished = [False] * n
        self.error: Optional[BaseException] = None
        self.deposits: List[Any] = [None] * n
        self.result: Any = None
        self.rounds = [0] * n

    def _next(self, j: int) -> None:
        for step in range(1, self.n + 1):
            k = (j + step) % self.n
            if not self.finished[k]:
                self.turn = k
                break
        self.cv.notify_all()

    def _wait(self, j: int) -> None:
        while self.turn != j and self.error is None:
            self.cv.wait()
        if self.error is not None:
            raise _Aborted()

    def exchange(self, j: int, value, combine: Callable):
        with self.cv:
            self.deposits[j] = value
            self.rounds[j] += 1
            if j == self.n - 1:
                if len(set(self.rounds)) != 1 or any(self.finished):
                    raise RuntimeError(f"the pieces reached different exchanges: {self.rounds}")
                self.result = combine(self.deposits)
                self.deposits = [None] * self.n
            self._next(j)
            self._wait(j)
            return self.result

    def run(self, fns: Sequence[Callable]) -> list:
        out: List[Any] = [None] * self.n
        contexts = [contextvars.copy_context() for _ in fns]

        def body(j):
            try:
                with self.cv:
                    self._wait(j)
                out[j] = contexts[j].run(fns[j])
            except _Aborted:
                return
            except BaseException as e:       # stop the others, re-raised by run
                with self.cv:
                    if self.error is None:
                        self.error = e
                    self.cv.notify_all()
                return
            with self.cv:
                self.finished[j] = True
                if any(self.rounds[k] != self.rounds[j] for k in range(self.n)):
                    self.error = RuntimeError(f"the pieces reached different exchanges: "
                                              f"{self.rounds}")
                self._next(j)

        threads = [threading.Thread(target=body, args=(j,), name=f"dp_piece{j}", daemon=True)
                   for j in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self.error is not None:
            raise self.error
        return out


def _moe_combine(pieces: Sequence[Piece]):
    """The exchange of one MoE layer over ``pieces``: the gates and expert
    choices ([rows, seq, k] each) of one piece per block, gathered in the
    microbatch's token order (along the rows, or along the positions of a
    position split), and those pieces' router-probability sums over the
    microbatch's token count summed.  A replica's deposit (a piece whose
    block another piece runs too) is the same and is left out."""
    first = pieces[0]
    dim = 0 if first.span is None else 1

    def combine(deposits):
        ds = deposits[:first.blocks]
        dev = ds[0][0].device
        gates = collectives.all_gather([d[0] for d in ds], dim=dim, device=dev)
        experts = collectives.all_gather([d[1] for d in ds], dim=dim, device=dev)
        pmean = collectives.all_reduce_sum([d[2] for d in ds], device=dev)
        k = gates.shape[-1]
        return gates.reshape(-1, k), experts.reshape(-1, k), pmean
    return combine


def moe_exchange(gates: torch.Tensor, experts: torch.Tensor, psum: torch.Tensor):
    """(every block's gates [T, k], every block's expert choices [T, k], the
    microbatch's mean router probabilities [E]) for the running piece,
    which brings its own gates and choices [rows, seq, k] and its
    router-probability sum over the microbatch's token count ``psum``;
    inside a recomputation, the results the forward's exchange gave."""
    piece = _PIECE.get()
    if piece.replay is not None:
        out = piece.log[piece.replay[0]]
        piece.replay[0] += 1
        return out
    if piece.group is None:
        raise RuntimeError("an MoE exchange between pieces that do not run in lockstep")
    out = piece.group.exchange(piece.index, (gates.detach(), experts, psum),
                               _moe_combine(piece.group.pieces))
    out = tuple(t.to(piece.device) for t in out)
    piece.log.append(out)
    return out


def position_span() -> Optional[Tuple[int, int]]:
    """(first text position, text positions of a row in all) of the running
    piece of a position split; None elsewhere."""
    piece = _PIECE.get()
    return None if piece is None else piece.span


def _kv_combine(pieces: Sequence[Piece]):
    """The K/V exchange of one attention layer: within each replica group
    (the pieces of one "pod" position, ordered by their blocks) every
    piece's k and v gathered along the positions onto each piece of the
    group (``collectives.all_gather_each``); per piece, its copies and the
    group's pieces (detached, for a recomputation's gather)."""
    D = pieces[0].blocks

    def combine(deposits):
        out = {}
        for g in range(0, len(deposits), D):
            ks, vs = [d[0] for d in deposits[g:g + D]], [d[1] for d in deposits[g:g + D]]
            devices = [p.device for p in pieces[g:g + D]]
            kk = collectives.all_gather_each(ks, dim=1, devices=devices)
            vv = collectives.all_gather_each(vs, dim=1, devices=devices)
            own = [(k.detach(), v.detach()) for k, v in zip(ks, vs)]
            for i in range(D):
                out[g + i] = (kk[i], vv[i], i, own)
        return out
    return combine


def gather_positions(k: torch.Tensor, v: torch.Tensor):
    """Every position of the running piece's rows, k and v [rows, seq, K,
    hd] each, gathered from the pieces of its replica group, in their
    order: a split of the positions runs each piece's attention over the
    whole K/V.  The gathers differentiate to reduce-scatters of the K/V
    gradients.  Inside a recomputation the gathers run again (counted
    again), over the forward's pieces with the piece's own recomputed k
    and v in its place."""
    piece = _PIECE.get()
    if piece.replay is not None:
        own, group = piece.log[piece.replay[0]]
        piece.replay[0] += 1
        ks = [k if i == own else g[0] for i, g in enumerate(group)]
        vs = [v if i == own else g[1] for i, g in enumerate(group)]
        return (collectives.all_gather(ks, dim=1, device=piece.device),
                collectives.all_gather(vs, dim=1, device=piece.device))
    kk, vv, own, group = piece.group.exchange(piece.index, (k, v),
                                              _kv_combine(piece.group.pieces))[piece.index]
    piece.log.append((own, group))
    return kk, vv


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

_EARLY_STOP_KW = "early_stop" in inspect.signature(_ckpt.checkpoint).parameters


@contextlib.contextmanager
def _replaying(piece: Piece, cursor: int):
    token = _PIECE.set(dataclasses.replace(piece, group=None, replay=[cursor]))
    try:
        yield
    finally:
        _PIECE.reset(token)


def _contexts():
    piece = _PIECE.get()
    if piece is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    return contextlib.nullcontext(), _replaying(piece, len(piece.log))


def checkpoint(fn, *args):
    """``torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)``
    with the running piece's context restored around the recomputation
    (its device, its FSDP gathers, its exchanges read back), and, inside a
    mesh step, without early stopping: the recomputation re-runs the whole
    block, so its collectives are counted the same in every step."""
    if not _MESH_STEP.get():
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, context_fn=_contexts)
    if _EARLY_STOP_KW:
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, context_fn=_contexts,
                                early_stop=False)
    with _ckpt.set_checkpoint_early_stop(False):
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, context_fn=_contexts)


@contextlib.contextmanager
def mesh_step():
    """The extent of a train step of a placed tree (see :func:`checkpoint`)."""
    token = _MESH_STEP.set(True)
    try:
        yield
    finally:
        _MESH_STEP.reset(token)


# ---------------------------------------------------------------------------
# the split step
# ---------------------------------------------------------------------------

def _float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


@dataclass
class _Entry:
    """One float tensor of the param tree: how its gradient is reduced over
    the dp axes ("all", "fsdp" or "ep"), and for "fsdp" its reduce-scatter
    group (the leaf and its non-"data" coordinates) and shard index."""
    kind: str
    tensor: torch.Tensor
    group: tuple = ()
    shard: int = 0


def _view(node, coords, piece: Piece, kind: str, leaf_i: int, diffs: list, plan: Optional[list]):
    """``node`` as piece ``piece`` sees it: each float tensor a detached
    alias that requires grad (appended to ``diffs``), handed onto the
    piece's row of the mesh unless the dp axes split it."""
    if isinstance(node, ShardedTensor):
        sub = ("fsdp" if _is_fsdp(node) else "ep") if node.axis == "data" else kind
        return ShardedTensor([_view(p, {**coords, node.axis: i}, piece, sub, leaf_i, diffs, plan)
                              for i, p in enumerate(node.pieces)],
                             node.dim, node.axis, node.mesh)
    if not _float(node):
        return node
    if plan is not None:
        group = (leaf_i, tuple(sorted((a, i) for a, i in coords.items() if a != "data")))
        plan.append(_Entry(kind, node, group, coords.get("data", 0)))
    dest = node.device if kind != "all" else piece.device_at(coords)
    diffs.append(node.detach().to(dest).requires_grad_(True))
    return diffs[-1]


def _rebuild(node, it):
    if isinstance(node, ShardedTensor):
        return ShardedTensor([_rebuild(p, it) for p in node.pieces], node.dim, node.axis,
                             node.mesh)
    return next(it) if _float(node) else None


def dp_pieces(mesh) -> List[Dict[str, int]]:
    """The coordinates of each position of ``mesh``'s dp axes, pod-major."""
    from repro_torch.distributed.sharding import dp_axes
    axes = dp_axes(mesh)
    sizes = [mesh.shape[a] for a in axes]
    out = []
    for flat in range(math.prod(sizes)):
        c, rest = {}, flat
        for a, s in zip(reversed(axes), reversed(sizes)):
            c[a] = rest % s
            rest //= s
        out.append({a: c[a] for a in axes})
    return out


def _reduce(plan: List[_Entry], grads: List[list], pieces: List[Dict[str, int]]):
    """Each tensor's gradient reduced over the pieces (``grads[j][e]``,
    piece ``j``'s gradient of entry ``e``), in the entries' order; each
    piece's gradient is let go once its entry is reduced."""
    out: List[Optional[torch.Tensor]] = [None] * len(plan)
    groups: Dict[tuple, List[int]] = {}
    for e, ent in enumerate(plan):
        gs = [g[e] for g in grads]
        if ent.kind != "fsdp":
            for g in grads:
                g[e] = None
        dtype = gs[0].dtype
        if ent.kind == "all":
            out[e] = collectives.all_reduce_sum(gs, dtype=dtype, device=ent.tensor.device)
        elif ent.kind == "fsdp":
            groups.setdefault(ent.group, []).append(e)
        else:                                   # experts over "data": summed where they live
            pods = sorted({p.get("pod", 0) for p in pieces})
            parts = []
            for pod in pods:
                acc = None
                for j, p in enumerate(pieces):
                    if p.get("pod", 0) == pod:
                        x = gs[j].to(ent.tensor.device).float()
                        acc = x if acc is None else acc + x
                parts.append(acc)
            out[e] = (collectives.all_reduce_sum(parts, dtype=dtype, device=ent.tensor.device)
                      if len(parts) > 1 else parts[0].to(dtype))
        del gs
    for es in groups.values():
        es = sorted(es, key=lambda e: plan[e].shard)
        res = collectives.reduce_scatter([[grads[j][e] for e in es] for j in range(len(grads))],
                                         dtype=grads[0][es[0]].dtype,
                                         devices=[plan[e].tensor.device for e in es])
        for e, r in zip(es, res):
            out[e] = r
    return out


def mesh_of(params):
    """The mesh of a placed tree's first sharded leaf, or None (a tree none
    of whose leaves is split carries no mesh)."""
    return next((leaf.mesh for leaf in leaves(params) if isinstance(leaf, ShardedTensor)),
                None)


@dataclass(frozen=True)
class Split:
    """How a step's batch goes over the ``n`` positions of the dp axes.

    - ``"rows"`` (``batch_shardings`` splits the rows): each microbatch's
      rows in ``blocks`` equal blocks, position ``j`` running block
      ``j % blocks``: ``blocks == n`` where a microbatch's rows divide
      the dp positions.  Where they do not, the placement XLA gives the
      reference's ``[M, B/M, ...]`` reshape of a batch split over the dp
      axes (read from its compiled step at (4, 2) and (8, 1) host meshes):
      ``blocks = n / gcd(n, M)``, the positions that held a microbatch's
      rows split it, and the other positions run it again (replicas, ``n
      / blocks`` of each block).
    - ``"positions"`` (the rows do not divide the dp axes and
      ``batch_shardings`` puts the positions over "data"): each row's
      positions in ``blocks`` (the "data" axis' size) blocks, position
      ``j`` running the block of its "data" coordinate; its "pod"
      positions are replicas.
    - ``None``: the batch whole."""
    by: Optional[str] = None
    n: int = 1
    blocks: int = 1

    def block(self, j: int, coords: Dict[str, int]) -> int:
        return coords["data"] if self.by == "positions" else j % self.blocks


POSITION_SPLIT_FAMILIES = ("dense", "moe", "vlm", "encdec")
# the batch entries a split of the positions cuts; a row's other inputs
# (a vlm's ``img_embs``, an encdec's ``enc_inputs``) go whole to each piece
POSITION_KEYS = ("tokens", "labels")


def plan_split(mesh, rows: int, seq: int, microbatches: int = 1,
               family: str = "dense") -> Split:
    """The :class:`Split` of a ``rows`` x ``seq`` batch in ``microbatches``
    over ``mesh`` (None: no mesh).  A split of the positions runs for the
    families of :data:`POSITION_SPLIT_FAMILIES`; the others run such a
    batch whole.  Raises ``ValueError`` where the microbatches do not
    divide the rows, or their rows do not split into the blocks."""
    from repro_torch.distributed.sharding import batch_shardings
    if mesh is None:
        return Split()
    M = microbatches
    if rows % M:
        raise ValueError(f"batch {rows} does not divide into {M} microbatches")
    n = len(dp_pieces(mesh))
    spec = batch_shardings(None, {"tokens": torch.empty((rows, seq), device="meta")},
                           mesh)["tokens"]
    if spec[0] is not None:
        blocks = n if (rows // M) % n == 0 else n // math.gcd(n, M)
        if (rows // M) % blocks:
            raise ValueError(f"{M} microbatches of {rows // M} rows do not split into "
                             f"{blocks} blocks over {n} dp positions")
        return Split("rows", n, blocks)
    if spec[1] == "data" and family in POSITION_SPLIT_FAMILIES:
        return Split("positions", n, mesh.shape["data"])
    return Split()


def _parts(batch: Dict[str, torch.Tensor], split: Split, pieces, M: int) -> List[List[dict]]:
    """``[i][j]``: microbatch ``i``'s part of piece ``j`` (its rows, or
    every row's block of positions)."""
    B, S = batch["tokens"].shape
    rows = B // M
    S //= split.blocks
    out = []
    for i in range(M):
        mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        row = []
        for j, c in enumerate(pieces):
            blk = split.block(j, c)
            if split.by == "positions":
                row.append({k: v[:, blk * S:(blk + 1) * S] if k in POSITION_KEYS else v
                            for k, v in mb.items()})
            else:
                b = rows // split.blocks
                row.append({k: v[blk * b:(blk + 1) * b] for k, v in mb.items()})
        out.append(row)
    return out


def split_value_and_grad(loss: Callable, params, batch: Dict[str, torch.Tensor], mesh,
                         split: Split, *, microbatches: int = 1, lockstep: bool = False):
    """(the global mean loss, its gradient as a tree like ``params``) of a
    placed tree over ``batch``, split over ``mesh``'s dp axes as ``split``
    (:func:`plan_split`) says; see the module docstring.  ``loss(params,
    part)`` is a piece's mean loss over its part.  ``lockstep`` runs the
    pieces in lockstep (a model whose forward exchanges between them: the
    MoE block; a split of the positions always does, for its K/V).  With
    one microbatch each gradient has its param's dtype; with several, f32,
    accumulated per piece and divided by their count."""
    pieces = dp_pieces(mesh)
    n = len(pieces)
    M = microbatches
    lockstep = lockstep or split.by == "positions"
    parts_all = _parts(batch, split, pieces, M)
    S = batch["tokens"].shape[1]
    flat = leaves(params)
    plan: List[_Entry] = []
    views, diffs = [], []
    for j, coords in enumerate(pieces):
        piece = Piece(j, n, coords, mesh)
        d: list = []
        views.append(unflatten_like(params, [_view(leaf, {}, piece, "all", i, d,
                                                   plan if j == 0 else None)
                                             for i, leaf in enumerate(flat)]))
        diffs.append(d)
    acc: Optional[List[list]] = None
    total = None
    with mesh_step(), torch.enable_grad():
        for i in range(M):
            states = [Piece(j, n, c, mesh, None, block=split.block(j, c), blocks=split.blocks,
                            span=((split.block(j, c) * (S // split.blocks), S)
                                  if split.by == "positions" else None))
                      for j, c in enumerate(pieces)]
            group = _Lockstep(n, states) if lockstep else None
            for st in states:
                st.group = group
            parts = [{k: v.to(s.device) for k, v in parts_all[i][j].items()}
                     for j, s in enumerate(states)]

            def run_piece(j):           # its part's mean, weighted by its share (1 / n)
                token = _PIECE.set(states[j])
                try:
                    return loss(views[j], parts[j]).float() * (1.0 / n)
                finally:
                    _PIECE.reset(token)

            if group is not None:
                outs = group.run([lambda j=j: run_piece(j) for j in range(n)])
            else:
                outs = [run_piece(j) for j in range(n)]
            lv = collectives.all_reduce_sum(outs, dtype=torch.float32, device=mesh.first_device)
            got = torch.autograd.grad(lv, [t for d in diffs for t in d], allow_unused=True)
            k = len(plan)
            got = [[torch.zeros_like(t) if g is None else g
                    for g, t in zip(got[j * k:(j + 1) * k], diffs[j])] for j in range(n)]
            lv = lv.detach()
            if M == 1:
                acc, total = got, lv
            elif acc is None:
                acc, total = [[g.float() for g in gj] for gj in got], lv
            else:
                for a, gj in zip(acc, got):
                    for x, g in zip(a, gj):
                        x.add_(g)
                total = total + lv
            del got, outs, states, group
        reduced = _reduce(plan, acc, pieces)
        del acc
    if M > 1:
        total = total / M
        reduced = [g.div_(M) for g in reduced]
    it = iter(reduced)
    return total, unflatten_like(params, [_rebuild(leaf, it) for leaf in flat])


__all__ = ["POSITION_SPLIT_FAMILIES", "Piece", "Split", "active", "checkpoint", "dp_pieces",
           "gather_positions", "home_device", "mesh_of", "mesh_step", "moe_exchange", "plan_split",
           "position_span", "split_value_and_grad", "unshard"]
