"""Roofline terms of the port's steps on one NVIDIA H100.

The counterpart of the reference's ``src/repro/launch/hlo_analysis.py``.
The reference reads FLOPs and bytes from XLA's ``cost_analysis`` of a
compiled step; the port runs eager PyTorch and ``ctypes`` kernel
launches, so there is no HLO to parse.  It keeps the reference's
:class:`Roofline` terms and :func:`model_flops`, and adds an analytic
model of one decode step (:func:`decode_step_cost`), which is what
``cost_analysis`` gave the reference's auditor:

    compute term    = FLOPs / BF16_FLOPS        (989e12, dense bf16)
    memory term     = bytes / HBM_BYTES_PER_S   (3.35e12 B/s)
    collective term = collective bytes / link rate

Hardware constants: H100 SXM5 80GB, from NVIDIA's data sheet (dense, no
2:4 sparsity).  The link rate is NVLink 4's: 900 GB/s bidirectional per
GPU, so 450e9 B/s a direction.

On a mesh (``decode_step_cost`` of a ``shard_params`` tree) the
collective bytes are the result bytes of every gather and reduce the
sharded step runs, by the reference's convention
(``launch/hlo_analysis.py``: result-shape bytes per collective kind;
:func:`collective_bytes`), and ``chips`` is the mesh's size.  A
one-card mesh runs them as copies on the card; the term says what
NVLink would take for them between cards.

A decode step of ``slots`` rows reads every weight once, with three
exceptions that follow what the step runs: an untied input embedding
table is read only at the ``slots`` looked-up rows (a tied one is read
whole by the unembedding), an encoder-decoder's encoder (its blocks,
``ln_enc`` and ``pos_enc``) does not run, and its decoder position
table is read at ``slots`` rows.  Compressed weights count as stored
(``QTensor`` codes, scales and input scales; a ``BlockSparseTensor``'s
kept tiles and bitmap; ``QEmbed`` codes and row scales): the bytes that
``core.compressed.param_bytes`` counts.  An MoE's every expert is read,
since K2 over experts runs every expert's tile.  The slot state is
touched as the step touches it: a self-attention K/V leaf at the
positions each slot attends (a local layer within its window), the
cross-attention K/V read whole, a recurrent state (SSD, conv, WKV and
token-shift carries) read and written whole.  FLOPs are 2·N_active per
row, as :func:`model_flops` counts a decode step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Sequence, Union

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.core.compressed import (BlockSparseTensor, QEmbed, QTensor, ShardedTensor,
                                         param_bytes)
from repro_torch.tree import flatten_with_path, leaves

# --- H100 SXM5 constants (per card), NVIDIA data sheet ---
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak, FLOP/s
HBM_BYTES_PER_S = 3.35e12        # HBM3, bytes/s
LINK_BYTES_PER_S = 450e9         # NVLink 4: 900 GB/s bidirectional, per direction


def bound(nbytes: float, flops: float):
    """(least ms the card takes to move ``nbytes`` and do ``flops``, the
    term that sets it: ``"bytes"`` or ``"operations"``)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


@dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    coll_bytes: float
    chips: int
    coll_detail: Dict[str, float] = field(default_factory=dict)
    detail: Dict[str, float] = field(default_factory=dict)
    peak_flops: float = BF16_FLOPS
    hbm_bw: float = HBM_BYTES_PER_S
    link_bw: float = LINK_BYTES_PER_S

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.link_bw if self.coll_bytes else 0.0

    @property
    def bound(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops, "bytes": self.bytes_accessed,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bound": self.bound,
            "coll_detail": self.coll_detail, **self.detail,
        }


@dataclass(frozen=True)
class ShapeSpec:
    """The reference's ``configs.base.ShapeSpec``: one cell's shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


def model_flops(cfg, shape_spec) -> float:
    """MODEL_FLOPS = 6 N D (dense train) / 2 N D (inference fwd), with
    N = active params; D = processed tokens."""
    n = cfg.active_param_count()
    if shape_spec.kind == "train":
        per_tok = 6 * n
        toks = shape_spec.global_batch * shape_spec.seq_len
    elif shape_spec.kind == "prefill":
        per_tok = 2 * n
        toks = shape_spec.global_batch * shape_spec.seq_len
    else:  # decode: one token per row
        per_tok = 2 * n
        toks = shape_spec.global_batch
    return float(per_tok) * toks


# ---------------------------------------------------------------------------
# the decode step
# ---------------------------------------------------------------------------

_ENCODER = ("enc_blocks", "ln_enc", "pos_enc")


def _weight_bytes(params, cfg, slots: int) -> float:
    """Bytes of the weights one decode step of ``slots`` rows reads."""
    total = 0.0
    for key, leaf in params.items():
        if key in _ENCODER:
            continue
        if key == "pos_dec" or (key == "embed" and not cfg.tie_embeddings):
            rows = min(slots, leaf.shape[0])           # a lookup of one row a slot
            total += param_bytes(leaf) * rows / leaf.shape[0]
            continue
        total += sum(_leaf_bytes(t) for _, t in flatten_with_path(leaf))
    return total


def _leaf_bytes(t) -> float:
    if isinstance(t, ShardedTensor):
        return sum(_leaf_bytes(p) for p in t.pieces)
    if isinstance(t, BlockSparseTensor):
        # kept tiles from the kernel's gather list (uniform keep per block
        # column), and the bitmap: BlockSparseTensor.nbytes from shapes alone
        return (t.idx.numel() * t.bs * t.bs * t.w.element_size()
                + int(t.mask.numel() / 8 + 1))
    return param_bytes(t)


def _positions(positions, slots: int):
    if isinstance(positions, int):
        return [positions] * slots
    out = [int(p) for p in positions]
    if len(out) != slots:
        raise ValueError(f"{len(out)} positions for {slots} slots")
    return out


def _kv_kinds(cfg):
    """{("blocks", u) / ("tail", i): "L" or "G"} for the transformer
    families' KV sections."""
    from repro_torch.models.transformer import pattern_unit
    unit, R, tail = pattern_unit(cfg)
    pat = cfg.pattern()
    kinds = {("blocks", u): k for u, k in enumerate(unit)}
    kinds.update({("tail", i): pat[len(unit) * R + i] for i in range(tail)})
    return kinds


def _state_bytes(state, cfg, slots: int, positions) -> Dict[str, float]:
    """Bytes of the slot state one decode step reads and writes."""
    pos = _positions(positions, slots)
    kinds = _kv_kinds(cfg) if cfg.family in ("dense", "moe", "vlm") else {}
    read = written = 0.0
    for path, t in flatten_with_path(state):
        if isinstance(t, ShardedTensor):          # a mesh engine's k/v: its pieces
            nbytes = t.nbytes
        elif torch.is_tensor(t):
            nbytes = t.numel() * t.element_size()
        else:
            continue
        if path[-1] in ("k", "v") and "cross" not in path:
            # [..., B, T, K, hd] (contiguous) or [..., blocks, bs, K, hd]
            # (paged): bytes of one position of one slot
            per_pos = nbytes / (t.shape[-4] * t.shape[-3])
            window = cfg.window_size if kinds.get(tuple(path[:2])) == "L" else 0
            touched = sum(min(p, window) if window else p for p in pos)
            read += per_pos * (touched - slots)       # the cached positions
            written += per_pos * slots                # this step's K/V
        elif "cross" in path or not t.dtype.is_floating_point:
            read += nbytes                            # encoder K/V, lengths
        else:
            read += nbytes                            # recurrent state
            written += nbytes
    return {"state_read": read, "state_written": written}


class _Tally:
    """A step's collectives two ways.  The single controller's, by phase
    and kind (``bytes``, ``calls``): what ``collectives`` records when the
    step runs.  And what one device's program holds, the reference's
    convention (``launch/hlo_analysis.py`` reads each compiled cell's
    per-device HLO): ``dev`` {kind: result bytes}, the gathers that only
    the single controller runs in ``port_only`` {name: {kind: bytes}},
    and ``widen`` {kind: bytes}, what the device's floating-point
    collectives narrower than f32 would add in f32."""

    def __init__(self):
        self.bytes = {p: {} for p in ("forward", "backward", "gradients")}
        self.calls = {p: {} for p in ("forward", "backward", "gradients")}
        self.dev: Dict[str, float] = {}
        self.port_only: Dict[str, Dict[str, float]] = {}
        self.widen: Dict[str, float] = {}

    def add(self, phase: str, kind: str, nbytes: float, calls: int = 1, *, per: float = 1.0,
            only: str = None, size: int = 4, dev_nbytes: float = None) -> None:
        """``calls`` of a collective of ``nbytes`` a call; a device takes
        part in ``per`` of them and holds ``dev_nbytes`` a call (default
        ``nbytes``) of elements of ``size`` bytes, listed under ``only``
        where XLA emits no such collective."""
        if not calls:
            return
        self.bytes[phase][kind] = self.bytes[phase].get(kind, 0.0) + nbytes * calls
        self.calls[phase][kind] = self.calls[phase].get(kind, 0) + calls
        self.device(kind, (nbytes if dev_nbytes is None else dev_nbytes) * calls * per,
                    only=only, size=size)

    def device(self, kind: str, nbytes: float, *, only: str = None, size: int = 4) -> None:
        """``nbytes`` of one device's program that the controller's count
        does not hold as such (XLA's decomposition of the same step)."""
        if only is not None:
            into = self.port_only.setdefault(only, {})
            into[kind] = into.get(kind, 0.0) + nbytes
            return
        self.dev[kind] = self.dev.get(kind, 0.0) + nbytes
        if size < 4:
            self.widen[kind] = self.widen.get(kind, 0.0) + nbytes * (4 / size - 1)

    def forward(self, kind, nbytes, calls, again: bool, **kw) -> None:
        """A forward collective, run again by the backward's recomputation
        where ``again``."""
        self.add("forward", kind, nbytes, calls, **kw)
        if again:
            self.add("backward", kind, nbytes, calls, **kw)

    def device_forward(self, kind, nbytes, again: bool, size: int) -> None:
        self.device(kind, nbytes * (2 if again else 1), size=size)


def _gathers(w, lead: float, act: int, t: _Tally, per: float, sp: bool) -> None:
    """Add one use of ``w`` on ``lead`` activation rows to ``t``'s forward:
    a column-sharded weight's all-gather of its output [lead, d_out], a
    row-sharded one's all-reduce of it, an expert stack's all-gather of
    [E, C, d_out] (``lead`` = E * C), each in the activation's ``act``
    bytes, and its pieces' own collectives.  One device holds ``per`` of
    each; XLA keeps a column output split over "model" (``port_only``
    ``"column_outputs"``) and, under the activations' sequence split
    ``sp``, gathers a row-split section's input [lead, d_out] instead."""
    if not isinstance(w, ShardedTensor):
        return
    d_out = w.shape[-1]
    if w.dim == -2:
        t.add("forward", "all-reduce", lead * d_out * act, per=per, size=act)
        if sp:
            t.device("all-gather", lead * d_out * act * per, size=act)
    else:
        t.add("forward", "all-gather", lead * d_out * act, per=per, size=act,
              only="column_outputs" if w.dim == -1 else None)
    for p in w.pieces:
        if w.dim == -3:
            _gathers(p, lead * _experts(p) // _experts(w), act, t, per, False)
        else:
            _gathers(p, lead, act, t, per / len(w.pieces), False)


def _experts(w) -> int:
    if isinstance(w, ShardedTensor):
        return (sum(_experts(p) for p in w.pieces) if w.dim == -3
                else _experts(w.pieces[0]))
    return (w.q if isinstance(w, QTensor) else w).shape[-3]


def collective_bytes(params, cfg, rows: int, state=None, *,
                     train: "TrainStep" = None) -> Dict[str, float]:
    """Result bytes per collective kind of one step of ``rows`` tokens
    through a sharded param tree (``distributed/sharding.py``
    ``shard_params``): every sharded linear once per layer that runs it
    (the hybrid's shared block at every site; a decode step runs neither
    the encoder nor the cross-attention's K/V projections, which are
    cached), an expert stack on its [E, C, d] dispatch (C = ``rows``, the
    dropless capacity up to 4096 tokens), a vocab-sharded table's lookup
    all-reduce [rows, d] and its tied logits' all-gather [rows, V] in f32.
    ``state``, a mesh engine's slot state, makes it a decode step over
    that state's sharded k/v (:func:`_cache_collectives`).  The count the
    collectives of ``distributed/collectives.py`` record when the step
    runs.  ``train``, a :class:`TrainStep`, makes it a whole train step of
    the placed tree (``rows`` unused): :func:`train_collectives`' bytes."""
    if train is not None:
        return train_collectives(params, cfg, train)["bytes"]
    return collective_report(params, cfg, rows, state)["bytes"]


def collective_report(params, cfg, rows: int, state=None, *, share: float = 1.0,
                      sp: bool = False) -> Dict[str, Dict]:
    """:func:`collective_bytes` (``"bytes"``) and what one device's program
    holds of that step (``"per_device"``, ``"port_only"``, ``"widen"``:
    see :class:`_Tally`), where a device runs ``share`` of the ``rows``
    (1 / the dp positions where the batch splits over them) and ``sp``
    says the reference keeps the activations split over "model" between
    layers (its dry run's train and prefill cells: each row-split
    section's input gathered, as a train step's forward)."""
    from repro_torch.models.layers import moe_capacity
    act = torch.empty((), dtype=cfg.dtype).element_size()
    t = _Tally()
    sites = 1
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import layout
        sites = layout(cfg)[3]
    for path, leaf in flatten_with_path(params):
        if not isinstance(leaf, ShardedTensor) or path[0] in _ENCODER:
            continue
        name = [k for k in path if isinstance(k, str)][-1]
        if "xattn" in path and name in ("wk", "wv"):
            continue
        if name == "embed":
            size = torch.empty((), dtype=leaf.dtype).element_size()     # QEmbed rows: bf16
            t.add("forward", "all-reduce", rows * leaf.shape[-1] * size, per=share, size=size)
            if cfg.tie_embeddings:
                t.add("forward", "all-gather", rows * leaf.shape[-2] * 4, per=share,
                      only="logits")
                if sp:
                    t.device("all-gather", rows * leaf.shape[-1] * act * share, size=act)
            continue
        expert = "moe" in path and name in ("wi", "wg", "wo")
        matrix = 3 if expert else 2
        main = _main(leaf)
        uses = math.prod(main.shape[:main.dim() - matrix])
        if path[0] == "shared":
            uses *= sites
        lead = rows
        if expert:
            lead = _experts(leaf) * moe_capacity(rows, cfg, train=False)
        one = _Tally()
        _gathers(leaf, lead, act, one, share, sp)
        if name == "unembed":
            one.port_only["logits"] = one.port_only.pop("column_outputs", {})
            if sp:
                one.device("all-gather", lead * leaf.shape[-2] * act * share, size=act)
        _merge(t, one, uses)
    if state is not None:
        _cache_collectives(params, state, cfg, rows, act, t, share)
    return {"bytes": t.bytes["forward"], **_device_report(t)}


def _merge(t: _Tally, one: _Tally, times: float = 1) -> None:
    """Add ``times`` x ``one`` to ``t``."""
    for phase in one.bytes:
        for k, v in one.bytes[phase].items():
            t.bytes[phase][k] = t.bytes[phase].get(k, 0.0) + v * times
            t.calls[phase][k] = t.calls[phase].get(k, 0) + one.calls[phase][k] * times
    for mine, theirs in ((t.dev, one.dev), (t.widen, one.widen)):
        for k, v in theirs.items():
            mine[k] = mine.get(k, 0.0) + v * times
    for name, kb in one.port_only.items():
        into = t.port_only.setdefault(name, {})
        for k, v in kb.items():
            into[k] = into.get(k, 0.0) + v * times


def _device_report(t: _Tally) -> Dict[str, Dict]:
    return {"per_device": dict(t.dev), "port_only": {k: dict(v) for k, v in t.port_only.items()},
            "widen": dict(t.widen)}


@dataclass
class TrainStep:
    """A placed train step's shape: ``batch`` rows of ``seq_len`` tokens
    (a vlm's text tokens; its ``n_img_tokens`` image positions come
    ahead), an encdec's ``enc_len`` frames a row, ``microbatches``,
    ``xent_chunk`` and ``remat`` as ``make_train_step`` takes them."""
    batch: int
    seq_len: int
    microbatches: int = 1
    xent_chunk: int = 0
    remat: bool = True
    enc_len: int = 0


_REMAT_ROOTS = ("blocks", "mamba_groups", "shared", "enc_blocks", "dec_blocks")
# the families whose layers the reference's dry run constrains to the
# activations' sequence split (``sharding.constrain``)
_SEQUENCE_SPLIT = ("dense", "moe", "vlm", "hybrid", "rwkv")


def _layer_bytes(w) -> float:
    """Bytes of one layer (one use) of a whole leaf or gathered piece."""
    main = _main(w)
    return math.prod(w.shape[-2:]) * main.element_size()


def _is_fsdp(w) -> bool:
    return isinstance(w, ShardedTensor) and w.axis == "data" and w.dim in (-1, -2)


def _gathered(w, split: bool, t: _Tally, calls: int, again: bool, per: float):
    """``w`` as a split step multiplies by it, as ``data_parallel.unshard``
    makes it: each FSDP split made over "data" gathered per use (counted;
    a meta tensor of the gathered shape in its place; a device gathers
    the one model piece it holds); ``w`` itself outside a split step."""
    if not split or not isinstance(w, ShardedTensor):
        return w
    if _is_fsdp(w):
        inner = w.pieces[0]
        if isinstance(inner, ShardedTensor):     # "data" outermost: gather each inner piece
            per_m = [ShardedTensor([p.pieces[m] for p in w.pieces], w.dim, w.axis, w.mesh)
                     for m in range(len(inner.pieces))]
            return ShardedTensor([_gathered(g, split, t, calls, again, per / len(per_m))
                                  for g in per_m], inner.dim, inner.axis, inner.mesh)
        t.forward("all-gather", _layer_bytes(w), calls, again, per=per,
                  size=_main(w).element_size())
        return torch.empty(w.shape, dtype=_main(w).dtype, device="meta")
    return ShardedTensor([_gathered(p, split, t, calls, again, per / len(w.pieces))
                          for p in w.pieces], w.dim, w.axis, w.mesh)


def _linear_use(w, lead: float, act: int, split: bool, t: _Tally, calls: int,
                again: bool, per: float, sp: bool) -> None:
    """One use of a linear ``w`` on ``lead`` activation rows, made
    ``calls`` times: a split step's FSDP gathers first (:func:`_gathered`),
    then :func:`_split_rules`."""
    _split_rules(_gathered(w, split, t, calls, again, per), lead, act, t, calls, again, per, sp)


def _split_rules(w, lead: float, act: int, t: _Tally, calls: int, again: bool, per: float,
                 sp: bool) -> None:
    """A column split's output all-gather and, in the backward, the
    all-reduce of its input's gradient (the hand-off's conjugate); a row
    split's all-reduce and its input's gradient all-gathered (the split's
    conjugate); an expert stack's output gathered [E, C, d_out] and its
    input's gradient [E, C, d_in]; then the pieces' own.

    One device holds ``per`` of them.  XLA keeps the column outputs split
    over "model" into the row split that cuts them again, so the column
    outputs' gathers and the row inputs' gradient gathers are
    ``port_only``.  Under the activations' sequence split ``sp`` (read
    from the reference's compiled step) it gathers instead each row-split
    section's input [lead, d_out] (again in the recomputation) and its
    output's gradient, and each column split's input for its weight's
    gradient."""
    if not isinstance(w, ShardedTensor):
        return
    d_in, d_out = w.shape[-2], w.shape[-1]
    if w.dim == -2:
        t.forward("all-reduce", lead * d_out * act, calls, again, per=per, size=act)
        t.add("backward", "all-gather", lead * d_in * act, calls, per=per,
              only="row_input_gradients")
        if sp:
            t.device_forward("all-gather", lead * d_out * act * calls * per, again, act)
            t.device("all-gather", lead * d_out * act * calls * per, size=act)
    elif w.dim == -1:
        t.forward("all-gather", lead * d_out * act, calls, again, per=per,
                  only="column_outputs")
        t.add("backward", "all-reduce", lead * d_in * act, calls, per=per, size=act)
        if sp:
            t.device("all-gather", lead * d_in * act * calls * per, size=act)
    else:
        t.forward("all-gather", lead * d_out * act, calls, again, per=per, size=act)
        t.add("backward", "all-gather", lead * d_in * act, calls, per=per, size=act)
    for p in w.pieces:
        if w.dim == -3:
            _split_rules(p, lead * _experts(p) / _experts(w), act, t, calls, again, per, False)
        else:
            _split_rules(p, lead, act, t, calls, again, per / len(w.pieces), False)


def _table_uses(leaf, cfg, rows_lookup: float, rows_logits: float, lookups: int,
                logit_calls: int, act: int, split: bool, t: _Tally, again_logits: bool,
                per: float, sp: bool) -> None:
    """The embedding table's lookups and, tied, its logits (see
    ``models/layers.py``): FSDP gathers in a split step; a vocab split's
    rows all-reduced; a piece's ``d_model`` split (outside a split step)
    gathering its rows' columns or, for the logits, cutting ``x`` (its
    gradient all-gathered) and all-reducing the partial f32 logits; the
    tied logits' ``x`` handed to each vocab piece (its gradient
    all-reduced) and the pieces' f32 logits gathered.  XLA reads the
    vocab pieces' logits in place (``port_only`` ``"logits"``); under the
    sequence split ``sp`` it gathers the final norm's output for the
    logits' section and again for the table's gradient."""
    size = _main(leaf).element_size()
    V, d = leaf.shape[-2], leaf.shape[-1]
    w = _gathered(leaf, split, t, lookups, False, per)
    if isinstance(w, ShardedTensor):
        t.forward("all-reduce", rows_lookup * d * size, lookups, False, per=per, size=size)
        for p in w.pieces:
            if isinstance(p, ShardedTensor):
                t.forward("all-gather", rows_lookup * d * size, lookups, False,
                          per=per / len(w.pieces), size=size)
    if not cfg.tie_embeddings:
        return
    w = _gathered(leaf, split, t, logit_calls, again_logits, per)
    if not isinstance(w, ShardedTensor):
        return
    t.forward("all-gather", rows_logits * V * 4, logit_calls, again_logits, per=per,
              only="logits")
    t.add("backward", "all-reduce", rows_logits * d * act, logit_calls, per=per, size=act)
    if sp:
        t.device("all-gather", rows_logits * d * act * logit_calls * per, size=act)
    for p in w.pieces:
        if isinstance(p, ShardedTensor):
            inner = per / len(w.pieces)
            t.forward("all-reduce", rows_logits * p.shape[-2] * 4, logit_calls, again_logits,
                      per=inner, only="logits")
            t.add("backward", "all-gather", rows_logits * d * act, logit_calls, per=inner,
                  only="logits")


def _gradient_reduction(params, pieces, microbatches: int, t: _Tally,
                        rows_used: Dict[str, float] = None,
                        replicated=lambda path: False) -> None:
    """Each float tensor's gradient reduced over the split step's ``pieces``
    (``data_parallel._reduce``): an all-reduce of every tensor the dp axes
    do not split, one reduce-scatter of each FSDP split's shards, and an
    expert stack's experts over "data" all-reduced over "pod" only.  A
    device reduces the model shard it holds, and receives 1 / "data" of
    an FSDP split's shards, which it all-reduces over "pod" where there
    are pods (read from qwen2-moe-a2.7b's and gemma2-2b's compiled steps
    on (2, 2, 2)).  ``rows_used`` {top-level key: rows}: a table the step
    reads a slice of (an encdec's learned positions), whose gradient XLA
    reduces only at the rows the slice touched (read from whisper-base's
    compiled step); the port reduces it whole, the rest ``port_only``
    ``"untouched_rows"``.  The tensors whose path ``replicated`` holds are
    ones every device's program computes the same gradient of, reduced by
    the port only (``"replicated_gradients"``)."""
    pods = len({p.get("pod", 0) for p in pieces})
    rows_used = rows_used or {}

    def walk(node, kind, per, t=t):
        if isinstance(node, ShardedTensor):
            if node.axis == "data":
                if _is_fsdp(node) and not isinstance(node.pieces[0], ShardedTensor):
                    size = 4 if microbatches > 1 else node.pieces[0].element_size()
                    whole = sum(p.numel() for p in node.pieces) * size
                    t.add("gradients", "reduce-scatter", whole, 1,
                          per=per / len(node.pieces), size=size)
                    if pods > 1:                 # the shard over "pod" on a device
                        t.device("all-reduce", whole * per / len(node.pieces), size=size)
                    return
                if _is_fsdp(node):               # "data" outermost: one group per inner piece
                    m = len(node.pieces[0].pieces)
                    for i in range(m):
                        walk(ShardedTensor([p.pieces[i] for p in node.pieces], node.dim,
                                           node.axis, node.mesh), kind, per / m, t)
                    return
                kind = "ep"
            for p in node.pieces:
                walk(p, kind, per / len(node.pieces), t)
            return
        if not (isinstance(node, torch.Tensor) and node.is_floating_point()):
            return
        size = 4 if microbatches > 1 else node.element_size()
        if kind == "all" or pods > 1:
            t.add("gradients", "all-reduce", node.numel() * size, 1, per=per, size=size)

    for path, leaf in flatten_with_path(params):
        one = _Tally()
        walk(leaf, "all", 1.0, one)
        _merge(t, one)
        if replicated(path):
            _to_port_only(t, one, "replicated_gradients")
        elif path[0] in rows_used:
            _to_port_only(t, one, "untouched_rows",
                          1 - min(rows_used[path[0]] / leaf.shape[0], 1.0))


def _to_port_only(t: _Tally, one: _Tally, name: str, share: float = 1.0) -> None:
    """Move ``share`` of ``one``'s per-device figures, already merged into
    ``t``, to ``t``'s ``port_only`` ``name``."""
    into = t.port_only.setdefault(name, {})
    for kind, v in one.dev.items():
        t.dev[kind] = t.dev.get(kind, 0.0) - v * share
        t.widen[kind] = t.widen.get(kind, 0.0) - one.widen.get(kind, 0.0) * share
        into[kind] = into.get(kind, 0.0) + v * share


def _apart(plan, M: int) -> int:
    """How many times one device's program reduces the gradients: once a
    microbatch where the rows split, whether or not a microbatch's rows
    split over every dp position (read from gemma2-2b's compiled steps at
    2 microbatches on (2, 4) and on (4, 2), and rwkv6-3b's on (2, 4))."""
    return M if plan.by == "rows" else 1


def _device_only(t: _Tally) -> _Tally:
    """``t``'s per-device figures alone (the controller's count left out)."""
    out = _Tally()
    out.dev, out.widen = dict(t.dev), dict(t.widen)
    return out


def _step_split(params, cfg, step: "TrainStep"):
    """(the mesh, ``data_parallel.Split`` of the step's batch)."""
    from repro_torch.distributed.data_parallel import Split, mesh_of, plan_split
    mesh = mesh_of(params)
    if mesh is None:
        return None, Split()
    return mesh, plan_split(mesh, step.batch, step.seq_len, step.microbatches, cfg.family)


def _sequence_split(cfg, mesh, plan, step: "TrainStep") -> bool:
    """Whether the reference's dry run keeps this step's activations split
    over "model" along the sequence between layers: its
    ``set_activation_sharding`` constraint ``(dp axes, "model", None)``
    holds where a microbatch's rows divide the dp axes and its positions
    the "model" axis, in the families that apply it."""
    if cfg.family not in _SEQUENCE_SPLIT or plan.by != "rows" or plan.blocks != plan.n:
        return False
    model = mesh.shape.get("model", 1)
    seq = step.seq_len + (cfg.n_img_tokens if cfg.family == "vlm" else 0)
    return model > 1 and seq % model == 0


def _model_pieces(w) -> int:
    """Into how many pieces the "model" axis cuts a sharded leaf."""
    n = 1
    while isinstance(w, ShardedTensor):
        if w.axis == "model":
            n *= len(w.pieces)
        w = w.pieces[0]
    return n


def train_collectives(params, cfg, step: TrainStep) -> Dict[str, Dict]:
    """The collectives of one ``make_train_step`` step of the placed tree
    ``params`` (``sharding.place``, FSDP as placed) at ``step``'s shape:
    ``{"bytes": {kind: result bytes}, "calls": {kind: calls},
    "breakdown": {"forward" | "backward" | "gradients": {kind: bytes}},
    "calls_breakdown": ..., "split": dp positions (1: the batch whole),
    "split_by": "rows" | "positions" | None, "per_device", "port_only",
    "widen"}``.  ``bytes`` and ``calls`` equal ``collectives.result_bytes``
    and ``calls`` of one executed step (forward, backward and gradients;
    the optimizer's own reductions are not part of it), byte for byte:

    - forward: every sharded linear as :func:`collective_bytes` counts it,
      per dp position and microbatch on its part (its rows, or every
      row's block of positions: ``data_parallel.Split``; a replica runs
      its block again), the tables' lookups and tied logits (per
      cross-entropy chunk), a split step's FSDP gathers per use
      (``data_parallel.unshard``), the MoE exchange of a split step (gates
      [T, k] f32 and choices [T, k] int64 gathered, router probabilities
      [E] f32 all-reduced, T the microbatch's tokens), a split of the
      positions' K/V gathers at every attention layer (k and v [rows,
      seq, K, hd] onto each piece of a "pod" position, one call each) and
      the loss's 4-byte all-reduce a microbatch;
    - backward: each hand-off's conjugate (a column split's input
      gradient all-reduced, a row or expert split's all-gathered, the K/V
      gathers' gradients reduce-scattered), and, under ``remat``, the
      forward collectives of every checkpointed block again (the
      recomputation re-runs them; the MoE exchange is read back, not
      re-run; each piece gathers the K/V again, one call for k and one
      for v);
    - gradients (a split step): every tensor the dp axes do not split
      all-reduced, each FSDP split reduce-scattered, experts over "data"
      all-reduced over "pod" where there are pods; in the gradients' dtype
      (f32 with several microbatches).

    ``per_device`` is what one device's program holds, the reference's
    convention (``launch/hlo_analysis.py``: per-device result bytes): a
    collective every dp position runs counts one position's call (the
    controller's sum over the n positions is n of them), a gradient the
    model shard a device holds, a reduce-scatter 1 / "data" of the
    shards, and the K/V gathers a device's KV heads.  XLA emits none of
    the port's gathers of a column output that a row split cuts again
    (its activations stay split over "model"), nor the logits' gathers
    (the loss reads the vocab pieces in place), nor those gathers'
    conjugates: ``port_only`` lists them, per device.  Where the
    reference's dry run keeps the activations split over "model" along
    the sequence between layers (its rows divide the dp axes and its
    positions the "model" axis), ``per_device`` holds what XLA moves
    instead, read from the compiled step: each row-split section's input
    gathered (and again in the recomputation), its output's gradient
    gathered, each column split's input gathered for its weight's
    gradient, and the logits' section likewise.  :func:`hlo_terms` names
    what a CPU compile of the reference adds on top."""
    from repro_torch.distributed.data_parallel import dp_pieces
    from repro_torch.models.layers import moe_capacity
    t = _Tally()
    mesh, plan = _step_split(params, cfg, step)
    split = plan.by is not None
    n = plan.n if split else 1
    M = step.microbatches
    per = 1.0 / n
    runs = M * n
    act = torch.empty((), dtype=cfg.dtype).element_size()
    S_text = step.seq_len
    b = step.batch / M
    if plan.by == "rows":
        b = b / plan.blocks                       # rows a position a microbatch
    elif plan.by == "positions":
        S_text = S_text / plan.blocks
    S = S_text + (cfg.n_img_tokens if cfg.family == "vlm" else 0)
    rows = b * S
    chunked = step.xent_chunk > 0 and cfg.family in ("dense", "moe", "vlm")
    nchunks = max(int(S_text) // step.xent_chunk, 1) if chunked else 1
    logit_rows = (b * S_text if chunked else rows) / nchunks
    again_logits = chunked and step.remat
    sp = _sequence_split(cfg, mesh, plan, step)
    fs = _feature_split_frames(cfg, mesh, plan)
    rwkv_sp = cfg.family == "rwkv" and sp and not _has_fsdp(params)
    fs_vlm = (cfg.family == "vlm" and plan.by == "positions"
              and cfg.d_model % mesh.shape.get("model", 1) == 0)
    lead_vlm = (step.seq_len + cfg.n_img_tokens) / plan.blocks if fs_vlm else 0
    sites = 1
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import layout
        sites = layout(cfg)[3]
    tokens_mb = step.batch / M * (step.seq_len + (cfg.n_img_tokens if cfg.family == "vlm"
                                                  else 0))
    for path, leaf in flatten_with_path(params):
        name = [k for k in path if isinstance(k, str)][-1]
        if name == "embed":
            if isinstance(leaf, ShardedTensor):
                _table_uses(leaf, cfg, rows - b * (S - S_text), logit_rows, runs,
                            runs * nchunks, act, split, t, again_logits, per, sp)
            continue
        if name == "router" and "moe" in path and split:
            uses = math.prod(leaf.shape[:-2])
            E, k = cfg.n_experts, cfg.top_k
            ex = _Tally()
            ex.add("forward", "all-gather", tokens_mb * k * 4, uses * M)
            ex.add("forward", "all-gather", tokens_mb * k * 8, uses * M, size=8)
            ex.add("forward", "all-reduce", E * 4, uses * M)
            _merge(t, _controller_only(ex, "moe_exchange"))
            _moe_dispatch(params, cfg, mesh, b * S, tokens_mb, act, t, uses * M,
                          step.remat and path[0] in _REMAT_ROOTS)
        again = step.remat and path[0] in _REMAT_ROOTS
        if name == "wk" and plan.by == "positions" and "attn" in path and path[0] != "enc_blocks":
            kv = _Tally()
            _kv_gathers(leaf, cfg, b, step.seq_len, plan, M, act, kv, again)
            if fs_vlm:                  # XLA gathers the image's K/V too: see _feature_split
                _merge(t, _controller_only(kv, "text_kv_gathers"))
                _sp_kv_gathers(leaf, cfg, b * lead_vlm * plan.blocks * M, act, t, again,
                               halves=False)
            else:
                _merge(t, kv)
        if name == "wk" and sp and "attn" in path and _model_pieces(leaf) == 1:
            _sp_kv_gathers(leaf, cfg, rows * M, act, t, again)
        if fs_vlm and name == "wk" and not isinstance(leaf, ShardedTensor):
            _feature_split(name, leaf, b * lead_vlm, act, t, math.prod(leaf.shape[:-2]) * M,
                           again, encoder=True)
        if not isinstance(leaf, ShardedTensor):
            continue
        expert = "moe" in path and name in ("wi", "wg", "wo")
        main = _main(leaf)
        uses = math.prod(main.shape[:main.dim() - (3 if expert else 2)])
        if path[0] == "shared":
            uses *= sites
        again = step.remat and path[0] in _REMAT_ROOTS
        lead = rows
        if name == "unembed":
            lead, again, uses = logit_rows, again_logits, nchunks
        elif cfg.family == "encdec" and (path[0] == "enc_blocks"
                                         or ("xattn" in path and name in ("wk", "wv"))):
            lead = b * step.enc_len
        if expert:
            lead = _experts(leaf) * moe_capacity(int(tokens_mb), cfg, train=True)
        one = _Tally()
        _linear_use(leaf, lead, act, split, one, uses * runs, again, per, sp)
        if name == "unembed":
            one.port_only["logits"] = one.port_only.pop("column_outputs", {})
        if expert and split:                      # XLA's dispatch instead: _moe_dispatch
            one = _controller_only(one, "expert_gathers")
        if rwkv_sp and path[0] == "blocks":       # XLA's layer instead: _rwkv_sequence_split
            one = _controller_only(one, "rwkv_layers")
            if name == "wr" and "cm" in path:
                _rwkv_sequence_split(leaf, cfg, rows, act, t, uses * M, again, M)
        _merge(t, one)
        if (again and split and name == "wo" and not cfg.post_norms
                and any(m in path for m in ("mlp", "shared_mlp", "dense_mlp"))):
            _unread_recompute(leaf, lead, act, t, uses * runs, per)
        if fs and (path[0] == "enc_blocks" or "xattn" in path):
            _feature_split(name, leaf, lead, act, t, uses * M, again,
                           encoder=path[0] == "enc_blocks", xattn="xattn" in path)
        if fs_vlm and path[0] in ("blocks", "tail") and name != "unembed":
            _feature_split(name, leaf, b * lead_vlm, act, t, uses * M, again, encoder=True)
    if fs:                                        # the encoder's output, for the cross K/V
        t.device("all-gather", b * step.enc_len * cfg.d_model * act * M, size=act)
    if fs_vlm:                                    # the logits' section input
        t.device_forward("all-gather", b * S_text * cfg.d_model * act * M, again_logits, act)
        t.device("all-gather", b * S_text * cfg.d_model * act * M, size=act)
        # the lookup's gradient rows [rows, d / model] gathered over "data"
        t.device("all-gather", b * step.seq_len * cfg.d_model * 4 * M
                 / mesh.shape.get("model", 1))
    if sp:                                        # the logits' section input
        t.device_forward("all-gather", logit_rows * cfg.d_model * act * runs * nchunks * per,
                         again_logits, act)
        if cfg.family == "vlm":                   # the text slice's gradient (a pad)
            t.device("all-gather", b * S_text * cfg.d_model * act * M, size=act)
        # the embedding's output moved into the sequence split and its
        # gradient back, [rows, S / model, d] each, once a step whatever
        # the layers (read from qwen2-moe-a2.7b's steps at 2 and 3 layers)
        t.device("collective-permute", 2 * rows / mesh.shape["model"] * cfg.d_model * act * M,
                 size=act)
    if split:
        t.add("forward", "all-reduce", 4, M)
        g = _Tally()
        whole_encoder = cfg.family == "encdec" and plan.by == "positions"
        # every device runs its experts on every token that reaches them,
        # the other pods' too (read from qwen2-moe-a2.7b's steps on (8, 2)
        # and (2, 2, 2)): no expert gradient is reduced
        whole_experts = cfg.family == "moe" and (_experts_whole(cfg, mesh)
                                                 or mesh.shape.get("pod", 1) > 1)
        _gradient_reduction(
            params, dp_pieces(mesh), M, g,
            {"pos_enc": step.enc_len, "pos_dec": step.seq_len} if cfg.family == "encdec" else None,
            lambda path: ((whole_encoder and path[0] in _ENCODER)
                          or (whole_experts and "moe" in path and path[-1] in ("wi", "wg", "wo"))))
        if whole_encoder:
            # every piece runs the encoder on the same frames: XLA sums the
            # encoder output's gradient over the pieces [b, enc_len, d] and
            # each runs the same encoder backward (its weights' gradients
            # not reduced), and gathers the decoder positions' gradient
            # rows [seq, d] of the sliced table (read from whisper-base's
            # compiled step at batch 1)
            g.device("all-reduce", b * step.enc_len * cfg.d_model * act * M, size=act)
            g.device("all-gather", step.seq_len * cfg.d_model * 4 * M)
        # several microbatches: XLA reduces each microbatch's gradients
        # apart, over the positions that split it (:func:`_apart`)
        _merge(t, g)
        _merge(t, _device_only(g), _apart(plan, M) - 1)
    if _stationary(params, plan):
        _stationary_device(params, cfg, step, mesh, t)
    total_b: Dict[str, float] = {}
    total_c: Dict[str, int] = {}
    for phase in t.bytes:
        for k, v in t.bytes[phase].items():
            total_b[k] = total_b.get(k, 0.0) + v
            total_c[k] = total_c.get(k, 0) + t.calls[phase][k]
    return {"bytes": total_b, "calls": total_c, "breakdown": t.bytes,
            "calls_breakdown": t.calls, "split": n, "split_by": plan.by, **_device_report(t)}


def _stationary(params, plan) -> bool:
    """Whether XLA keeps the weights split at this step: FSDP split some
    weight and the step is a fallback (its positions over "data", or
    microbatches whose rows do not split over every dp position)."""
    fallback = plan.by == "positions" or (plan.by == "rows" and plan.blocks < plan.n)
    return fallback and _has_fsdp(params)


def _has_fsdp(params) -> bool:
    """Whether FSDP split some leaf of ``params`` over "data"."""
    return any(_is_fsdp(leaf) or (isinstance(leaf, ShardedTensor) and _is_fsdp(leaf.pieces[0]))
               for leaf in leaves(params))


def _axis_pieces(w, axis: str, dim: int) -> int:
    """Into how many pieces ``axis`` cuts ``w`` along ``dim``."""
    n = 1
    while isinstance(w, ShardedTensor):
        if w.axis == axis and w.dim == dim:
            n *= len(w.pieces)
        w = w.pieces[0]
    return n


def _stationary_device(params, cfg, step: "TrainStep", mesh, t: _Tally) -> None:
    """One device's program where XLA keeps FSDP's weights split
    (:func:`_stationary`; read from gemma2-2b's compiled steps at batch 1
    on (2, 4) and at 2 microbatches on (4, 2)): every device runs every row
    and position of a microbatch (``R`` of them, a vlm's image too), its
    activations split along the features over "data", and moves the
    activations, not the weights.  A linear split over "data" along its
    input all-reduces its output [R, d_out / model pieces] over "data" (in
    the forward and again in the recomputation) and its input's gradient
    [R, d_in / data pieces] over "model"; one split over "data" along its
    output all-reduces its output [R, d_out / data pieces] over "model" and
    its input's gradient [R, d_in / model pieces] over "data" (each
    all-reduce over "model" only where "model" splits the other dim).  A
    vlm's image, split over "model" along its features, is gathered to
    its "data" cut [rows, n_img, d / data].  The tied
    table's logits [text rows, V / model pieces] in f32 are all-reduced
    over "data" (again in the recomputation, and once more at several
    microbatches) and gathered twice in the backward, its lookup
    all-reduced over "model" [text rows, d / data pieces] (the logits' third
    all-reduce read from gemma2-2b's step at 2 microbatches on (4, 2)).  No
    gradient is reduced: each device's weight gradients are its own
    shard's.  Replaces the tally's per-device figures; the port's own
    gathers per use and gradient reductions go to ``port_only``
    ``"weights_gathered"``."""
    act = torch.empty((), dtype=cfg.dtype).element_size()
    M = step.microbatches
    R = step.batch / M * (step.seq_len + (cfg.n_img_tokens if cfg.family == "vlm" else 0))
    into = t.port_only.setdefault("weights_gathered", {})
    for kind, v in t.dev.items():
        into[kind] = into.get(kind, 0.0) + v
    t.dev, t.widen = {}, {}
    for path, leaf in flatten_with_path(params):
        name = [k for k in path if isinstance(k, str)][-1]
        if not isinstance(leaf, ShardedTensor) or name == "router" or len(leaf.shape) < 2:
            continue
        again = step.remat and path[0] in _REMAT_ROOTS
        main = _main(leaf)
        uses = math.prod(main.shape[:-2]) * M
        d_in, d_out = leaf.shape[-2], leaf.shape[-1]
        if name == "embed":                   # the text's rows
            V, d, rt = d_in, d_out, step.batch / M * step.seq_len
            pm, pd = _axis_pieces(leaf, "model", -2), _axis_pieces(leaf, "data", -1)
            t.device("all-reduce", rt * d / pd * act * M, size=act)
            if cfg.tie_embeddings:
                t.device_forward("all-reduce", rt * V / pm * 4 * M, step.remat, 4)
                if M > 1:
                    t.device("all-reduce", rt * V / pm * 4 * M)
                t.device("all-gather", 2 * rt * V / pm * 4 * M)
                t.device("all-reduce", rt * d / pd * act * M, size=act)
            continue
        if _axis_pieces(leaf, "data", -2) > 1:
            out = R * d_out / _axis_pieces(leaf, "model", -1) * act * uses
            t.device_forward("all-reduce", out, again, act)
            if _axis_pieces(leaf, "model", -1) > 1:
                t.device("all-reduce", R * d_in / _axis_pieces(leaf, "data", -2) * act * uses,
                         size=act)
        elif _axis_pieces(leaf, "data", -1) > 1:
            if _axis_pieces(leaf, "model", -2) > 1:
                out = R * d_out / _axis_pieces(leaf, "data", -1) * act * uses
                t.device_forward("all-reduce", out, again, act)
            t.device("all-reduce", R * d_in / _axis_pieces(leaf, "model", -2) * act * uses,
                     size=act)
    if cfg.family == "vlm":     # the image, split over "model", cut over "data" instead
        t.device("all-gather", step.batch / M * cfg.n_img_tokens * cfg.d_model * act * M
                 / mesh.shape["data"], size=act)


def _unread_recompute(w, lead: float, act: int, t: _Tally, calls: int, per: float) -> None:
    """The recomputation's collectives of a block's last linear (the MLP's
    ``wo``: its FSDP gathers, its row split's all-reduce) where no norm
    follows it: the port's checkpoint re-runs the whole block, but
    nothing in the backward reads that linear's output, so XLA's
    recomputation leaves it out (read from paligemma-3b's, whisper-base's
    and arctic-480b's compiled steps, arctic's dense residual MLP beside
    its experts too; gemma2-2b's post-norms read it):
    ``port_only`` ``"unread_recompute"``."""
    with_it, without = _Tally(), _Tally()
    _linear_use(w, lead, act, True, with_it, calls, True, per, False)
    _linear_use(w, lead, act, True, without, calls, False, per, False)
    recompute = _Tally()
    for mine, a, b in ((recompute.dev, with_it.dev, without.dev),
                       (recompute.widen, with_it.widen, without.widen)):
        mine.update({k: v - b.get(k, 0.0) for k, v in a.items()})
    _to_port_only(t, recompute, "unread_recompute")


def _feature_split_frames(cfg, mesh, plan) -> bool:
    """Whether XLA runs an encdec's encoder split over "model" along the
    features: ``batch_shardings`` splits the frames' ``d_model`` over
    "model" (read from whisper-base's compiled step; the reference
    constrains no encdec activation)."""
    model = mesh.shape.get("model", 1) if mesh is not None else 1
    return (cfg.family == "encdec" and plan.by is not None and model > 1
            and cfg.d_model % model == 0)


def _feature_split(name: str, w, lead: float, act: int, t: _Tally, calls: float,
                   again: bool, *, encoder: bool, xattn: bool = False) -> None:
    """What XLA moves for a linear ``name`` whose activations stay split
    over "model" along the features (:func:`_feature_split_frames`; read
    from whisper-base's compiled step, one device's bytes over ``calls``
    uses): in an ``encoder`` (an encdec's, or a vlm's trunk split along
    its positions: paligemma-3b's step at batch 1), the norm's output
    gathered ahead of each section (at its ``wq`` and its MLP's ``wi``;
    again in the recomputation), and in the backward each column split's
    input and each row split's output gradient for the weight's gradient;
    a decoder layer's cross-attention (``xattn``) ``wk`` and ``wv`` gather
    the encoder's output for their weights' gradients, and ``wk`` once
    more in the recomputation."""
    d_in, d_out = w.shape[-2], w.shape[-1]
    if encoder and name in ("wq", "wi"):
        t.device_forward("all-gather", lead * d_in * act * calls, again, act)
    if xattn and name == "wk" and again:
        t.device("all-gather", lead * d_in * act * calls, size=act)
    if not isinstance(w, ShardedTensor):
        if name == "wk" and encoder:                     # k and v's input, for their gradients
            t.device("all-gather", lead * d_in * act * calls, size=act)
    elif w.dim == -1 and (encoder or name in ("wk", "wv")):
        t.device("all-gather", lead * d_in * act * calls, size=act)
    elif w.dim == -2 and encoder:
        t.device("all-gather", lead * d_out * act * calls, size=act)


def _moe_dispatch(params, cfg, mesh, rows: float, tokens_mb: float, act: int, t: _Tally,
                  layers: float, again: bool) -> None:
    """What one device's program moves for ``layers`` MoE layers of a split
    step, as XLA partitions the reference's sort-based dispatch (read from
    qwen2-moe-a2.7b's compiled steps, 2 layers, on (2, 4), (4, 2) with
    FSDP, (8, 2), (16, 2), (2, 2, 2) and (2, 8, 2), and arctic-480b's on
    (2, 4) and (2, 2, 2), each the same with FSDP and without), with the
    device's ``rows`` tokens (T), the microbatch's ``tokens_mb`` (T_mb)
    and its capacity C.  Each layer all-reduces the expert buffers [E /
    data, C, d] 7 times, and gathers the router's probabilities [T_mb, E]
    (in f32) once and again in the recomputation.  Where "data" divides
    the experts it also all-reduces the dispatched rows [T k, d] 6 times,
    permutes [T k, d] 6 times and [T, d] 5 times, all-reduces [T, d] twice
    (the combine's scatter), gathers its input [T, d] over the sequence
    split in the backward and, unless a shared or dense residual MLP's
    section gathers the same input (arctic's), in the forward, and with
    pods gathers [T pods, d] over "pod" in the forward, the recomputation
    and the backward.  Where it does not (:func:`_experts_whole`) the
    buffers are [E, C, d] and each layer instead gathers the microbatch's
    tokens [T_mb, d] 3 times and all-reduces them twice.  Without
    ``again`` the recomputation's share (2 of the 7, 2, 2, 1, the
    probabilities' second gather, 1 of the 3) is left out.  In the
    activations' dtype, f32 where noted.  The port's own exchange and
    per-piece expert gathers are ``port_only`` (``"moe_exchange"``,
    ``"expert_gathers"``)."""
    from repro_torch.models.layers import moe_capacity
    E, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    whole = _experts_whole(cfg, mesh)
    C = moe_capacity(int(tokens_mb), cfg, train=True)
    buf = (E if whole else E / mesh.shape.get("data", 1)) * C * d * act
    disp, tok = rows * k * d * act, rows * d * act
    r = 1 if again else 0
    t.device("all-reduce", (5 + 2 * r) * buf * layers, size=act)
    t.device("all-gather", (1 + r) * tokens_mb * E * 4 * layers)
    if whole:
        mb = tokens_mb * d * act
        t.device("all-gather", (2 + r) * mb * layers, size=act)
        t.device("all-reduce", 2 * mb * layers, size=act)
        return
    pods = mesh.shape.get("pod", 1)
    if pods > 1:
        t.device("all-gather", (2 + r) * tok * pods * layers, size=act)
    shared = any("shared_mlp" in path or "dense_mlp" in path
                 for path, _ in flatten_with_path(params))
    t.device("all-reduce", (4 + 2 * r) * disp * layers, size=act)
    t.device("collective-permute", ((4 + 2 * r) * disp + (4 + r) * tok) * layers, size=act)
    t.device("all-reduce", 2 * tok * layers, size=act)
    t.device("all-gather", (1 if shared else 2) * tok * layers, size=act)


def _experts_whole(cfg, mesh) -> bool:
    """Whether "data" leaves a MoE layer's experts whole on every device
    (it does not divide them; ``sharding.param_shardings``)."""
    return cfg.n_experts % mesh.shape.get("data", 1) != 0


def _rwkv_sequence_split(cm_wr, cfg, rows: float, act: int, t: _Tally, layers: float,
                         again: bool, M: int) -> None:
    """One device's program for ``layers`` rwkv layers under the
    activations' sequence split, without FSDP (read from rwkv6-3b's
    compiled step, 2 layers, 4 x 64 on (2, 4)), in units of a device's
    rows U = [rows, d]: each layer gathers 5 U in the forward (the token
    mixes ahead of the column splits), 5 U again in the recomputation
    and 9 U in the backward, all-reduces 1.5 U, 4.5 U and 4.5 U, moves
    3.75 U by all-to-all (the heads for the WKV scan and back, 1.375 U in
    the forward, again in the recomputation, 1 U in the backward), and
    gathers the channel mix's receptance ``wr`` whole over "model" (its
    output multiplies the row split's, element by element) in each of
    the three, with the decay's low-rank pair (``wa1``, ``wa2``) in the
    forward and the recomputation, and reduces ``wr``'s whole gradient
    over "data" beside its model shard's, in f32 at several microbatches
    (read from the same step at 2 microbatches, 8 x 64).  Without
    ``again`` the recomputation's shares are left out.  The port's own
    collectives of these layers are ``port_only`` ``"rwkv_layers"``."""
    from repro_torch.models.rwkv import _LORA
    U = rows * cfg.d_model * act * layers
    r = 1 if again else 0
    size = _main(cm_wr).element_size()
    whole = math.prod(cm_wr.shape[-2:]) * size * layers
    lora = 2 * cfg.d_model * _LORA * size * layers
    t.device("all-gather", (5 + 5 * r + 9) * U, size=act)
    t.device("all-gather", (2 + r) * whole + (1 + r) * lora, size=size)
    t.device("all-reduce", (1.5 + 4.5 * r + 4.5) * U, size=act)
    t.device("all-to-all", (1.375 + 1.375 * r + 1) * U, size=act)
    grad = 4 if M > 1 else size
    t.device("all-reduce", whole / size * grad, size=grad)


def _controller_only(t: _Tally, name: str) -> _Tally:
    """``t``'s controller count, its per-device figures ``port_only``
    ``name``."""
    out = _Tally()
    out.bytes, out.calls = t.bytes, t.calls
    out.port_only = {**t.port_only, name: dict(t.dev)}
    return out


def _sp_kv_gathers(wk, cfg, rows: float, act: int, t: _Tally, again: bool,
                   halves: bool = True) -> None:
    """Under the activations' sequence split, the K/V of each layer of a
    ``wk`` the "model" axis does not split (KV heads fewer than its
    positions: every device computes them for its block of positions),
    as XLA moves them (read from paligemma-3b's compiled step: 1 KV head
    on a (2, 4) mesh): k and v [rows, K, hd] gathered along the sequence
    in the forward, in the recomputation and in the backward, and in the
    recomputation and the backward each RoPE half of k and v [rows, K,
    hd / 2] too.  ``rows`` a device's over the microbatches.  A vlm's
    split of its positions over "data" (``halves`` False: read from
    paligemma-3b's step at batch 1) gathers k and v [rows, K / the model
    pieces of ``wk``, hd] over "data" in each of the three, no halves."""
    layers = math.prod(_main(wk).shape[:-2])
    kv = (rows * cfg.n_kv_heads * cfg.resolved_head_dim * act * layers
          / _model_pieces(wk))
    t.device_forward("all-gather", 2 * kv, again, act)
    t.device("all-gather", (4 if halves else 2) * kv, size=act)
    if again and halves:
        t.device("all-gather", 2 * kv, size=act)


def _kv_gathers(wk, cfg, rows: float, seq: int, plan, M: int, act: int, t: _Tally,
                again: bool) -> None:
    """The K/V gathers of a split of the positions at each layer of ``wk``
    (``data_parallel.gather_positions``): per microbatch and "pod"
    position, k and v [rows, seq, K, hd] gathered onto each of its
    ``plan.blocks`` pieces (one call each), reduce-scattered in the
    backward, and gathered again by each piece's recomputation where
    ``again``.  A device holds its KV heads' share."""
    main = _main(wk)
    layers = math.prod(main.shape[:-2])
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    whole = rows * seq * K * hd * act
    D, n = plan.blocks, plan.n
    groups = n // D
    heads = 1
    if isinstance(wk, ShardedTensor) and wk.axis == "model" and K % len(wk.pieces) == 0:
        heads = len(wk.pieces)
    for _ in range(2):                               # k, then v
        t.add("forward", "all-gather", whole * D, layers * M * groups, per=1.0 / groups,
              dev_nbytes=whole / heads, size=act)
        t.add("backward", "reduce-scatter", whole, layers * M * groups, per=1.0 / groups,
              dev_nbytes=whole / (D * heads), size=act)
        if again:
            t.add("backward", "all-gather", whole, layers * M * n, per=1.0 / n,
                  dev_nbytes=whole / heads, size=act)


def hlo_terms(params, cfg, step: TrainStep, report: Dict[str, Dict]) -> Dict[str, Dict]:
    """{name: {kind: bytes}}: what a CPU compile of the reference's step
    (``tools/torch_hlo_compare.py``: forced host devices, the dry run's
    activation split) holds per device beyond ``report["per_device"]``
    (``train_collectives``' figure for the same step), each from shapes,
    read from the compiled HLO of gemma2-2b (2 layers, 4 x 64 on a (2, 4)
    mesh, FSDP off and on).  Added to ``per_device`` in this order:

    - ``hlo_f32``: the CPU compile holds every floating collective in f32
      where the step's dtype is narrower (``report["widen"]``);
    - ``hlo_reduce_scatter_as_all_reduce``: it lowers a reduce-scatter (an
      FSDP split's gradient, a split of the positions' K/V gradients) to
      an all-reduce of the whole ("data" times the result, in f32);
    - ``tied_table_twice``: without FSDP it reduces a tied table's
      gradient twice, once for the lookup and once for the logits (the
      model shard in f32), where "model" splits the table or the
      positions go over "data" (whisper-base's replicated table, at batch
      1; at the default shape it reduces that table once); with FSDP and
      pods, its FSDP shard over "pod" twice (read from gemma2-2b's step on
      (2, 2, 2));
    - ``fsdp_backward_gather``: it gathers an FSDP-split weight a third
      time for the backward's products (each gathered layer, f32), the
      tied table's for the logits too;
    - ``lookup_all_to_all``: it looks an FSDP-split table up without
      gathering it (less the lookup's gather, f32), moving the rows
      [rows, d] in f32 by an all-to-all each way;
    - ``logits_gradient_gather`` (read from paligemma-3b's step, no final
      logit softcap): in place of the tied FSDP table's third gather, the
      backward gathers the logits' gradient over "data", [rows of the
      microbatch, text positions, the model shard of the vocabulary] in
      f32 (gemma2-2b's softcapped logits gather the table);
    - ``lookup_gradient_in_place`` (read from qwen2-moe-a2.7b's step, an
      untied FSDP table): the all-to-all of the lookup's rows brings each
      row's gradient to the table shard that holds it, so the table's
      gradient is not reduced (less its reduce-scatter as the CPU lowers
      it: "data" times the shard in f32);
    - ``lookup_gradient_in_stages`` (read from qwen2-moe-a2.7b's steps on
      (4, 2), (8, 2), (16, 2) and (2, 2, 2) and gemma2-2b's on (2, 2, 2),
      a table split over "model" without FSDP): where a microbatch's rows
      split over more than 2 dp positions it reduces the lookup's gradient
      (a scatter's) in two stages, over pairs of those positions and then
      across the pairs, the model shard in f32 once more a reduction;
    - ``lookup_scatter_gather``: under the activations' sequence split the
      scatter of the lookup's gradient into the vocab-split table gathers
      the rows' gradient over "model", 1.5 x [rows, d] in f32 (halves over
      one factor of the (2, 4) mesh's "model" axis, then whole over the
      other)."""
    mesh, plan = _step_split(params, cfg, step)
    terms: Dict[str, Dict[str, float]] = {"hlo_f32": dict(report["widen"])}
    if plan.by is None or _stationary(params, plan):
        return terms
    M = step.microbatches
    rs = report["per_device"].get("reduce-scatter", 0.0)
    if rs:
        f32 = rs * 4 / (4 if M > 1 else torch.empty((), dtype=cfg.dtype).element_size())
        terms["hlo_reduce_scatter_as_all_reduce"] = {
            "reduce-scatter": -f32, "all-reduce": f32 * mesh.shape["data"]}
    table = params.get("embed")
    fsdp_table = isinstance(table, ShardedTensor) and (_is_fsdp(table) or _is_fsdp(table.pieces[0]))
    shard = 0.0
    if isinstance(table, ShardedTensor) and _model_pieces(table) > 1:
        shard = math.prod(table.shape) * 4 / _model_pieces(table)
    if (cfg.tie_embeddings and not fsdp_table
            and (shard or (plan.by == "positions" and table is not None))):
        terms["tied_table_twice"] = {"all-reduce": (shard or math.prod(table.shape) * 4)
                                     * _apart(plan, M)}
    if cfg.tie_embeddings and fsdp_table and mesh.shape.get("pod", 1) > 1:
        terms["tied_table_twice"] = {"all-reduce": shard / mesh.shape["data"] * _apart(plan, M)}
    gather = sum(math.prod(leaf.shape) * 4 / _model_pieces(leaf)
                 for path, leaf in flatten_with_path(params)
                 if path[0] in _REMAT_ROOTS and isinstance(leaf, ShardedTensor)
                 and (_is_fsdp(leaf) or _is_fsdp(leaf.pieces[0]))) * M
    rows = step.batch / M / plan.blocks * step.seq_len
    if fsdp_table and not cfg.tie_embeddings and "hlo_reduce_scatter_as_all_reduce" in terms:
        terms["lookup_gradient_in_place"] = {"all-reduce": -shard}
    if shard and not fsdp_table and plan.blocks > 2:
        terms["lookup_gradient_in_stages"] = {"all-reduce": shard * _apart(plan, M)}
    if fsdp_table and cfg.tie_embeddings:
        terms["lookup_all_to_all"] = {"all-gather": -shard * M,
                                      "all-to-all": 2 * rows * cfg.d_model * 4 * M}
        if cfg.final_softcap:
            gather += shard * M
        else:
            terms["logits_gradient_gather"] = {
                "all-gather": step.batch / M * step.seq_len * table.shape[0] * 4
                / _model_pieces(table) * M}
    if gather:
        terms["fsdp_backward_gather"] = {"all-gather": gather}
    if _sequence_split(cfg, mesh, plan, step) and shard:
        terms["lookup_scatter_gather"] = {"all-gather": 1.5 * rows * cfg.d_model * 4 * M}
    return terms


def hlo_match(hlo: Dict[str, float], per_device: Dict[str, float],
              terms: Dict[str, Dict[str, float]], *, rtol: float = 0.02,
              floor: float = 0.01) -> Dict[str, Dict]:
    """Each collective kind of a compiled step's per-device HLO (``hlo``)
    beside ``per_device`` plus the named ``terms`` (:func:`hlo_terms`):
    {kind: {"hlo", "per_device", "terms", "sum", "rel_err", "status"}},
    ``status`` "matched" (the sum within ``rtol`` of the HLO's bytes),
    "unmatched" (both under ``floor`` of the HLO's total, listed, not
    held) or "differs"."""
    total = sum(hlo.values())
    kinds = set(hlo) | set(per_device) | {k for t in terms.values() for k in t}
    out = {}
    for k in sorted(kinds):
        h, p = hlo.get(k, 0.0), per_device.get(k, 0.0)
        extra = sum(t.get(k, 0.0) for t in terms.values())
        got = p + extra
        if max(h, got) < floor * total:
            status = "unmatched"
        else:
            status = "matched" if abs(got - h) <= rtol * h else "differs"
        out[k] = {"hlo": h, "per_device": p, "terms": extra, "sum": got,
                  "rel_err": (got - h) / h if h else None, "status": status}
    return out


def _attn_params(params, path):
    """The attention params that read the slot-state leaf at ``path``."""
    if path[0] == "shared_kv":
        return params["shared"]["attn"]
    if path[0] in ("self", "cross"):
        return params["dec_blocks"][path[1]]["attn" if path[0] == "self" else "xattn"]
    return params[path[0]][path[1]]["attn"]


def _cache_collectives(params, state, cfg, rows: int, act: int, t: _Tally,
                       share: float = 1.0) -> None:
    """What attention over a sharded slot state (``models/sharded_cache.py``)
    changes in a decode step's collectives, per use of each k leaf (a
    stacked leaf's layers, the hybrid's sites).  KV heads split: no
    gather of the q (and k/v) column pieces' outputs.  ``head_dim``
    split: the partial scores' all-reduce [rows, H, T] in f32 and the
    ``p @ v`` pieces' all-gather [rows, H, hd].  Slots over the data
    axes: the rows' attention outputs gathered [rows, H, hd]; likewise the
    heads where ``wo`` is not cut into the same pieces.  Outputs in the
    cache's dtype.  Positions over "data" (the sequence split, D pieces):
    the merge's gather of every piece's max [D, rows, H] and its sums of
    the denominators [rows, H] and of the pieces' outputs [rows, H, hd],
    all in f32.  A device holds ``share`` of the rows; XLA keeps the
    rows split over the data axes (their gathers are ``port_only``
    ``"slot_gathers"``)."""
    from repro_torch.models.sharded_cache import layout
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    _recurrent_collectives(params, state, cfg, rows, act, t, share)
    for path, leaf in flatten_with_path(state):
        if path[-1] != "k" or not isinstance(leaf, ShardedTensor):
            continue
        n_d, mdim, n_m, ddim = layout(leaf)
        uses = math.prod(leaf.shape[:-4])
        T, K = leaf.shape[-3], leaf.shape[-2]
        c_act = torch.empty((), dtype=leaf.dtype).element_size()
        heads = rows * H * hd * c_act
        if n_d > 1 and ddim == -4:
            t.add("forward", "all-gather", heads * uses, per=share, only="slot_gathers")
        if n_d > 1 and ddim == -3:
            t.add("forward", "all-gather", n_d * rows * H * 4 * uses, per=share)
            t.add("forward", "all-reduce", rows * H * (hd + 1) * 4 * uses, per=share)
        if mdim == -1:
            t.add("forward", "all-reduce", rows * H * T * 4 * uses, per=share)
            t.add("forward", "all-gather", heads * uses, per=share, size=c_act)
        else:
            if mdim == -2:
                qkv = H + (0 if path[0] == "cross" else 2 * K)
                t.add("forward", "all-gather", -rows * qkv * hd * act * uses, per=share,
                      only="column_outputs")
            wo = _attn_params(params, path)["wo"]
            if n_m > 1 and not (isinstance(wo, ShardedTensor) and wo.axis == "model"
                                and wo.dim == -2 and len(wo.pieces) == n_m):
                t.add("forward", "all-gather", heads * uses, per=share, size=c_act)


def _recurrent_collectives(params, state, cfg, rows: int, act: int, t: _Tally,
                           share: float = 1.0) -> None:
    """What a sharded recurrent state changes in a decode step's
    collectives (rwkv's ``_sharded_decode``, mamba's ``_sharded_decode``),
    per use of each leaf (a stacked leaf's layers).  A slot-split carry
    (rwkv ``tm_x``/``cm_x``, mamba ``conv``) is gathered over its slots
    [rows, ...] in its own dtype.  rwkv ``S`` split over heads: no gather
    of the r/k/v/g column pieces' outputs [rows, d]; the time mix's rows
    gathered over slots [rows, d], and its heads where ``wo`` is not cut
    into the same pieces.  mamba ``h``: ``y`` [rows, d_inner] in f32
    gathered once over slots and once over heads, where each splits.  A
    device holds ``share`` of the rows; the gathers over slots are
    ``port_only`` ``"slot_gathers"``."""
    from repro_torch.models.sharded_cache import head_layout
    for path, leaf in flatten_with_path(state):
        name = path[-1]
        if not isinstance(leaf, ShardedTensor) or name not in ("S", "h", "tm_x", "cm_x",
                                                                 "conv"):
            continue
        size = leaf.dtype.itemsize
        if name in ("tm_x", "cm_x", "conv"):
            rank = 2 if name != "conv" else 3
            each = rows * math.prod(leaf.shape[-rank + 1:]) * size
            t.add("forward", "all-gather", each * math.prod(leaf.shape[:-rank]), per=share,
                  only="slot_gathers")
            continue
        n_d, n_m = head_layout(leaf)
        uses = math.prod(leaf.shape[:-4])
        if name == "h":
            y = rows * leaf.shape[-3] * leaf.shape[-2] * 4
            t.add("forward", "all-gather", y * uses * (n_d > 1), per=share, only="slot_gathers")
            t.add("forward", "all-gather", y * uses * (n_m > 1), per=share)
            continue
        tm = params[path[0]][path[1]]["tm"]
        d = cfg.d_model
        if n_d > 1:
            t.add("forward", "all-gather", rows * d * act * uses, per=share, only="slot_gathers")
        if n_m > 1:
            t.add("forward", "all-gather", -sum(rows * tm[m].shape[-1] * act
                                                for m in ("wr", "wk", "wv", "wg")
                                                if isinstance(tm[m], ShardedTensor)) * uses,
                  per=share, only="column_outputs")
            wo = tm["wo"]
            if not (isinstance(wo, ShardedTensor) and wo.axis == "model" and wo.dim == -2
                    and len(wo.pieces) == n_m):
                t.add("forward", "all-gather", rows * d * act * uses, per=share, size=act)


def _main(w) -> torch.Tensor:
    """A sharded leaf's first piece's main tensor (its lead axes are the
    unsharded leaf's)."""
    while isinstance(w, ShardedTensor):
        w = w.pieces[0]
    if isinstance(w, (QTensor, QEmbed)):
        return w.q
    return w.w if isinstance(w, BlockSparseTensor) else w


def decode_step_cost(params, cfg, slots: int, max_len: int, state=None, *,
                     positions: Union[int, Sequence[int], None] = None) -> Roofline:
    """Analytic FLOPs and bytes of one decode step of ``slots`` rows (see
    the module docstring) as a one-card :class:`Roofline`.

    ``state`` is the engine's slot state (contiguous or paged), by default
    the contiguous cache of ``slots`` rows at ``max_len`` on the meta
    device.  ``positions`` (one count, or one per slot) are the cached
    positions each slot's step touches: at decode position p it reads the
    p before it and writes one, p + 1 in all; by default ``max_len``, every
    slot at the end of its context, the most a step touches.
    ``detail`` splits the bytes into ``weight_bytes``, ``state_read`` and
    ``state_written``.

    Where ``params`` were placed on a mesh (``shard_params``), or the
    state (slots over "pod" and "data" with nothing over "model"), they
    give the step's collective bytes (:func:`collective_bytes`, per kind in
    ``coll_detail``, over ``state``'s sharded k/v where a mesh engine's
    state is given) and ``chips`` the mesh's size; FLOPs and bytes stay
    the whole step's."""
    from repro_torch.models import api
    if state is None:
        state = api.init_cache(cfg, slots, max_len, compact_local=False, device="meta")
    sharded = [t for tree in (params, state) for _, t in flatten_with_path(tree)
               if isinstance(t, ShardedTensor)]
    coll = collective_bytes(params, cfg, slots, state) if sharded else {}
    weights = _weight_bytes(params, cfg, slots)
    st = _state_bytes(state, cfg, slots, max_len if positions is None else positions)
    flops = model_flops(cfg, ShapeSpec("decode_step", max_len, slots, "decode"))
    return Roofline(flops=flops, bytes_accessed=weights + st["state_read"] + st["state_written"],
                    coll_bytes=sum(coll.values()),
                    chips=sharded[0].mesh.size if sharded else 1,
                    coll_detail=coll, detail={"weight_bytes": weights, **st})


class _OnMeta(TorchFunctionMode):
    """Every factory call with a ``device`` lands on the meta device:
    shapes and dtypes without storage."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def _meta_block_sparse(tree, bs: int, density: float):
    """A block-sparse recipe's instance from shapes alone: every matrix
    the recipe compresses (the ``QTensor`` leaves of an int8 build of the
    same model) as a meta ``BlockSparseTensor`` keeping ``max(1,
    round(density * d_in / bs))`` input blocks per output block column
    (``core/sparsify.py`` ``block_sparse_mask``), or dense bf16 where bs
    does not divide it."""
    if isinstance(tree, dict):
        return {k: _meta_block_sparse(v, bs, density) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta_block_sparse(v, bs, density) for v in tree]
    if not isinstance(tree, QTensor):
        return tree
    *lead, K, N = tree.q.shape
    w = torch.empty((*lead, K, N), dtype=torch.bfloat16, device="meta")
    if K % bs or N % bs:
        return w
    keep = max(1, int(round(density * (K // bs))))
    mask = torch.empty((*lead, K // bs, N // bs), device="meta")
    idx = torch.empty((*lead, N // bs, keep), dtype=torch.int32, device="meta")
    return BlockSparseTensor(w, mask, bs, idx)


def meta_instance(cfg, recipe=None):
    """(params, cfg) of ``cfg``'s model, or of ``recipe`` applied to it,
    on the meta device: every shape and dtype at the published widths, no
    storage.  A block-sparse recipe's masks are drawn from weight values
    on the host, so its instance comes from :func:`_meta_block_sparse`."""
    from repro_torch.core.pipeline import InstanceOptimizer, Recipe
    from repro_torch.models import api
    with _OnMeta():
        params = api.init_params(torch.Generator(), cfg)
        if recipe is None:
            return params, cfg
        if recipe.block_bs and recipe.block_density < 1.0:
            if recipe.wbits < 16:
                raise NotImplementedError("block sparsity composed with quantization")
            q, out_cfg, _ = InstanceOptimizer(params, cfg).apply(
                Recipe(name="shapes", wbits=8, quant_method="absmax"))
            return _meta_block_sparse(q, recipe.block_bs, recipe.block_density), out_cfg
        out, out_cfg, _ = InstanceOptimizer(params, cfg).apply(recipe)
        return out, out_cfg


def decode_step_cost_shapes(cfg, slots: int, max_len: int, *, recipe=None,
                            positions: Union[int, Sequence[int], None] = None
                            ) -> Roofline:
    """:func:`decode_step_cost` from shapes alone, at any width: the model
    (or ``recipe``'s instance of it) and its contiguous slot state built
    on the meta device."""
    params, out_cfg = meta_instance(cfg, recipe)
    return decode_step_cost(params, out_cfg, slots, max_len, positions=positions)


# the models the port serves on one card, with their engines' max_len
SERVED = (("gemma2-2b", 1024), ("qwen2-moe-a2.7b", 1024), ("zamba2-7b", 1024),
          ("rwkv6-3b", 1024), ("paligemma-3b", 1024), ("whisper-base", 512),
          ("granite-20b", 1024))


def main() -> None:
    """Print each served model's decode-step byte floor at its published
    widths, bf16 and ``w8-absmax`` (and gemma2-2b's ``bs16@75``): 8 slots
    at the first decode position, from shapes alone.

        PYTHONPATH=src python -m repro_torch.launch.roofline
    """
    from repro_torch.configs import registry
    from repro_torch.core.pipeline import Recipe
    recipes = {"bf16": None, "w8-absmax": Recipe(name="w8-absmax", wbits=8,
                                                 quant_method="absmax")}
    for arch, max_len in SERVED:
        cfg = registry.get_config(arch)
        if arch == "gemma2-2b":
            recipes["bs16@75"] = Recipe(name="bs16@75", block_bs=16, block_density=0.75)
        for name, recipe in recipes.items():
            c = decode_step_cost_shapes(cfg, 8, max_len, recipe=recipe, positions=1)
            print(f"{arch} {name}: {c.t_memory * 1e3:.4f} ms, weights "
                  f"{c.detail['weight_bytes']:.0f} B, state read {c.detail['state_read']:.0f} "
                  f"B, written {c.detail['state_written']:.0f} B", flush=True)
        recipes.pop("bs16@75", None)


if __name__ == "__main__":
    main()
