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
from repro_torch.tree import flatten_with_path

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


def _gathers(w, lead: int, act: int, out: Dict[str, float]) -> None:
    """Add one use of ``w`` on ``lead`` activation rows to ``out``: a
    column-sharded weight's all-gather of its output [lead, d_out], a
    row-sharded one's all-reduce of it, an expert stack's all-gather of
    [E, C, d_out] (``lead`` = E * C), each in the activation's ``act``
    bytes, and its pieces' own collectives."""
    if not isinstance(w, ShardedTensor):
        return
    kind = "all-reduce" if w.dim == -2 else "all-gather"
    out[kind] = out.get(kind, 0.0) + lead * w.shape[-1] * act
    for p in w.pieces:
        share = lead * _experts(p) // _experts(w) if w.dim == -3 else lead
        _gathers(p, share, act, out)


def _experts(w) -> int:
    if isinstance(w, ShardedTensor):
        return (sum(_experts(p) for p in w.pieces) if w.dim == -3
                else _experts(w.pieces[0]))
    return (w.q if isinstance(w, QTensor) else w).shape[-3]


def collective_bytes(params, cfg, rows: int, state=None) -> Dict[str, float]:
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
    runs."""
    from repro_torch.models.layers import moe_capacity
    act = torch.empty((), dtype=cfg.dtype).element_size()
    out: Dict[str, float] = {}
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
            out["all-reduce"] = out.get("all-reduce", 0.0) + rows * leaf.shape[-1] * size
            if cfg.tie_embeddings:
                out["all-gather"] = out.get("all-gather", 0.0) + rows * leaf.shape[-2] * 4
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
        one: Dict[str, float] = {}
        _gathers(leaf, lead, act, one)
        for k, v in one.items():
            out[k] = out.get(k, 0.0) + v * uses
    if state is not None:
        _cache_collectives(params, state, cfg, rows, act, out)
    return out


def _attn_params(params, path):
    """The attention params that read the slot-state leaf at ``path``."""
    if path[0] == "shared_kv":
        return params["shared"]["attn"]
    if path[0] in ("self", "cross"):
        return params["dec_blocks"][path[1]]["attn" if path[0] == "self" else "xattn"]
    return params[path[0]][path[1]]["attn"]


def _cache_collectives(params, state, cfg, rows: int, act: int, out: Dict[str, float]) -> None:
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
    all in f32."""
    from repro_torch.models.sharded_cache import layout
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    _recurrent_collectives(params, state, cfg, rows, act, out)
    for path, leaf in flatten_with_path(state):
        if path[-1] != "k" or not isinstance(leaf, ShardedTensor):
            continue
        n_d, mdim, n_m, ddim = layout(leaf)
        uses = math.prod(leaf.shape[:-4])
        T, K = leaf.shape[-3], leaf.shape[-2]
        c_act = torch.empty((), dtype=leaf.dtype).element_size()
        heads = rows * H * hd * c_act
        gather = heads if n_d > 1 and ddim == -4 else 0.0
        if n_d > 1 and ddim == -3:
            gather += n_d * rows * H * 4
            out["all-reduce"] = out.get("all-reduce", 0.0) + rows * H * (hd + 1) * 4 * uses
        if mdim == -1:
            out["all-reduce"] = out.get("all-reduce", 0.0) + rows * H * T * 4 * uses
            gather += heads
        else:
            if mdim == -2:
                qkv = H + (0 if path[0] == "cross" else 2 * K)
                out["all-gather"] = out.get("all-gather", 0.0) - rows * qkv * hd * act * uses
            wo = _attn_params(params, path)["wo"]
            if n_m > 1 and not (isinstance(wo, ShardedTensor) and wo.axis == "model"
                                and wo.dim == -2 and len(wo.pieces) == n_m):
                gather += heads
        if gather:
            out["all-gather"] = out.get("all-gather", 0.0) + gather * uses


def _recurrent_collectives(params, state, cfg, rows: int, act: int,
                           out: Dict[str, float]) -> None:
    """What a sharded recurrent state changes in a decode step's
    collectives (rwkv's ``_sharded_decode``, mamba's ``_sharded_decode``),
    per use of each leaf (a stacked leaf's layers).  A slot-split carry
    (rwkv ``tm_x``/``cm_x``, mamba ``conv``) is gathered over its slots
    [rows, ...] in its own dtype.  rwkv ``S`` split over heads: no gather
    of the r/k/v/g column pieces' outputs [rows, d]; the time mix's rows
    gathered over slots [rows, d], and its heads where ``wo`` is not cut
    into the same pieces.  mamba ``h``: ``y`` [rows, d_inner] in f32
    gathered once over slots and once over heads, where each splits."""
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
            out["all-gather"] = out.get("all-gather", 0.0) + each * math.prod(
                leaf.shape[:-rank])
            continue
        n_d, n_m = head_layout(leaf)
        uses = math.prod(leaf.shape[:-4])
        if name == "h":
            y = rows * leaf.shape[-3] * leaf.shape[-2] * 4
            out["all-gather"] = out.get("all-gather", 0.0) + y * uses * (
                (n_d > 1) + (n_m > 1))
            continue
        tm = params[path[0]][path[1]]["tm"]
        d = cfg.d_model
        gather = rows * d * act if n_d > 1 else 0.0
        if n_m > 1:
            gather -= sum(rows * tm[n].shape[-1] * act for n in ("wr", "wk", "wv", "wg")
                          if isinstance(tm[n], ShardedTensor))
            wo = tm["wo"]
            if not (isinstance(wo, ShardedTensor) and wo.axis == "model" and wo.dim == -2
                    and len(wo.pieces) == n_m):
                gather += rows * d * act
        out["all-gather"] = out.get("all-gather", 0.0) + gather * uses


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
