"""The instance-optimization pipeline.

``InstanceOptimizer`` turns a (params, config) pair plus a calibration
sample into a compressed, query-specialized model:

    opt = InstanceOptimizer(params, cfg)
    opt.run_calibration({"tokens": sample})
    new_params, new_cfg, report = opt.apply(Recipe(...))

Stages (paper §3.2), in order:
  1. structural pruning: layer drop, KV-group prune, FFN-channel prune,
     expert prune (MoE), driven by calibration statistics (``prune.py``);
     ``experts_keep`` is a no-op on dense configs, as in the reference;
  2. sparsification: SparseGPT / Wanda masks (N:M or unstructured), or
     block sparsity (whole tiles skipped by the block-sparse kernel);
  3. quantization: GPTQ / absmax int8 or int4, group-wise scales,
     optional SmoothQuant; masks from stage 2 are respected inside the
     GPTQ sweep.

Without calibration statistics a ``gptq`` recipe quantizes with absmax
and masks score with unit activation norms, as in the reference.
``quant_embed`` then replaces the embedding table with a per-row int8
``QEmbed`` (after every prune: the table is never pruned), counted in
``Report`` as the reference counts it (codes plus scales).  A
layer-stacked block-sparse weight keeps its gather indices per layer, so
the kernel runs on every block-sparse linear.  An MoE expert stack is
compressed one expert matrix at a time, each with its own statistics
(its rows' norms and Hessian), and stacked back over experts, then
layers: ``q`` [R, E, K, N], ``scale`` [R, E, K/g, N], ``in_scale``
[R, E, K].  The hybrid's Mamba groups are stacked back over both of
their axes, ``q`` [G, K, d_in, d_out], as in the reference, and the
shared block is compressed once for all of its sites.  rwkv's one
layer stack compresses as the dense ``blocks`` do (its stats keys
``blocks.0.r.tm.wr``); its decay LoRA ``tm.wa1``/``tm.wa2``, mixes, decay
and bonus vectors and groupnorm ``tm.gn`` are not in ``_COMPRESS_NAMES``
and stay plain, and ``kv_keep_frac`` leaves it as it is (no attention:
``prune_kv_groups`` returns it unchanged).  A vlm compresses as the dense
stack does.  encdec's unrolled ``enc_blocks`` and ``dec_blocks`` have no
stacked axis (stack depth 0): each weight is compressed on its own, its
stats key its tree path (``dec_blocks.3.xattn.wq``), and its untied
``unembed`` is quantized like any other linear.
:func:`needs_hessian` says which recipes read a Hessian, so that a search
over none of them calibrates without one.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import calibrate as C
from repro_torch.core import prune as P
from repro_torch.core import quantize as Q
from repro_torch.core import sparsify as S
from repro_torch.core.compressed import (BlockSparseTensor, QEmbed, QTensor, pack_int4,
                                         param_bytes, quantize_embed)


@dataclass(frozen=True)
class Recipe:
    """One point in the compression design space."""
    name: str = "recipe"
    # --- structural ---
    drop_units: int = 0
    kv_keep_frac: float = 1.0
    ffn_keep_frac: float = 1.0
    experts_keep: int = 0
    # --- sparsity ---
    sparsity: float = 0.0
    nm: Tuple[int, int] = (0, 0)
    sparse_method: str = "sparsegpt"
    block_bs: int = 0
    block_density: float = 1.0
    # --- quantization ---
    wbits: int = 16
    group: int = 128
    quant_method: str = "gptq"
    smooth_alpha: float = 0.0
    quant_embed: bool = False

    def describe(self) -> str:
        parts = []
        if self.drop_units:
            parts.append(f"drop{self.drop_units}u")
        if self.kv_keep_frac < 1:
            parts.append(f"kv{self.kv_keep_frac:.2f}")
        if self.ffn_keep_frac < 1:
            parts.append(f"ffn{self.ffn_keep_frac:.2f}")
        if self.experts_keep:
            parts.append(f"E{self.experts_keep}")
        if self.nm[1]:
            parts.append(f"{self.nm[0]}:{self.nm[1]}")
        elif self.sparsity:
            parts.append(f"sp{self.sparsity:.2f}")
        if self.block_bs:
            parts.append(f"bs{self.block_bs}@{self.block_density:.2f}")
        if self.wbits < 16:
            parts.append(f"w{self.wbits}g{self.group}:{self.quant_method}")
        if self.smooth_alpha:
            parts.append(f"sq{self.smooth_alpha}")
        return "+".join(parts) or "identity"


_COMPRESS_NAMES = frozenset({
    "wq", "wk", "wv", "wo", "wi", "wg", "wr", "unembed",
    "in_proj", "out_proj",
})

def _leaf_name(path: str) -> str:
    return path.rsplit(".", 1)[-1]


def _is_target(path: str, leaf) -> bool:
    if isinstance(leaf, (QTensor, BlockSparseTensor)) \
            or _leaf_name(path) not in _COMPRESS_NAMES:
        return False
    return getattr(leaf, "ndim", 0) >= 2


def _stack_depth(cfg, path: str) -> int:
    """Leading stacked-layer axes of a param subtree: ``blocks`` (dense,
    MoE, vlm, rwkv) and the hybrid's ``mamba_tail`` one, its
    ``mamba_groups`` two ([G, K, ...]); encdec's unrolled lists none."""
    if cfg.family == "hybrid":
        return {"mamba_groups": 2, "mamba_tail": 1}.get(path.split(".")[0], 0)
    return 1 if path.startswith("blocks.") else 0


def _is_expert(path: str) -> bool:
    return ".moe." in f".{path}." and _leaf_name(path) in ("wi", "wg", "wo")


def needs_hessian(recipe: Recipe) -> bool:
    """Whether ``apply(recipe)`` reads calibration Hessians: GPTQ
    quantization and SparseGPT sparsification do; absmax, Wanda, block
    sparsity and the structural prunes read norms and routing only."""
    gptq = recipe.wbits < 16 and recipe.quant_method == "gptq"
    sparsegpt = bool(recipe.nm[1] or recipe.sparsity) and recipe.sparse_method == "sparsegpt"
    return gptq or sparsegpt


def _stats_key(path: str, idx: Tuple[int, ...]) -> str:
    """Calibration key of the layer at stack indices ``idx`` of a leaf:
    ``blocks.u.attn.wq`` -> ``blocks.u.r.attn.wq``,
    ``mamba_groups.in_proj`` -> ``mamba_groups.g.k.in_proj``,
    ``mamba_tail.in_proj`` -> ``mamba_tail.i.in_proj``."""
    if not idx:
        return path
    parts = path.split(".")
    head = 2 if parts[0] == "blocks" else 1
    return ".".join(parts[:head] + [str(i) for i in idx] + parts[head:])


@dataclass
class Report:
    recipe: Recipe
    bytes_before: int
    bytes_after: int
    params_before: int
    params_after: int
    seconds: float
    per_weight: List[Dict[str, Any]]
    cfg_before: Any = None
    cfg_after: Any = None

    @property
    def compression(self) -> float:
        return self.bytes_before / max(self.bytes_after, 1)

    def summary(self) -> str:
        return (f"[{self.recipe.name}] {self.recipe.describe()}: "
                f"{self.bytes_before / 1e6:.1f} MB -> "
                f"{self.bytes_after / 1e6:.1f} MB "
                f"({self.compression:.2f}x) in {self.seconds:.1f}s")


def _param_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_param_count(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_param_count(v) for v in tree)
    if isinstance(tree, QTensor):
        return tree.q.numel() * (2 if tree.bits == 4 else 1)
    if isinstance(tree, BlockSparseTensor):
        return int(tree.w.numel() * tree.density())
    if isinstance(tree, QEmbed):                  # the reference counts both arrays
        return tree.q.numel() + tree.scale.numel()
    return 0 if tree is None else tree.numel()


def _stack(items):
    """Stack per-layer compression results along a new axis 0."""
    first = items[0]
    if isinstance(first, QTensor):
        ins = (None if first.in_scale is None
               else torch.stack([it.in_scale for it in items]))
        return QTensor(torch.stack([it.q for it in items]),
                       torch.stack([it.scale for it in items]),
                       first.bits, first.group, first.shape[-2:], ins)
    if isinstance(first, BlockSparseTensor):
        return BlockSparseTensor(torch.stack([it.w for it in items]),
                                 torch.stack([it.mask for it in items]), first.bs,
                                 torch.stack([it.idx for it in items]))
    return torch.stack(items)


def _expert_stats(st, e: int):
    """Expert ``e``'s statistics of a stacked expert weight: its own row
    count (not the sum over experts, which would deflate a lightly routed
    expert's norms), Hessian, norms and maxima."""
    if st is None or st.sqnorm is None:
        return None
    count = int(st.count_e[e].item()) if st.count_e is not None else st.count
    return C.WeightStats(shape=tuple(st.shape[1:]), count=count,
                         H=None if st.H is None else st.H[e],
                         sqnorm=st.sqnorm[e], amax=st.amax[e])


class InstanceOptimizer:
    """Generates a query-specialized compressed model (the paper's core)."""

    def __init__(self, params, cfg):
        self.params = params
        self.cfg = cfg
        self.stats: Optional[C.CalibStats] = None

    def run_calibration(self, batch: Dict[str, Any], *, hessian: bool = True):
        self.stats = C.calibrate(self.params, self.cfg, batch, hessian=hessian)
        return self.stats

    def apply(self, recipe: Recipe):
        t0 = time.time()
        if self.stats is None:
            self.stats = C.CalibStats({}, {}, 0)
        params, cfg, stats = self.params, self.cfg, self.stats

        # 1. structural
        if recipe.drop_units:
            params, cfg, stats = P.drop_layers(params, cfg, stats, recipe.drop_units)
        if recipe.kv_keep_frac < 1.0:
            keep = max(1, int(round(recipe.kv_keep_frac * cfg.n_kv_heads)))
            params, cfg, stats = P.prune_kv_groups(params, cfg, stats, keep)
        if recipe.ffn_keep_frac < 1.0:
            params, cfg, stats = P.prune_ffn(params, cfg, stats, recipe.ffn_keep_frac)
        if recipe.experts_keep and cfg.family == "moe":
            params, cfg, stats = P.prune_experts(params, cfg, stats, recipe.experts_keep)

        # 2+3. sparsify + quantize, per weight
        per_weight: List[Dict[str, Any]] = []
        if (recipe.wbits < 16 or recipe.sparsity or recipe.nm[1]
                or recipe.block_bs):
            with torch.no_grad():
                params = self._compress(params, cfg, stats, recipe, per_weight, "")
        if recipe.quant_embed:
            with torch.no_grad():
                params = {**params, "embed": quantize_embed(params["embed"])}
        report = Report(recipe=recipe, bytes_before=param_bytes(self.params),
                        bytes_after=param_bytes(params),
                        params_before=_param_count(self.params),
                        params_after=_param_count(params),
                        seconds=time.time() - t0, per_weight=per_weight,
                        cfg_before=self.cfg, cfg_after=cfg)
        return params, cfg, report

    def _compress(self, tree, cfg, stats, recipe, per_weight, path):
        if isinstance(tree, dict):
            return {k: self._compress(v, cfg, stats, recipe, per_weight,
                                      f"{path}.{k}" if path else str(k))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [self._compress(v, cfg, stats, recipe, per_weight,
                                   f"{path}.{i}" if path else str(i))
                    for i, v in enumerate(tree)]
        if not _is_target(path, tree):
            return tree

        def one(w, st, log):
            if not _is_expert(path):
                return self._one_matrix(w, recipe, st, path, per_weight, log=log)
            return _stack([self._one_matrix(w[e], recipe, _expert_stats(st, e), path,
                                            per_weight, log=log and e == 0)
                           for e in range(w.shape[0])])

        def stacked(w, depth, idx):
            if depth == 0:
                return one(w, stats.get(_stats_key(path, idx)), not any(idx))
            return _stack([stacked(w[r], depth - 1, idx + (r,))
                           for r in range(w.shape[0])])

        return stacked(tree, _stack_depth(cfg, path), ())

    @staticmethod
    def _one_matrix(w, recipe: Recipe, st, path, per_weight, log=False):
        """Sparsify and quantize one [d_in, d_out] matrix."""
        d_in, d_out = w.shape
        H = st.H if st is not None else None
        act_norm = (st.merge_norm() if st is not None and st.sqnorm is not None
                    else torch.ones(d_in, dtype=torch.float32, device=w.device))
        amax = st.amax if st is not None else None
        mask = None
        entry = {"path": path, "shape": (d_in, d_out)}
        w = w.float()

        # block sparsity: a container of its own, the kernel skips tiles
        bs = recipe.block_bs
        if bs and recipe.block_density < 1.0 and d_in % bs == 0 and d_out % bs == 0:
            bmask = S.block_sparse_mask(w, bs=bs, density=recipe.block_density,
                                        act_norm=act_norm)
            if recipe.wbits >= 16:
                if log:
                    entry["kind"] = f"block_sparse@{recipe.block_density}"
                    per_weight.append(entry)
                return S.apply_block_mask(w, bmask, bs)
            # compose: zero the tiles, then quantize below
            mask = S.expand_block_mask(bmask, bs, w.device)
            w = w * mask

        # fine-grained sparsity (size reduction; composes with quantization)
        n, m = recipe.nm
        if (m or recipe.sparsity) and mask is None:
            if recipe.sparse_method == "sparsegpt" and H is not None:
                w, mask = S.sparsegpt_prune(w, H, sparsity=recipe.sparsity, n=n, m=m)
            else:
                mask = S.wanda_mask(w, act_norm, sparsity=recipe.sparsity, n=n, m=m)
                w = torch.where(mask, w, torch.zeros((), device=w.device))

        if recipe.wbits < 16:
            alpha = recipe.smooth_alpha
            if recipe.quant_method == "gptq" and H is not None:
                qt = Q.gptq_quantize(w, H, bits=recipe.wbits, group=recipe.group,
                                     amax_x=amax, smooth_alpha=alpha, mask=mask)
            else:
                qt = Q.absmax_quantize(w, bits=recipe.wbits, group=recipe.group,
                                       amax_x=amax, smooth_alpha=alpha)
                if mask is not None:
                    codes = torch.where(mask, qt.unpack(),
                                        torch.zeros((), dtype=torch.int8, device=w.device))
                    qt = QTensor(pack_int4(codes) if recipe.wbits == 4 else codes,
                                 qt.scale, qt.bits, qt.group, qt.shape, qt.in_scale)
            if log:
                entry["kind"] = f"quant w{recipe.wbits}"
                per_weight.append(entry)
            return qt
        if mask is not None and log:
            entry["kind"] = "sparse (dense container)"
            per_weight.append(entry)
        return w.to(torch.bfloat16)
