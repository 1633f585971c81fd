"""The instance-optimization pipeline (quantization stage).

``InstanceOptimizer`` turns a (params, config) pair into a compressed
model:

    opt = InstanceOptimizer(params, cfg)
    new_params, new_cfg, report = opt.apply(Recipe(...))

This slice ports the recipe space's weight quantization without
calibration: absmax int8/int4 with group-wise scales, on the same leaf
selection as the reference.  Without calibration statistics a ``gptq``
recipe quantizes with absmax, as the reference does when it has no
Hessian.  Structural pruning, sparsity, block sparsity, calibrated GPTQ
and embedding quantization raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core import quantize as Q
from repro_torch.core.compressed import QTensor, param_bytes


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

_PRUNING = "ROADMAP queue 1 item 5 (core/prune.py)"
_SPARSITY = "ROADMAP queue 1 item 5 (core/sparsify.py)"
_BLOCK_SPARSE = "ROADMAP queue 2 K4 (block_sparse_matmul)"
_CALIBRATION = "ROADMAP queue 1 item 5 (core/calibrate.py, GPTQ)"
_QEMBED = "ROADMAP queue 1 item 2 (QEmbed)"


def _unported(recipe: Recipe) -> None:
    checks = [
        (recipe.drop_units, "drop_units", _PRUNING),
        (recipe.kv_keep_frac < 1.0, "kv_keep_frac", _PRUNING),
        (recipe.ffn_keep_frac < 1.0, "ffn_keep_frac", _PRUNING),
        (recipe.experts_keep, "experts_keep", _PRUNING),
        (recipe.sparsity or recipe.nm[1], "sparsity/nm", _SPARSITY),
        (recipe.block_bs, "block_bs", _BLOCK_SPARSE),
        (recipe.quant_embed, "quant_embed", _QEMBED),
    ]
    for hit, field, item in checks:
        if hit:
            raise NotImplementedError(
                f"Recipe.{field} is not ported yet: {item}")


def _leaf_name(path: str) -> str:
    return path.rsplit(".", 1)[-1]


def _is_target(path: str, leaf) -> bool:
    if isinstance(leaf, QTensor) or _leaf_name(path) not in _COMPRESS_NAMES:
        return False
    return getattr(leaf, "ndim", 0) >= 2


def _stack_depth(cfg, path: str) -> int:
    """Leading stacked-layer axes of a param subtree (dense family)."""
    return 1 if path.startswith("blocks.") else 0


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
    return tree.numel()


def _stack_q(items: List[QTensor]) -> QTensor:
    first = items[0]
    ins = (None if first.in_scale is None
           else torch.stack([it.in_scale for it in items]))
    return QTensor(torch.stack([it.q for it in items]),
                   torch.stack([it.scale for it in items]),
                   first.bits, first.group, first.shape[-2:], ins)


class InstanceOptimizer:
    """Generates a query-specialized compressed model (the paper's core)."""

    def __init__(self, params, cfg):
        self.params = params
        self.cfg = cfg

    def run_calibration(self, batch):
        raise NotImplementedError(f"calibration is not ported yet: {_CALIBRATION}")

    def apply(self, recipe: Recipe):
        _unported(recipe)
        if self.cfg.family != "dense":
            raise NotImplementedError(
                f"family {self.cfg.family!r} is not ported yet (ROADMAP queue 1 item 9)")
        t0 = time.time()
        params = self.params
        per_weight: List[Dict[str, Any]] = []
        if recipe.wbits < 16:
            params = self._compress(params, recipe, per_weight, "")
        report = Report(recipe=recipe, bytes_before=param_bytes(self.params),
                        bytes_after=param_bytes(params),
                        params_before=_param_count(self.params),
                        params_after=_param_count(params),
                        seconds=time.time() - t0, per_weight=per_weight,
                        cfg_before=self.cfg, cfg_after=self.cfg)
        return params, self.cfg, report

    def _compress(self, tree, recipe, per_weight, path):
        if isinstance(tree, dict):
            return {k: self._compress(v, recipe, per_weight,
                                      f"{path}.{k}" if path else str(k))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [self._compress(v, recipe, per_weight,
                                   f"{path}.{i}" if path else str(i))
                    for i, v in enumerate(tree)]
        if not _is_target(path, tree):
            return tree
        log = {"path": path, "shape": tuple(tree.shape[-2:]),
               "kind": f"quant w{recipe.wbits}"}
        per_weight.append(log)
        if _stack_depth(self.cfg, path) == 0:
            return self._one_matrix(tree, recipe)
        return _stack_q([self._one_matrix(tree[r], recipe)
                         for r in range(tree.shape[0])])

    @staticmethod
    def _one_matrix(w, recipe: Recipe) -> QTensor:
        return Q.absmax_quantize(w, bits=recipe.wbits, group=recipe.group)
