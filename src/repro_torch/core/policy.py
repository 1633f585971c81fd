"""Recipe search: the IOLM-DB-Perf and IOLM-DB-Acc variants of a query.

The paper evaluates two instance-optimized variants per workload: *Perf*
(highest throughput) and *Acc* (highest accuracy, normalized against the
uncompressed baseline = 1).  This module enumerates a family-aware recipe
grid, compresses with each recipe, scores every candidate by

  - accuracy  = agreement with the BASELINE model's greedy outputs on
    held-out rows (exact match of the decodes, the paper's normalization)
  - cost      = measured rows/s of that greedy decode, plus the
    parameter bytes

and picks argmax-throughput above an accuracy floor (Perf) and
argmax-accuracy with a bytes tie-break (Acc).

``greedy_decode`` runs eagerly over the contiguous cache
(``models.api.decode_step``); under the scoped kernel backend its
compressed linears run the int8 (K2) or block-sparse (K4) kernel on the
card.  ``search`` skips a recipe only when it does not apply to the
model (``NotImplementedError`` or ``ValueError`` from the pipeline);
every other error, a kernel that fails to build or launch included,
propagates.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.compressed import param_bytes
from repro_torch.core.pipeline import InstanceOptimizer, Recipe

# what a recipe that does not apply to the model raises (prune, pipeline,
# quantize); anything else is a fault and propagates out of ``search``
INAPPLICABLE = (NotImplementedError, ValueError)


# ---------------------------------------------------------------------------
# recipe space
# ---------------------------------------------------------------------------

def default_recipe_space(cfg, *, aggressive: bool = True) -> List[Recipe]:
    """Family-aware candidate grid, ordered roughly mild -> aggressive."""
    rs: List[Recipe] = [
        Recipe(name="w8-gptq", wbits=8, quant_method="gptq"),
        Recipe(name="w8-absmax", wbits=8, quant_method="absmax"),
        Recipe(name="w8-smooth", wbits=8, smooth_alpha=0.5),
        Recipe(name="w8-24", wbits=8, nm=(2, 4)),
        Recipe(name="w4-gptq", wbits=4, group=64),
    ]
    if aggressive:
        rs += [
            Recipe(name="w8-ffn75", wbits=8, ffn_keep_frac=0.75),
            Recipe(name="w8-24-ffn75", wbits=8, nm=(2, 4), ffn_keep_frac=0.75),
            Recipe(name="w4-24", wbits=4, group=64, nm=(2, 4)),
        ]
        if cfg.family != "rwkv" and cfg.n_kv_heads >= 2:
            rs.append(Recipe(name="w8-kv50", wbits=8, kv_keep_frac=0.5))
        if cfg.family == "moe":
            keep = max(cfg.top_k, cfg.n_experts // 2)
            rs.append(Recipe(name="w8-expert50", wbits=8, experts_keep=keep))
            rs.append(Recipe(name="w8-expert25", wbits=8,
                             experts_keep=max(cfg.top_k, cfg.n_experts // 4)))
    return rs


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def greedy_decode(params, cfg, prompts: torch.Tensor, max_new: int,
                  *, lengths=None) -> np.ndarray:
    """Greedy generation for a [B, S] right-padded prompt batch.

    ``lengths`` [B]: true prompt lengths (defaults to S).  First-token
    logits are gathered at each row's last REAL position and decode
    positions advance per row.  Returns the [B, max_new] tokens on the
    host (which waits for the device).
    """
    from repro_torch.models import api
    B, S = prompts.shape
    dev = prompts.device
    lengths = (torch.full((B,), S, dtype=torch.long, device=dev) if lengths is None
               else torch.as_tensor(lengths, device=dev).long())
    max_len = S + max_new
    with torch.no_grad():
        logits, cache = api.prefill(params, cfg, {"tokens": prompts},
                                    max_len=max_len, compact_local=False)
        last = logits[torch.arange(B, device=dev), lengths - 1]
        tok = last.argmax(-1)[:, None]
        outs = [tok]
        for t in range(max_new - 1):
            lg, cache = api.decode_step(params, cfg, cache, tok, lengths + t,
                                        max_len=max_len)
            tok = lg[:, -1].argmax(-1)[:, None]
            outs.append(tok)
        return torch.cat(outs, dim=1).to(torch.int32).cpu().numpy()


@dataclass
class EvalResult:
    accuracy: float          # exact-match agreement with baseline
    token_agreement: float   # per-token agreement (softer signal)
    rows_per_s: float
    bytes: int
    cost_proxy: float        # analytic decode cost (bytes/token moved)


def make_agreement_eval(base_params, base_cfg, prompts, *, max_new: int = 16,
                        lengths=None) -> Callable:
    """Returns eval_fn(params, cfg) scoring agreement vs the baseline.

    ``rows_per_s`` is wall time of one ``greedy_decode``: the device is
    synchronized before the clock starts (the host copy of the tokens
    waits for it at the end), and on the card the kernels are built
    here, before any candidate is timed."""
    prompts = torch.as_tensor(prompts)
    cuda = prompts.device.type == "cuda"
    if cuda:
        from repro_torch.kernels import build
        build.build_all()
    ref = greedy_decode(base_params, base_cfg, prompts, max_new, lengths=lengths)

    def eval_fn(params, cfg) -> EvalResult:
        if cuda:
            torch.cuda.synchronize(prompts.device)
        t0 = time.time()
        out = greedy_decode(params, cfg, prompts, max_new, lengths=lengths)
        dt = time.time() - t0
        exact = float(np.mean(np.all(out == ref, axis=1)))
        tok = float(np.mean(out == ref))
        nbytes = param_bytes(params)
        return EvalResult(accuracy=exact, token_agreement=tok,
                          rows_per_s=prompts.shape[0] / max(dt, 1e-9),
                          bytes=nbytes, cost_proxy=float(nbytes))
    return eval_fn


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

@dataclass
class Candidate:
    recipe: Recipe
    result: EvalResult
    report: Any
    params: Any = None
    cfg: Any = None


@dataclass
class SearchOutcome:
    baseline: EvalResult
    candidates: List[Candidate]
    perf: Optional[Candidate]
    acc: Optional[Candidate]

    def table(self) -> str:
        rows = [f"{'recipe':24s} {'acc':>5s} {'tok':>5s} {'rows/s':>8s} "
                f"{'MB':>8s}"]
        rows.append(f"{'baseline':24s} {self.baseline.accuracy:5.2f} "
                    f"{self.baseline.token_agreement:5.2f} "
                    f"{self.baseline.rows_per_s:8.2f} "
                    f"{self.baseline.bytes / 1e6:8.1f}")
        for c in self.candidates:
            tag = ""
            if self.perf is c:
                tag += " <- Perf"
            if self.acc is c:
                tag += " <- Acc"
            rows.append(f"{c.recipe.name:24s} {c.result.accuracy:5.2f} "
                        f"{c.result.token_agreement:5.2f} "
                        f"{c.result.rows_per_s:8.2f} "
                        f"{c.result.bytes / 1e6:8.1f}{tag}")
        return "\n".join(rows)


def search(optimizer: InstanceOptimizer, eval_fn: Callable,
           recipes: List[Recipe], *, acc_floor: float = 0.9,
           keep_params: bool = False) -> SearchOutcome:
    """Compress with every recipe, evaluate, select Perf/Acc variants.
    A recipe that does not apply to the model (``INAPPLICABLE``) is
    skipped; any other error propagates."""
    baseline = eval_fn(optimizer.params, optimizer.cfg)
    cands: List[Candidate] = []
    for r in recipes:
        try:
            params2, cfg2, report = optimizer.apply(r)
        except INAPPLICABLE:
            continue
        res = eval_fn(params2, cfg2)
        cands.append(Candidate(recipe=r, result=res, report=report,
                               params=params2 if keep_params else None,
                               cfg=cfg2))
    perf = acc = None
    ok = [c for c in cands if c.result.accuracy >= acc_floor]
    pool = ok or cands
    if pool:
        perf = max(pool, key=lambda c: (c.result.rows_per_s, -c.result.bytes))
        acc = max(cands, key=lambda c: (c.result.accuracy,
                                        c.result.token_agreement,
                                        -c.result.bytes))
    return SearchOutcome(baseline=baseline, candidates=cands, perf=perf, acc=acc)
