"""Calibration: per-weight activation statistics from a data sample.

The paper (§3.2) tunes quantization parameters and pruning thresholds on
calibration data, small unlabeled samples of the query's input domain.
This module runs the model layer by layer on such a sample and collects,
per weight matrix:

  - ``H``       Gram matrix X^T X of the layer's inputs (GPTQ, SparseGPT)
  - ``sqnorm``  per-input-channel sum x^2 (the Wanda metric)
  - ``amax``    per-input-channel max |x| (SmoothQuant scales)
  - ``count``   number of observed rows
  - ``count_e`` (MoE expert stacks) rows each expert received; ``H``,
                ``sqnorm`` and ``amax`` then carry the expert axis first
  - ``route_count``, ``route_prob`` (MoE routers) per-expert dispatch
                counts and mean router probabilities: the signal of
                expert pruning for this query's data

plus the cosine similarity of each block's input and output (layer-drop
scores; a block visited more than once, the hybrid's shared block at
each of its sites, averages its visits, and its weights' statistics
accumulate over them).  Statistics stay on the activations' device: sqnorm and amax in
float32, H in float64 (an expert stack's X^T X summed in float32 first,
as the reference's does), routing statistics in float64.

Weights are keyed by their path in the param tree (e.g.
``blocks.0.3.attn.wq``; the hybrid's ``mamba_groups.g.k.in_proj``,
``shared.attn.wq`` and ``mamba_tail.i.out_proj``; rwkv's
``blocks.0.r.tm.wr`` and ``blocks.0.r.cm.wv``, the decay LoRA's
``tm.wa1``/``tm.wa2`` included; encdec's unrolled ``enc_blocks.i.attn.wq``
and ``dec_blocks.i.xattn.wk``, its block similarities under
``enc_blocks.i`` and ``dec_blocks.i``).  The interception happens inside
``repro_torch.core.compressed.matmul`` through ``set_record_hook``, so
no model code knows about calibration.  Weights are recognised by object
identity: a slice ``t[r]`` of a stacked tensor is a new object on every
call, so the calibration loop registers the very per-layer slices it hands to
``block_apply`` and keeps them alive while the block runs.  Padded
positions of the sample are recorded too, as in the reference.

Also here: ``fit_confidence_threshold``, which fits a proxy -> base
cascade's acceptance threshold on a held-out probe.  Every family is
calibrated: a vlm's sample may carry ``img_embs`` (spliced ahead of the
text, counted in ``n_tokens``), an encdec's must carry ``enc_inputs``
(``n_tokens`` then counts the decoder tokens only, as the reference's).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import compressed


@dataclasses.dataclass
class WeightStats:
    shape: Tuple[int, ...]
    count: int = 0
    H: Optional[torch.Tensor] = None        # [d_in, d_in] (or [E, d_in, d_in]) float64
    sqnorm: Optional[torch.Tensor] = None   # [d_in] (or [E, d_in]) float32
    amax: Optional[torch.Tensor] = None     # [d_in] (or [E, d_in]) float32
    count_e: Optional[torch.Tensor] = None  # expert stacks: rows per expert [E] int64
    route_count: Optional[torch.Tensor] = None  # routers: [E] float64
    route_prob: Optional[torch.Tensor] = None   # routers: [E] float64

    def merge_norm(self) -> torch.Tensor:
        """Per-channel RMS norm of the inputs (the Wanda metric); an expert
        stack's rows divide by each expert's own row count."""
        if self.sqnorm.dim() == 2 and self.count_e is not None:
            denom = torch.clamp(self.count_e, min=1).double()
            return torch.sqrt(self.sqnorm / denom[:, None])
        return torch.sqrt(self.sqnorm / max(self.count, 1))


@dataclasses.dataclass
class CalibStats:
    weights: Dict[str, WeightStats]
    block_sim: Dict[str, float]      # path -> cos(x_in, x_out)
    n_tokens: int = 0

    def get(self, path: str) -> Optional[WeightStats]:
        return self.weights.get(path)


class Recorder:
    """Accumulates statistics for weights registered under a path."""

    def __init__(self, hessian: bool = True):
        self.hessian = hessian
        self.stats: Dict[str, WeightStats] = {}
        self.block_sim: Dict[str, float] = {}
        self._block_acc: Dict[str, List[float]] = {}   # path -> [sum, count]
        self._id2path: Dict[int, str] = {}
        self.n_tokens = 0

    def register(self, prefix: str, tree) -> None:
        """Map every tensor leaf of ``tree`` to ``prefix.<path>``."""
        for path, leaf in _leaves(tree, ""):
            self._id2path[id(leaf)] = f"{prefix}.{path}" if prefix else path

    @contextlib.contextmanager
    def active(self):
        compressed.set_record_hook(self._on_matmul)
        compressed.set_route_hook(self._on_route)
        try:
            yield self
        finally:
            compressed.set_record_hook(None)
            compressed.set_route_hook(None)

    def _stats_of(self, w) -> Optional[WeightStats]:
        path = self._id2path.get(id(w))
        if path is None:
            return None
        st = self.stats.get(path)
        if st is None:
            st = WeightStats(shape=tuple(w.shape))
            self.stats[path] = st
        return st

    def _on_matmul(self, w, x, valid=None) -> None:
        if w.dim() < 2:
            return
        st = self._stats_of(w)
        if st is None:
            return
        if w.dim() == 3 and valid is not None:
            self._on_experts(st, x, valid)
            return
        xf = x.detach().float().reshape(-1, x.shape[-1])        # [N, d_in]
        d = xf.shape[1]
        if st.sqnorm is None:
            st.sqnorm = torch.zeros((d,), dtype=torch.float32, device=xf.device)
            st.amax = torch.zeros((d,), dtype=torch.float32, device=xf.device)
            if self.hessian:
                st.H = torch.zeros((d, d), dtype=torch.float64, device=xf.device)
        st.sqnorm += (xf ** 2).sum(0)
        st.amax = torch.maximum(st.amax, xf.abs().amax(0))
        if self.hessian:
            xd = xf.double()
            st.H += xd.T @ xd
        st.count += xf.shape[0]

    def _on_experts(self, st: WeightStats, x, valid) -> None:
        """A stacked expert weight: x [E, C, d_in], valid [E] filled rows."""
        xe = x.detach().float()
        E, C, d = xe.shape
        mask = torch.arange(C, device=xe.device)[None, :] < valid[:, None]
        xm = xe * mask[..., None]
        if st.sqnorm is None:
            st.sqnorm = torch.zeros((E, d), dtype=torch.float32, device=xe.device)
            st.amax = torch.zeros((E, d), dtype=torch.float32, device=xe.device)
            st.count_e = torch.zeros((E,), dtype=torch.int64, device=xe.device)
            if self.hessian:
                st.H = torch.zeros((E, d, d), dtype=torch.float64, device=xe.device)
        st.sqnorm += (xm ** 2).sum(1)
        st.amax = torch.maximum(st.amax, xm.abs().amax(1))
        if self.hessian:
            st.H += torch.matmul(xm.transpose(1, 2), xm).double()
        rows = valid.to(torch.int64)
        st.count_e += rows
        st.count += int(rows.sum().item())

    def _on_route(self, router_w, counts, probs_mean) -> None:
        st = self._stats_of(router_w)
        if st is None:
            return
        c, p = counts.detach().double(), probs_mean.detach().double()
        st.route_count = c if st.route_count is None else st.route_count + c
        st.route_prob = p if st.route_prob is None else st.route_prob + p

    def record_block(self, path: str, x_in, x_out) -> None:
        a = x_in.detach().float().reshape(-1)
        b = x_out.detach().float().reshape(-1)
        cos = float((a @ b / (a.norm() * b.norm() + 1e-9)).item())
        acc = self._block_acc.setdefault(path, [0.0, 0])
        acc[0] += cos
        acc[1] += 1

    def finish(self) -> CalibStats:
        self.block_sim = {p: s / n for p, (s, n) in self._block_acc.items()}
        return CalibStats(weights=self.stats, block_sim=self.block_sim,
                          n_tokens=self.n_tokens)


@dataclasses.dataclass(frozen=True)
class CascadeCalibration:
    """Fitted acceptance rule for a proxy→base model cascade.

    ``threshold`` is the smallest confidence at which proxy answers are
    accepted; rows with ``confidence < threshold`` escalate to the base
    model.  ``expected_escalation`` is the escalation rate the fit
    predicts on its own sample — the number the physical planner's cost
    inequality and ``EXPLAIN`` report."""
    threshold: float
    expected_escalation: float
    accuracy_budget: float
    n_fit: int

    # warm-restart serialization (the service's checkpoint).  ``inf``
    # thresholds survive the trip: json emits the literal Infinity,
    # which Python's json reader parses back to float('inf').
    def to_dict(self) -> dict:
        return {"threshold": self.threshold,
                "expected_escalation": self.expected_escalation,
                "accuracy_budget": self.accuracy_budget,
                "n_fit": self.n_fit}

    @staticmethod
    def from_dict(d: dict) -> "CascadeCalibration":
        return CascadeCalibration(
            threshold=float(d["threshold"]),
            expected_escalation=float(d["expected_escalation"]),
            accuracy_budget=float(d["accuracy_budget"]),
            n_fit=int(d["n_fit"]))


def fit_confidence_threshold(confidences, agreements,
                             accuracy_budget: float) -> CascadeCalibration:
    """Fit the cascade acceptance threshold on a held-out probe.

    ``confidences[i]`` is the proxy's confidence on holdout row i and
    ``agreements[i]`` whether the proxy's answer matched the base
    model's.  The fit picks the SMALLEST threshold (most rows accepted,
    fewest escalations) such that accepted-but-wrong rows stay within
    the per-op accuracy budget, measured against the WHOLE sample:

        |{i : conf_i >= thr  and  not agree_i}| / n  <=  accuracy_budget

    Lowering the threshold only grows the accepted set, so the
    constraint is monotone and the scan below finds the optimum.  A
    budget of 0 (or none satisfiable) returns ``threshold = inf``:
    every row escalates and the cascade degenerates to base-only —
    the exactness contract.  Deterministic:
    the result is a pure function of the (sorted) sample.
    """
    conf = np.asarray(confidences, np.float64)
    agree = np.asarray(agreements, bool)
    n = conf.size
    if accuracy_budget is None or accuracy_budget <= 0.0 or n == 0:
        return CascadeCalibration(threshold=float("inf"),
                                  expected_escalation=1.0,
                                  accuracy_budget=float(accuracy_budget or 0.0),
                                  n_fit=int(n))
    best = float("inf")
    for thr in np.unique(conf):          # ascending: first hit is smallest
        wrong = int(np.sum((conf >= thr) & ~agree))
        if wrong <= accuracy_budget * n:
            best = float(thr)
            break
    esc = float(np.mean(conf < best)) if np.isfinite(best) else 1.0
    return CascadeCalibration(threshold=best, expected_escalation=esc,
                              accuracy_budget=float(accuracy_budget),
                              n_fit=int(n))


def _leaves(tree, path: str):
    """(dotted path, leaf) over a param tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}.{i}" if path else str(i))
    elif tree is not None:
        yield path, tree


def calibrate(params, cfg, batch: Dict[str, Any], *, hessian: bool = True,
              include_head: bool = True) -> CalibStats:
    """Run the model on ``batch`` ({"tokens": [B, S]}, with ``img_embs``
    or ``enc_inputs`` as ``api.forward`` takes them) and gather
    calibration statistics, the untied output head's included unless
    ``include_head`` is False."""
    by_family = {"dense": _calib_transformer, "moe": _calib_transformer,
                 "vlm": _calib_transformer, "hybrid": _calib_hybrid,
                 "rwkv": _calib_rwkv, "encdec": _calib_encdec}
    if cfg.family not in by_family:
        raise ValueError(f"unknown family {cfg.family!r}")
    rec = Recorder(hessian=hessian)
    with torch.no_grad():
        by_family[cfg.family](rec, params, cfg, batch, include_head)
    return rec.finish()


def _head(rec, params, cfg, x, include_head):
    from repro_torch.models import layers as L
    if include_head and not cfg.tie_embeddings:
        x = L.norm(x, params["ln_f"], cfg)
        rec.register("", {"unembed": params["unembed"]})
        L.matmul(x, params["unembed"])


def _calib_transformer(rec, params, cfg, batch, include_head):
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    img = batch.get("img_embs")
    x = TF.embed_inputs(params, cfg, tokens,
                        None if img is None else torch.as_tensor(img, device=tokens.device))
    B, S, _ = x.shape
    rec.n_tokens = B * S
    positions = torch.arange(S, device=x.device).expand(B, S)
    unit, R, _ = TF.pattern_unit(cfg)
    with rec.active():
        for r in range(R):
            for u, kind in enumerate(unit):
                bp = TF.layer_slice(params["blocks"][u], r)
                path = f"blocks.{u}.{r}"
                rec.register(path, bp)
                x2, _ = TF.block_apply(bp, x, cfg, kind=kind, positions=positions)
                rec.record_block(path, x, x2)
                x = x2
        for i, bp in enumerate(params["tail"]):
            path = f"tail.{i}"
            rec.register(path, bp)
            x2, _ = TF.block_apply(bp, x, cfg, kind=unit[i % len(unit)],
                                   positions=positions)
            rec.record_block(path, x, x2)
            x = x2
        _head(rec, params, cfg, x, include_head)


def _calib_hybrid(rec, params, cfg, batch, include_head):
    """The Mamba layers in order with the shared block after each group:
    its statistics accumulate over its sites (registered once, its
    tensors are the same objects at every visit)."""
    from repro_torch.models import hybrid as HY
    from repro_torch.models import layers as L
    from repro_torch.models import mamba as M
    from repro_torch.models import transformer as TF
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    x = L.embed(params, cfg, tokens)
    B, S, _ = x.shape
    rec.n_tokens = B * S
    positions = torch.arange(S, device=x.device).expand(B, S)
    G, K, tail, _ = HY.layout(cfg)
    shared = params["shared"]
    rec.register("shared", shared)

    def mamba(bp, path, x):
        rec.register(path, bp)
        x2, _ = M.block_apply(bp, x, cfg)
        rec.record_block(path, x, x2)
        return x2

    with rec.active():
        for g in range(G):
            group = TF.layer_slice(params["mamba_groups"], g)
            for k in range(K):
                x = mamba(TF.layer_slice(group, k), f"mamba_groups.{g}.{k}", x)
            x2, _ = TF.block_apply(shared, x, cfg, kind="G", positions=positions)
            rec.record_block("shared", x, x2)
            x = x2
        for i in range(tail):
            x = mamba(TF.layer_slice(params["mamba_tail"], i), f"mamba_tail.{i}", x)
        _head(rec, params, cfg, x, include_head)


def _calib_rwkv(rec, params, cfg, batch, include_head):
    """The layers of the stack in order, from zero states over the whole
    sample (padding included, as in the reference)."""
    from repro_torch.models import layers as L
    from repro_torch.models import rwkv as RW
    from repro_torch.models import transformer as TF
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    x = L.embed(params, cfg, tokens)
    B, S, _ = x.shape
    rec.n_tokens = B * S
    with rec.active():
        for r in range(RW.depth(params)):
            bp = TF.layer_slice(params["blocks"][0], r)
            path = f"blocks.0.{r}"
            rec.register(path, bp)
            x2, _ = RW.block_apply(bp, x, cfg)
            rec.record_block(path, x, x2)
            x = x2
        _head(rec, params, cfg, x, include_head)


def _calib_encdec(rec, params, cfg, batch, include_head):
    """The encoder's blocks over ``enc_inputs``, then the decoder's over
    the tokens against the encoder's output, each list's block
    similarities under its own keys."""
    from repro_torch.models import encdec as ED
    from repro_torch.models import layers as L
    dev = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    enc_inputs = torch.as_tensor(batch["enc_inputs"], device=dev)
    rec.n_tokens = tokens.numel()
    with rec.active():
        x = enc_inputs + params["pos_enc"][None, :enc_inputs.shape[1]]
        for i, p in enumerate(params["enc_blocks"]):
            path = f"enc_blocks.{i}"
            rec.register(path, p)
            x2 = ED._enc_block(p, x, cfg)
            rec.record_block(path, x, x2)
            x = x2
        enc_out = L.norm(x, params["ln_enc"], cfg)
        x = L.embed(params, cfg, tokens) + params["pos_dec"][None, :tokens.shape[1]]
        for i, p in enumerate(params["dec_blocks"]):
            path = f"dec_blocks.{i}"
            rec.register(path, p)
            x2 = ED._dec_block(p, x, enc_out, cfg)
            rec.record_block(path, x, x2)
            x = x2
        _head(rec, params, cfg, x, include_head)
