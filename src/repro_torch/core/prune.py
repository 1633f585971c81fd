"""Structural pruning: KV-head groups, FFN channels, whole layers.

LLM-Pruner-style removal of entire components, driven by the calibration
statistics, so the same data sample that tunes quantization also decides
what structure this query does not need.

Pruned counts are uniform across layers (every layer keeps the same
number of KV groups or FFN channels, each layer choosing its own least
important members), so a stacked ``[R, ...]`` leaf stays one tensor and
every layer runs the same kernel shapes.  Layer dropping works at
pattern-unit granularity.

Every transform returns ``(new_params, new_cfg, new_stats)``: the stats
are re-sliced and re-keyed so that downstream quantization and
sparsification see the Hessians of the reduced shapes.  Statistics stay
where calibration left them (on the card for a model that lives there);
a float64 Hessian is sliced there too (``H[idx][:, idx]``).  Ties in
importance resolve as ``np.argsort(kind="stable")`` does, through a
stable sort of the negated importance, so both packages keep the same
members.  Only the dense family is ported; expert pruning waits for the
MoE family (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.core.calibrate import CalibStats, WeightStats

_FAMILIES = "ROADMAP queue 1 item 9"


def _dense_only(cfg, what: str) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{what} of family {cfg.family!r} is not ported yet ({_FAMILIES})")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _take_stacked(stacked: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """stacked [R, ...]; idx [R, k] per-layer indices along ``axis`` of
    each layer's tensor."""
    idx = idx.to(stacked.device)
    return torch.stack([torch.index_select(stacked[r], axis, idx[r])
                        for r in range(stacked.shape[0])])


def _top(imp: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries, ascending; ties keep the
    lower index first (``np.argsort(-imp, kind="stable")``)."""
    order = torch.sort(-imp, stable=True).indices[:k]
    return torch.sort(order).values


def _channel_importance(st: Optional[WeightStats], w: torch.Tensor) -> torch.Tensor:
    """Per-input-channel importance of a [d_in, d_out] weight: Wanda-style
    ||x||^2 * mean w^2 per row, falling back to weight norms alone."""
    row = (w.float() ** 2).mean(1)
    if st is not None and st.sqnorm is not None:
        return st.sqnorm.to(row.device) / max(st.count, 1) * row
    return row


def _slice_stats(st: Optional[WeightStats], idx: torch.Tensor) -> Optional[WeightStats]:
    """Restrict input-channel stats to ``idx`` (for downstream quant)."""
    if st is None:
        return None

    def sl(a):
        return None if a is None else a[idx.to(a.device)]

    H = st.H
    if H is not None:
        i = idx.to(H.device)
        H = H[i][:, i]
    return WeightStats(shape=(len(idx),) + tuple(st.shape[1:]), count=st.count,
                       H=H, sqnorm=sl(st.sqnorm), amax=sl(st.amax))


def _units(cfg):
    from repro_torch.models.transformer import pattern_unit
    return pattern_unit(cfg)


# ---------------------------------------------------------------------------
# KV-group (GQA head) pruning
# ---------------------------------------------------------------------------

def prune_kv_groups(params, cfg, stats: CalibStats, keep: int):
    """Keep the ``keep`` most important KV groups in every attention block."""
    _dense_only(cfg, "KV-group pruning")
    K, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    if not 1 <= keep <= K:
        raise ValueError(f"keep={keep} KV groups out of {K}")
    if keep == K:
        return params, cfg, stats
    params = dict(params)
    new_stats = dict(stats.weights)

    def group_imp(wo_st: Optional[WeightStats], wo: torch.Tensor) -> torch.Tensor:
        return _channel_importance(wo_st, wo).reshape(K, G * hd).sum(1)   # [K]

    def prune_one(attn, paths: List[str]) -> Dict:
        """attn leaves stacked [R, ...]; paths[r] = stats key prefix."""
        stacked = attn["wq"].dim() == 3
        R = attn["wo"].shape[0] if stacked else 1
        dev = attn["wo"].device
        idx = torch.zeros((R, keep), dtype=torch.long, device=dev)
        for r in range(R):
            wo = attn["wo"][r] if stacked else attn["wo"]
            idx[r] = _top(group_imp(stats.get(paths[r] + ".wo"), wo), keep)
        lead = (R,) if stacked else ()
        d = attn["wq"].shape[-2]
        sel = idx if stacked else idx[0]

        def take(w, shape, axis):
            w = w.reshape(*lead, *shape)
            if stacked:
                return _take_stacked(w, sel, axis)
            return torch.index_select(w, axis, sel)

        out = {"wq": take(attn["wq"], (d, K, G * hd), 1).reshape(*lead, d, keep * G * hd),
               "wk": take(attn["wk"], (d, K, hd), 1).reshape(*lead, d, keep * hd),
               "wv": take(attn["wv"], (d, K, hd), 1).reshape(*lead, d, keep * hd),
               "wo": take(attn["wo"], (K, G * hd, d), 0).reshape(*lead, keep * G * hd, d)}
        # stats: wo input channels restricted to kept groups
        span = torch.arange(G * hd, device=dev)
        for r in range(R):
            ch = (idx[r][:, None] * (G * hd) + span[None, :]).reshape(-1)
            key = paths[r] + ".wo"
            if key in new_stats:
                new_stats[key] = _slice_stats(new_stats[key], ch)
        return out

    unit, R, tail = _units(cfg)
    params["blocks"] = list(params["blocks"])
    params["tail"] = list(params["tail"])
    for u in range(len(unit)):
        blk = dict(params["blocks"][u])
        blk["attn"] = prune_one(blk["attn"], [f"blocks.{u}.{r}.attn" for r in range(R)])
        params["blocks"][u] = blk
    for i in range(tail):
        blk = dict(params["tail"][i])
        blk["attn"] = prune_one(blk["attn"], [f"tail.{i}.attn"])
        params["tail"][i] = blk
    # pin head_dim: n_heads changes would silently alter d_model // n_heads
    new_cfg = cfg.replace(n_kv_heads=keep, n_heads=keep * G,
                          head_dim=cfg.resolved_head_dim)
    return params, new_cfg, CalibStats(new_stats, stats.block_sim, stats.n_tokens)


# ---------------------------------------------------------------------------
# FFN channel pruning
# ---------------------------------------------------------------------------

def prune_ffn(params, cfg, stats: CalibStats, keep_frac: float):
    """Keep the top ``keep_frac`` FFN hidden channels (each layer its own)."""
    _dense_only(cfg, "FFN pruning")
    if keep_frac >= 1.0:
        return params, cfg, stats
    params = dict(params)
    new_stats = dict(stats.weights)

    def prune_mlp(mlp: Dict, paths: List[str]) -> Dict:
        stacked = mlp["wo"].dim() == 3
        R = mlp["wo"].shape[0] if stacked else 1
        ff = mlp["wo"].shape[-2]
        keep_ff = max(8, int(round(keep_frac * ff)) // 8 * 8)
        idx = torch.zeros((R, keep_ff), dtype=torch.long, device=mlp["wo"].device)
        for r in range(R):
            wo = mlp["wo"][r] if stacked else mlp["wo"]
            idx[r] = _top(_channel_importance(stats.get(paths[r] + ".wo"), wo), keep_ff)
        out = dict(mlp)
        names = [("wo", 0), ("wi", 1)] + ([("wg", 1)] if "wg" in mlp else [])
        for name, axis in names:
            out[name] = (_take_stacked(mlp[name], idx, axis) if stacked
                         else torch.index_select(mlp[name], axis, idx[0]))
        for r in range(R):
            key = paths[r] + ".wo"
            if key in new_stats:
                new_stats[key] = _slice_stats(new_stats[key], idx[r])
        return out

    unit, R, tail = _units(cfg)
    params["blocks"] = list(params["blocks"])
    params["tail"] = list(params["tail"])
    new_ff = cfg.d_ff
    for u in range(len(unit)):
        blk = dict(params["blocks"][u])
        blk["mlp"] = prune_mlp(blk["mlp"], [f"blocks.{u}.{r}.mlp" for r in range(R)])
        new_ff = blk["mlp"]["wo"].shape[-2]
        params["blocks"][u] = blk
    for i in range(tail):
        blk = dict(params["tail"][i])
        blk["mlp"] = prune_mlp(blk["mlp"], [f"tail.{i}.mlp"])
        params["tail"][i] = blk
    new_cfg = cfg.replace(d_ff=new_ff)
    return params, new_cfg, CalibStats(new_stats, stats.block_sim, stats.n_tokens)


# ---------------------------------------------------------------------------
# layer dropping
# ---------------------------------------------------------------------------

def _take_layers(tree, kept: torch.Tensor):
    if isinstance(tree, dict):
        return {k: _take_layers(v, kept) for k, v in tree.items()}
    return torch.index_select(tree, 0, kept.to(tree.device))


def drop_layers(params, cfg, stats: CalibStats, n_drop_units: int):
    """Drop the ``n_drop_units`` most redundant pattern-unit repeats.

    Redundancy score = 1 - cos(block input, block output) averaged over
    the unit, from calibration.  Order of the surviving layers is kept.
    """
    _dense_only(cfg, "layer dropping")
    if n_drop_units <= 0:
        return params, cfg, stats
    params = dict(params)
    new_stats = dict(stats.weights)
    unit, R, tail = _units(cfg)
    keep_n = max(1, R - n_drop_units)
    score = torch.zeros(R, dtype=torch.float64)
    for r in range(R):
        sims = [stats.block_sim.get(f"blocks.{u}.{r}", 0.0) for u in range(len(unit))]
        score[r] = 1.0 - sum(sims) / len(sims)
    kept = _top(score, keep_n)
    params["blocks"] = [_take_layers(b, kept) for b in params["blocks"]]
    for u in range(len(unit)):
        # re-key stats blocks.u.{old} -> blocks.u.{new}
        moved = {}
        for new_i, old_i in enumerate(kept.tolist()):
            pre_old, pre_new = f"blocks.{u}.{old_i}.", f"blocks.{u}.{new_i}."
            for k in list(new_stats):
                if k.startswith(pre_old):
                    moved[pre_new + k[len(pre_old):]] = new_stats.pop(k)
        # purge dropped
        for k in list(new_stats):
            if k.startswith(f"blocks.{u}.") and int(k.split(".")[2]) >= keep_n:
                new_stats.pop(k)
        new_stats.update(moved)
    pat = cfg.pattern()
    new_pat = unit * keep_n + pat[len(unit) * R:]
    new_cfg = cfg.replace(n_layers=len(unit) * keep_n + tail,
                          attn_pattern=new_pat if cfg.attn_pattern is not None else None)
    return params, new_cfg, CalibStats(new_stats, stats.block_sim, stats.n_tokens)


# ---------------------------------------------------------------------------
# expert pruning
# ---------------------------------------------------------------------------

def prune_experts(params, cfg, stats: CalibStats, keep_e: int):
    """Keep the ``keep_e`` most-routed experts per layer: needs the MoE
    family and its routing statistics, which are not ported yet."""
    raise NotImplementedError(
        f"expert pruning is not ported yet: it needs the MoE family ({_FAMILIES})")
