"""Structural pruning: KV-head groups, FFN channels, whole layers, experts.

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
members.  Every family prunes: an MoE block's
FFN pruning keeps channels per expert (and prunes its shared and dense
residual MLPs as dense ones), and expert pruning keeps the experts that
this query's calibration rows routed to most.  The hybrid's KV-group
and FFN pruning change its one shared block, so all of its sites at
once (its Mamba inner channels are left alone, as in the reference), and
its layer dropping removes whole Mamba groups.  rwkv has no attention:
KV-group pruning returns it unchanged; FFN pruning keeps channel-mix
channels (``cm.wv`` rows and ``cm.wk`` columns) and layer dropping takes
single layers of its one stack.  A vlm prunes as the dense stack does.
encdec's unrolled lists prune each layer on its own: KV groups in every
``enc_blocks.i.attn``, ``dec_blocks.i.attn`` and ``dec_blocks.i.xattn``,
channels of every ungated GELU MLP, and layer dropping takes the blocks
of least change from either list by ``block_sim``, keeping at least one
block in each.  Expert pruning leaves the
router's statistics of the optimizer it came from as they were: the
reference slices them in place (ROADMAP queue 3), so a second
expert-pruned recipe of the same optimizer there ranks the wrong experts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.core.calibrate import CalibStats, WeightStats

_FAMILIES = ("dense", "moe", "vlm", "hybrid", "rwkv", "encdec")


def _known(cfg, what: str) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"{what} of unknown family {cfg.family!r}")


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
    """Keep the ``keep`` most important KV groups in every attention block.
    rwkv, which has none, is returned unchanged."""
    _known(cfg, "KV-group pruning")
    if cfg.family == "rwkv":
        return params, cfg, stats
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

    if cfg.family == "hybrid":
        params["shared"] = dict(params["shared"])
        params["shared"]["attn"] = prune_one(params["shared"]["attn"], ["shared.attn"])
    elif cfg.family == "encdec":
        for lst, nm in (("enc_blocks", "attn"), ("dec_blocks", "attn"),
                        ("dec_blocks", "xattn")):
            params[lst] = list(params[lst])
            for i, blk in enumerate(params[lst]):
                params[lst][i] = {**blk, nm: prune_one(blk[nm], [f"{lst}.{i}.{nm}"])}
    else:
        unit, R, tail = _units(cfg)
        params["blocks"] = list(params["blocks"])
        params["tail"] = list(params["tail"])
        for u in range(len(unit)):
            blk = dict(params["blocks"][u])
            blk["attn"] = prune_one(blk["attn"],
                                    [f"blocks.{u}.{r}.attn" for r in range(R)])
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
    _known(cfg, "FFN pruning")
    if keep_frac >= 1.0:
        return params, cfg, stats
    params = dict(params)
    new_stats = dict(stats.weights)

    def prune_mlp(mlp: Dict, paths: List[str], gated: bool = True) -> Dict:
        stacked = mlp["wo"].dim() == 3
        R = mlp["wo"].shape[0] if stacked else 1
        ff = mlp["wo"].shape[-2]
        keep_ff = max(8, int(round(keep_frac * ff)) // 8 * 8)
        idx = torch.zeros((R, keep_ff), dtype=torch.long, device=mlp["wo"].device)
        for r in range(R):
            wo = mlp["wo"][r] if stacked else mlp["wo"]
            idx[r] = _top(_channel_importance(stats.get(paths[r] + ".wo"), wo), keep_ff)
        out = dict(mlp)
        names = [("wo", 0), ("wi", 1)] + ([("wg", 1)] if gated and "wg" in mlp else [])
        for name, axis in names:
            out[name] = (_take_stacked(mlp[name], idx, axis) if stacked
                         else torch.index_select(mlp[name], axis, idx[0]))
        for r in range(R):
            key = paths[r] + ".wo"
            if key in new_stats:
                new_stats[key] = _slice_stats(new_stats[key], idx[r])
        return out

    def prune_moe(moe: Dict, paths: List[str]) -> Dict:
        """Per-expert channel pruning: a uniform keep count, each (layer,
        expert) choosing its own.  wi, wg [R?, E, d, ffe], wo [R?, E, ffe, d]."""
        stacked = moe["wo"].dim() == 4
        R = moe["wo"].shape[0] if stacked else 1
        E, ffe = moe["wo"].shape[-3], moe["wo"].shape[-2]
        keep_ff = max(8, int(round(keep_frac * ffe)) // 8 * 8)
        idx = torch.zeros((R, E, keep_ff), dtype=torch.long, device=moe["wo"].device)
        for r in range(R):
            wo = moe["wo"][r] if stacked else moe["wo"]              # [E, ffe, d]
            st = stats.get(paths[r] + ".wo")
            for e in range(E):
                imp = (wo[e].float() ** 2).mean(1)
                if st is not None and st.sqnorm is not None:
                    imp = st.sqnorm[e].to(imp.device) / max(st.count, 1) * imp
                idx[r, e] = _top(imp, keep_ff)
        out = dict(moe)
        for name, axis in (("wo", 0), ("wi", 1), ("wg", 1)):
            w = moe[name] if stacked else moe[name][None]
            t = torch.stack([torch.stack([torch.index_select(w[r, e], axis, idx[r, e])
                                          for e in range(E)]) for r in range(R)])
            out[name] = t if stacked else t[0]
        for r in range(R):
            key = paths[r] + ".wo"
            st = new_stats.get(key)
            if st is not None and st.sqnorm is not None:
                ix = [idx[r, e].to(st.sqnorm.device) for e in range(E)]
                new_stats[key] = WeightStats(
                    shape=(E, keep_ff, moe["wo"].shape[-1]), count=st.count,
                    H=None if st.H is None else torch.stack(
                        [st.H[e][ix[e]][:, ix[e]] for e in range(E)]),
                    sqnorm=torch.stack([st.sqnorm[e][ix[e]] for e in range(E)]),
                    amax=torch.stack([st.amax[e][ix[e]] for e in range(E)]))
        return out

    if cfg.family == "hybrid":
        params["shared"] = dict(params["shared"])
        params["shared"]["mlp"] = prune_mlp(params["shared"]["mlp"], ["shared.mlp"])
        new_cfg = cfg.replace(d_ff=params["shared"]["mlp"]["wo"].shape[-2])
        return params, new_cfg, CalibStats(new_stats, stats.block_sim, stats.n_tokens)
    if cfg.family == "rwkv":
        return _prune_channel_mix(params, cfg, stats, new_stats, keep_frac)
    if cfg.family == "encdec":
        for lst in ("enc_blocks", "dec_blocks"):
            params[lst] = [{**blk, "mlp": prune_mlp(blk["mlp"], [f"{lst}.{i}.mlp"], gated=False)}
                           for i, blk in enumerate(params[lst])]
        new_cfg = cfg.replace(d_ff=params["dec_blocks"][0]["mlp"]["wo"].shape[-2])
        return params, new_cfg, CalibStats(new_stats, stats.block_sim, stats.n_tokens)

    unit, R, tail = _units(cfg)
    params["blocks"] = list(params["blocks"])
    params["tail"] = list(params["tail"])

    def prune_block(blk, pre: List[str]):
        """The block's MLPs pruned, and the widths they give the config:
        (block, {field: width})."""
        blk, widths = dict(blk), {}
        for name, prune, field in (("mlp", prune_mlp, "d_ff"), ("moe", prune_moe, "moe_d_ff"),
                                   ("shared_mlp", prune_mlp, None),
                                   ("dense_mlp", prune_mlp, "d_ff")):
            if name in blk:
                blk[name] = prune(blk[name], [f"{p}.{name}" for p in pre])
                if field:
                    widths[field] = blk[name]["wo"].shape[-2]
        return blk, widths

    widths = {}
    for u in range(len(unit)):
        params["blocks"][u], w = prune_block(params["blocks"][u],
                                             [f"blocks.{u}.{r}" for r in range(R)])
        widths.update(w)
    for i in range(tail):           # tail layers set no width, as in the reference
        params["tail"][i], _ = prune_block(params["tail"][i], [f"tail.{i}"])
    new_cfg = cfg.replace(**widths)
    return params, new_cfg, CalibStats(new_stats, stats.block_sim, stats.n_tokens)


def _prune_channel_mix(params, cfg, stats: CalibStats, new_stats, keep_frac: float):
    """rwkv's FFN pruning: each layer keeps its ``keep_frac`` most important
    channel-mix channels (rows of ``cm.wv``, columns of ``cm.wk``), ranked
    by ``cm.wv``'s statistics, which are sliced to them."""
    stack = dict(params["blocks"][0])
    cm = dict(stack["cm"])
    R, ff = cm["wv"].shape[0], cm["wv"].shape[-2]
    keep_ff = max(8, int(round(keep_frac * ff)) // 8 * 8)
    idx = torch.zeros((R, keep_ff), dtype=torch.long, device=cm["wv"].device)
    for r in range(R):
        idx[r] = _top(_channel_importance(stats.get(f"blocks.0.{r}.cm.wv"), cm["wv"][r]),
                      keep_ff)
    cm["wv"] = _take_stacked(cm["wv"], idx, 0)
    cm["wk"] = _take_stacked(cm["wk"], idx, 1)
    for r in range(R):
        key = f"blocks.0.{r}.cm.wv"
        if key in new_stats:
            new_stats[key] = _slice_stats(new_stats[key], idx[r])
    stack["cm"] = cm
    params["blocks"] = [stack]
    return (params, cfg.replace(d_ff=keep_ff),
            CalibStats(new_stats, stats.block_sim, stats.n_tokens))


# ---------------------------------------------------------------------------
# layer dropping
# ---------------------------------------------------------------------------

def _take_layers(tree, kept: torch.Tensor):
    if isinstance(tree, dict):
        return {k: _take_layers(v, kept) for k, v in tree.items()}
    return torch.index_select(tree, 0, kept.to(tree.device))


def _rekey(new_stats, prefix: str, kept, keep_n: int, at: int) -> None:
    """Stats ``prefix.{old}.`` -> ``prefix.{new}.`` for the kept indices
    (``at``: the index's position in the dotted key), and the keys of
    dropped indices at or past ``keep_n`` purged, as the reference does."""
    moved = {}
    for new_i, old_i in enumerate(kept.tolist()):
        pre_old, pre_new = f"{prefix}.{old_i}.", f"{prefix}.{new_i}."
        for k in list(new_stats):
            if k.startswith(pre_old):
                moved[pre_new + k[len(pre_old):]] = new_stats.pop(k)
    for k in list(new_stats):
        if k.startswith(f"{prefix}.") and int(k.split(".")[at]) >= keep_n:
            new_stats.pop(k)
    new_stats.update(moved)


def _drop_groups(params, cfg, stats: CalibStats, n_drop: int):
    """The hybrid's layer dropping: the ``n_drop`` Mamba groups of most
    redundancy, 1 - mean(block_sim) over the group's layers; the shared
    block keeps its sites after the remaining groups."""
    from repro_torch.models.hybrid import layout
    G, K, tail, _ = layout(cfg)
    keep_n = max(1, G - n_drop)
    score = torch.zeros(G, dtype=torch.float64)
    for g in range(G):
        sims = [stats.block_sim.get(f"mamba_groups.{g}.{k}", 0.0) for k in range(K)]
        score[g] = 1.0 - sum(sims) / len(sims)
    kept = _top(score, keep_n)
    params = dict(params)
    params["mamba_groups"] = _take_layers(params["mamba_groups"], kept)
    new_stats = dict(stats.weights)
    _rekey(new_stats, "mamba_groups", kept, keep_n, 1)
    new_cfg = cfg.replace(n_layers=keep_n * (K + 1) + tail)
    return params, new_cfg, CalibStats(new_stats, stats.block_sim, stats.n_tokens)


def _drop_blocks(params, cfg, stats: CalibStats, n_drop: int):
    """encdec's layer dropping: the ``n_drop`` blocks of least change,
    1 - block_sim, taken from both lists in one ascending order (ties by
    list, then index, as the reference's sort of tuples), each list
    keeping at least one block; the survivors' stats re-keyed."""
    scores = sorted([(1.0 - stats.block_sim.get(f"{lst}.{i}", 0.0), lst, i)
                     for lst in ("enc_blocks", "dec_blocks")
                     for i in range(len(params[lst]))])
    drop = {"enc_blocks": set(), "dec_blocks": set()}
    for _, lst, i in scores:
        if sum(map(len, drop.values())) >= n_drop:
            break
        if len(params[lst]) - len(drop[lst]) > 1:
            drop[lst].add(i)
    params = dict(params)
    new_stats = dict(stats.weights)
    for lst in ("enc_blocks", "dec_blocks"):
        kept = [i for i in range(len(params[lst])) if i not in drop[lst]]
        params[lst] = [params[lst][i] for i in kept]
        _rekey(new_stats, lst, torch.tensor(kept, dtype=torch.long), len(kept), 1)
    new_cfg = cfg.replace(n_enc_layers=cfg.n_enc_layers - len(drop["enc_blocks"]),
                          n_dec_layers=cfg.n_dec_layers - len(drop["dec_blocks"]))
    return params, new_cfg, CalibStats(new_stats, stats.block_sim, stats.n_tokens)


def drop_layers(params, cfg, stats: CalibStats, n_drop_units: int):
    """Drop the ``n_drop_units`` most redundant pattern-unit repeats (the
    hybrid: Mamba groups; rwkv: layers; encdec: blocks of either list).

    Redundancy score = 1 - cos(block input, block output) averaged over
    the unit, from calibration.  Order of the surviving layers is kept.
    """
    _known(cfg, "layer dropping")
    if n_drop_units <= 0:
        return params, cfg, stats
    if cfg.family == "hybrid":
        return _drop_groups(params, cfg, stats, n_drop_units)
    if cfg.family == "encdec":
        return _drop_blocks(params, cfg, stats, n_drop_units)
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
        _rekey(new_stats, f"blocks.{u}", kept, keep_n, 2)
    pat = cfg.pattern()
    new_pat = unit * keep_n + pat[len(unit) * R:]
    new_cfg = cfg.replace(n_layers=len(unit) * keep_n + tail,
                          attn_pattern=new_pat if cfg.attn_pattern is not None else None)
    return params, new_cfg, CalibStats(new_stats, stats.block_sim, stats.n_tokens)


# ---------------------------------------------------------------------------
# expert pruning
# ---------------------------------------------------------------------------

def prune_experts(params, cfg, stats: CalibStats, keep_e: int):
    """Keep the ``keep_e`` most-routed experts per layer, the MoE analogue
    of structural pruning, driven by this query's routing distribution
    from calibration: importance = route count + 1e-3 * mean router
    probability, or the router's column norms without routing statistics."""
    if cfg.family != "moe" or keep_e >= cfg.n_experts:
        return params, cfg, stats
    if keep_e < cfg.top_k:
        raise ValueError(f"keep_e={keep_e} experts is below top_k={cfg.top_k}")
    params = dict(params)
    new_stats = dict(stats.weights)

    def prune_one(moe: Dict, paths: List[str]) -> Dict:
        stacked = moe["router"].dim() == 3
        R = moe["router"].shape[0] if stacked else 1
        idx = torch.zeros((R, keep_e), dtype=torch.long, device=moe["router"].device)
        for r in range(R):
            st = stats.get(paths[r] + ".router")
            if st is not None and st.route_count is not None:
                imp = st.route_count.double()
                if st.route_prob is not None:
                    imp = imp + 1e-3 * st.route_prob
            else:
                w = moe["router"][r] if stacked else moe["router"]
                imp = (w.float() ** 2).sum(0)
            idx[r] = _top(imp.to(idx.device), keep_e)
        out = dict(moe)
        for name, axis in (("router", 1), ("wi", 0), ("wg", 0), ("wo", 0)):
            out[name] = (_take_stacked(moe[name], idx, axis) if stacked
                         else torch.index_select(moe[name], axis, idx[0]))
        for r in range(R):
            for nm in ("wi", "wg", "wo"):
                key = paths[r] + "." + nm
                st = new_stats.get(key)
                if st is not None and st.sqnorm is not None:
                    i = idx[r].to(st.sqnorm.device)
                    new_stats[key] = WeightStats(
                        shape=(keep_e,) + tuple(st.shape[1:]), count=st.count,
                        H=None if st.H is None else st.H[i],
                        sqnorm=st.sqnorm[i], amax=st.amax[i])
            key = paths[r] + ".router"
            st = new_stats.get(key)
            if st is not None and st.route_count is not None:
                i = idx[r].to(st.route_count.device)
                new_stats[key] = dataclasses.replace(
                    st, route_count=st.route_count[i],
                    route_prob=None if st.route_prob is None else st.route_prob[i])
        return out

    unit, R, tail = _units(cfg)
    params["blocks"] = list(params["blocks"])
    params["tail"] = list(params["tail"])
    for u in range(len(unit)):
        blk = dict(params["blocks"][u])
        blk["moe"] = prune_one(blk["moe"], [f"blocks.{u}.{r}.moe" for r in range(R)])
        params["blocks"][u] = blk
    for i in range(tail):
        blk = dict(params["tail"][i])
        blk["moe"] = prune_one(blk["moe"], [f"tail.{i}.moe"])
        params["tail"][i] = blk
    new_cfg = cfg.replace(n_experts=keep_e, top_k=min(cfg.top_k, keep_e))
    return params, new_cfg, CalibStats(new_stats, stats.block_sim, stats.n_tokens)
