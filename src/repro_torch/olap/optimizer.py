"""Rule-based semantic query optimizer over the logical plan IR.

Three rewrite rules, each of which provably preserves query output
byte-for-byte (greedy decode is deterministic per prompt, so any
rewrite that keeps the per-row (prompt -> output) mapping and the
final row set/order unchanged is an identity on results):

``pushdown``
    Move a non-LLM ``Filter`` below an adjacent LLM op so the model
    never sees rows the filter would discard.  Legal below row-wise
    column-adding ops (map/correct/fused) only when the filter's
    declared read set is disjoint from the op's output columns;
    always legal below ``LLMFilter`` (two filters commute — the final
    row set is the intersection either way).  Never crosses a join
    (row identity changes).

``dedup``
    Annotate a row-wise LLM op with ``dedup=True``: the physical plan
    invokes the model once per *unique* input value and scatters the
    outputs back to rows.  Fires when the Scan column feeding the op
    has duplicate values (for optimizer-derived columns the unique
    count is unknown, so the rule stays off and the engine's result
    cache picks up residual duplicates at runtime).

``fusion``
    Collapse adjacent row-wise LLM ops reading the same column through
    the *identical* prompt template into one ``LLMFused`` pass that
    writes every output column.  Template equality is the guard that
    keeps outputs byte-identical — fusing different templates into one
    prompt would change what the model sees.

Rule order is driven by the cost model, not a fixed sequence: each
step evaluates every applicable rewrite, scores the rewritten plan by
``sum(est_rows x prompt_tokens)`` over its LLM nodes, and applies the
cheapest strictly-improving candidate (ties break on rule priority,
then textual description — fully deterministic).  Costs are integers
and every firing strictly decreases total cost, so the loop
terminates.

Every applied rewrite is additionally re-proved by the independent
plan verifier (olap/analysis.py): ``optimize`` hands the before/after
plans to ``verify_rewrite``, which derives the rule's legality
conditions from the evidence rather than trusting the guard that
fired.  A failed obligation raises ``PlanVerificationError`` with
structured diagnostics (stable ``PLAN0xx`` codes) — a buggy rule can
never silently ship a semantics-changing plan.  ``RuleFiring.verified``
records the proof and surfaces as a per-rule badge in
``Query.explain()``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

from repro_torch.olap import analysis as ANA
from repro_torch.olap import plan as P

# Deterministic planning knobs: a non-LLM filter and a semantic filter
# are both assumed to keep half their input; a fuzzy join's blocker is
# assumed to emit ~2 candidates per left row (matches _block_key's
# behavior on the paper workloads).
FILTER_SELECTIVITY = 0.5
JOIN_FANOUT = 2
DEFAULT_VALUE_TOKENS = 32   # derived columns: value length unknown
SAMPLE = 64                 # rows sampled for column statistics

# --- cascade cost model (olap/physical.py reads these) ---------------------
# A cascade runs EVERY row through the instance-optimized proxy and
# re-submits only low-confidence rows to the base model, so its cost is
#   est_escalation * base_cost + CASCADE_PROXY_COST_FACTOR * base_cost
# and the planner picks engine="cascade" exactly when that beats
# base_cost alone, i.e. est_escalation + proxy_factor < 1.  The proxy
# factor is the compressed model's relative per-row cost (quantized
# weights, smaller matmuls): the reference's constant, kept so that both
# planners choose alike; it is not a measurement of the port.
CASCADE_PROXY_COST_FACTOR = 0.25


def predicted_escalation(accuracy_budget: Optional[float]) -> float:
    """Planner-side prior on the cascade escalation rate for a given
    accuracy budget, used BEFORE any threshold is fit (the fitted rate
    from ``core.calibrate.fit_confidence_threshold`` replaces it at run
    time).  Monotone: a tighter budget accepts fewer proxy answers, so
    more rows escalate; budget 0 (or None) escalates everything — the
    cascade degenerates to base-only and the cost inequality can never
    choose it."""
    if accuracy_budget is None or accuracy_budget <= 0.0:
        return 1.0
    return min(1.0, 0.05 + 0.05 / accuracy_budget)


def cascade_wins(accuracy_budget: Optional[float]) -> bool:
    """The cost inequality ``esc * base + proxy < base`` with both sides
    normalized by base_cost (per-row costs cancel)."""
    return (predicted_escalation(accuracy_budget)
            + CASCADE_PROXY_COST_FACTOR < 1.0)


@dataclass
class ColStats:
    avg_tokens: int          # mean value length (byte tokenizer: 1/char)
    unique_frac: float       # |unique| / |rows| over the sample


@dataclass
class NodeEst:
    rows_in: int
    rows_out: int
    prompt_tokens: int = 0   # per-invocation prompt size (LLM nodes)
    invocations: int = 0     # model calls this node will make
    cost: int = 0            # invocations x prompt_tokens


@dataclass
class RuleFiring:
    rule: str
    desc: str
    cost_before: int
    cost_after: int
    # True when the independent verifier re-proved this rewrite's
    # legality from the before/after plans (olap/analysis.py)
    verified: bool = False


def column_stats(table) -> Dict[str, ColStats]:
    """Per-column stats from the (materialized) Scan table."""
    out = {}
    for name, vals in table.columns.items():
        sample = [str(v) for v in vals[:SAMPLE]]
        if not sample:
            out[name] = ColStats(DEFAULT_VALUE_TOKENS, 1.0)
            continue
        avg = max(1, round(sum(len(s) for s in sample) / len(sample)))
        uniq = len(set(sample)) / len(sample)
        out[name] = ColStats(avg, uniq)
    return out


def estimate(plan: P.PlanNode,
             stats: Optional[Dict[str, ColStats]] = None
             ) -> Dict[int, NodeEst]:
    """Bottom-up cardinality + cost estimates, keyed by ``id(node)``.

    Row counts: Scan is exact; each (LLM)Filter keeps
    ``FILTER_SELECTIVITY``; map/correct/fused/select preserve rows;
    join emits one row per estimated candidate match.  LLM cost is
    ``invocations x prompt_tokens`` with invocations reduced to the
    estimated unique count when the node is dedup-annotated.
    """
    if stats is None:
        stats = column_stats(P.scan_of(plan).table)
    est: Dict[int, NodeEst] = {}
    for node in reversed(P.chain(plan)):
        if isinstance(node, P.Scan):
            n = len(node.table)
            est[id(node)] = NodeEst(rows_in=n, rows_out=n)
            continue
        rows = est[id(node.child)].rows_out
        if isinstance(node, (P.Filter,)):
            est[id(node)] = NodeEst(rows, math.ceil(rows *
                                                    FILTER_SELECTIVITY))
            continue
        if isinstance(node, P.Select):
            est[id(node)] = NodeEst(rows, rows)
            continue
        # LLM nodes
        col = getattr(node, "col", None) or node.on[0]
        cs = stats.get(col, ColStats(DEFAULT_VALUE_TOKENS, 1.0))
        ptoks = len(node.prompt) + cs.avg_tokens
        if isinstance(node, P.LLMJoin):
            inv = rows * JOIN_FANOUT
            rows_out = rows      # ~one surviving match per left row
        else:
            inv = rows
            if getattr(node, "dedup", False):
                inv = min(inv, max(1, math.ceil(rows * cs.unique_frac)))
            rows_out = (math.ceil(rows * FILTER_SELECTIVITY)
                        if isinstance(node, P.LLMFilter) else rows)
        est[id(node)] = NodeEst(rows, rows_out, ptoks, inv, inv * ptoks)
    return est


def total_cost(plan: P.PlanNode,
               stats: Optional[Dict[str, ColStats]] = None) -> int:
    return sum(e.cost for e in estimate(plan, stats).values())


# ---------------------------------------------------------------------------
# rules — each returns every applicable (description, rewritten plan)
# ---------------------------------------------------------------------------

def _rule_pushdown(plan: P.PlanNode) -> List[Tuple[str, P.PlanNode]]:
    out = []
    nodes = P.chain(plan)
    for i, node in enumerate(nodes):
        if not isinstance(node, P.Filter):
            continue
        below = node.child
        if below is None or not P.is_llm(below):
            continue
        if below.kind == "join":
            continue            # join rewrites row identity: never cross
        adds = P.added_cols(below)
        if adds and (node.columns is None
                     or (set(node.columns) & set(adds))):
            continue            # pred might (or does) read the op's output
        swapped = P.with_child(below,
                               P.with_child(node, below.child))
        out.append((f"{P.describe(node)} below {P.describe(below)}",
                    P.rebuild(nodes[:i] + [swapped])))
    return out


def _rule_dedup(plan: P.PlanNode,
                stats: Dict[str, ColStats]) -> List[Tuple[str, P.PlanNode]]:
    out = []
    nodes = P.chain(plan)
    for i, node in enumerate(nodes):
        if node.kind not in P.ROWWISE_LLM_KINDS or node.dedup:
            continue
        # a column (re)written by any op below this one is derived —
        # even when its name shadows a Scan column, the Scan stats no
        # longer describe the values this op will read
        derived = {c for below in nodes[i + 1:]
                   for c in P.added_cols(below)}
        cs = stats.get(node.col)
        if node.col in derived or cs is None or cs.unique_frac >= 1.0:
            continue            # derived column or no duplicates: no win
        out.append((f"unique inputs only for {P.describe(node)}",
                    P.rebuild(nodes[:i] + [replace(node, dedup=True)]
                              + nodes[i + 1:])))
    return out


def _src_kind(node: P.PlanNode) -> Optional[str]:
    """The fusable constituent kind, or None when the node cannot
    fuse.  Like-kinded only: the fused node must keep its
    constituents' model-cache signature (plan.qsig), which hashes the
    kind — merging a map with a correct would have to pick one and
    fork the other's cache."""
    if node.kind in ("map", "correct"):
        return node.kind
    if node.kind == "fused":
        return node.src_kind
    return None


def _outs(node: P.PlanNode) -> Tuple[str, ...]:
    return P.added_cols(node)


def _rule_fusion(plan: P.PlanNode) -> List[Tuple[str, P.PlanNode]]:
    out = []
    nodes = P.chain(plan)
    for i, node in enumerate(nodes):
        below = node.child
        if below is None:
            continue
        kind = _src_kind(node)
        if kind is None or kind != _src_kind(below):
            continue
        same = (node.col == below.col and node.prompt == below.prompt
                and node.max_new == below.max_new
                and node.accuracy_budget == below.accuracy_budget)
        # the upper op must read the ORIGINAL column, not the lower
        # op's freshly-written output.  Differing accuracy budgets must
        # not fuse either: one fused pass has one cascade threshold,
        # which would loosen the stricter constituent's contract.
        if not same or node.col in _outs(below):
            continue
        fused = P.LLMFused(input=below.child, col=node.col,
                           prompt=node.prompt,
                           outs=_outs(below) + _outs(node),
                           max_new=node.max_new, src_kind=kind,
                           dedup=node.dedup or below.dedup,
                           accuracy_budget=node.accuracy_budget)
        out.append((f"{P.describe(below)} + {P.describe(node)}",
                    P.rebuild(nodes[:i] + [fused])))
    return out


RULES = (
    ("pushdown", lambda plan, stats: _rule_pushdown(plan)),
    ("fusion", lambda plan, stats: _rule_fusion(plan)),
    ("dedup", _rule_dedup),
)


def optimize(plan: P.PlanNode,
             stats: Optional[Dict[str, ColStats]] = None,
             *, verify: bool = True
             ) -> Tuple[P.PlanNode, List[RuleFiring]]:
    """Cost-driven greedy rewriting to a fixpoint.

    Every step scores all applicable rewrites from all rules and
    applies the one with the lowest resulting total cost; candidates
    that do not strictly improve are discarded, so the (integer) cost
    strictly decreases and the loop terminates.  Deterministic: ties
    break on rule priority order, then description.

    With ``verify`` on (the default, and what every production caller
    uses) each applied rewrite is independently re-proved by
    ``analysis.verify_rewrite`` before it replaces the plan; a failed
    proof obligation raises ``PlanVerificationError``.  ``verify=False``
    exists only so the verifier's own tests can feed it known-illegal
    rewrites.
    """
    if stats is None:
        stats = column_stats(P.scan_of(plan).table)
    firings: List[RuleFiring] = []
    while True:
        cur = total_cost(plan, stats)
        best = None
        for prio, (name, rule) in enumerate(RULES):
            for desc, cand in rule(plan, stats):
                c = total_cost(cand, stats)
                if c >= cur:
                    continue
                key = (c, prio, desc)
                if best is None or key < best[0]:
                    best = (key, name, desc, cand, c)
        if best is None:
            return plan, firings
        _, name, desc, cand, c = best
        if verify:
            diags = [d for d in ANA.verify_rewrite(plan, cand, name)
                     if d.severity == "error"]
            if diags:
                raise ANA.PlanVerificationError(diags)
        plan = cand
        firings.append(RuleFiring(name, desc, cur, c, verified=verify))
