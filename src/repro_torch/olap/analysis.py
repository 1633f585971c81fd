"""Static plan verifier: independent proof obligations for rewrites.

The optimizer's rules (olap/optimizer.py) each carry a rule-local
legality argument.  This module re-proves that argument from the
*evidence* — the before/after plans — without trusting the rule that
fired, so a bug in a rule's guard (or a hand-mutated plan) surfaces as
a structured ``Diagnostic`` at plan time instead of wrong rows at
execution time.

Two entry points:

``verify_plan(plan)``
    Full schema/column-flow inference over the IR (independent of
    ``plan.schema_at`` — this module derives schemas itself) plus the
    standing invariants of optimizer annotations: every read resolves,
    dedup only on row-wise ops over pristine Scan columns that
    actually contain duplicates, fused nodes structurally sound.

``verify_rewrite(before, after, rule)``
    Proof obligations for one rewrite step.  The changed window of the
    chain is recovered by diffing node signatures (nodes are
    reconstructed by rebinding ``input``, so signatures exclude it),
    then the window must match the claimed rule's shape AND satisfy
    the rule's legality conditions re-derived from scratch:
    read-set/output-column disjointness for pushdown, cardinality and
    pristine-column invariants for dedup, byte-identical templates and
    dependency-freedom for fusion.  Every rewrite additionally
    preserves the output schema and the scan table.

``optimize(..., verify=True)`` runs ``verify_rewrite`` after every
firing (always-on), and ``physical.lower`` runs ``verify_plan`` on the
optimized plan; failures raise ``PlanVerificationError`` carrying the
diagnostics.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import FrozenSet, List, Optional, Tuple

from repro_torch.analysis.diagnostics import Diagnostic, render_text
from repro_torch.olap import plan as P


class PlanVerificationError(ValueError):
    """An illegal plan or rewrite, with the proof that it is illegal."""

    def __init__(self, diagnostics: List[Diagnostic]):
        self.diagnostics = list(diagnostics)
        super().__init__("plan verification failed:\n"
                         + render_text(self.diagnostics))


# ---------------------------------------------------------------------------
# independent schema / column-flow inference
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NodeFlow:
    """Column flow at one node, derived from the IR alone.

    ``reads is None`` means the node's read set is unknowable (an
    opaque non-LLM filter); ``row_effect`` classifies what the node
    does to the row set: ``source`` (Scan), ``preserve`` (1:1),
    ``subset`` (filters), ``rewrite`` (join — row identity changes).
    """
    node: P.PlanNode
    schema_in: FrozenSet[str]
    schema_out: FrozenSet[str]
    reads: Optional[FrozenSet[str]]
    writes: FrozenSet[str]
    row_effect: str


def infer_flow(plan: P.PlanNode) -> List[NodeFlow]:
    """Scan-first column-flow inference over the chain."""
    flows: List[NodeFlow] = []
    schema: FrozenSet[str] = frozenset()
    for node in reversed(P.chain(plan)):
        schema_in = schema
        if isinstance(node, P.Scan):
            schema = frozenset(node.table.columns)
            flows.append(NodeFlow(node, frozenset(), schema, frozenset(),
                                  schema, "source"))
            continue
        if isinstance(node, P.Filter):
            # columns is typed FrozenSet but hand-built plans pass any
            # iterable; normalize so set algebra below is total
            reads = (None if node.columns is None
                     else frozenset(node.columns))
            flows.append(NodeFlow(node, schema_in, schema_in, reads,
                                  frozenset(), "subset"))
            continue
        if isinstance(node, P.Select):
            schema = frozenset(node.cols)
            flows.append(NodeFlow(node, schema_in, schema,
                                  frozenset(node.cols), frozenset(),
                                  "preserve"))
            continue
        if isinstance(node, P.LLMJoin):
            schema = (frozenset(f"l_{c}" for c in schema_in)
                      | frozenset(f"r_{c}" for c in node.right.columns))
            flows.append(NodeFlow(node, schema_in, schema,
                                  frozenset((node.on[0],)), schema,
                                  "rewrite"))
            continue
        # row-wise LLM ops: map / correct / llm_filter / fused
        writes = frozenset(P.added_cols(node))
        schema = schema_in | writes
        effect = "subset" if isinstance(node, P.LLMFilter) else "preserve"
        flows.append(NodeFlow(node, schema_in, schema,
                              frozenset((node.col,)), writes, effect))
    return flows


def output_schema(plan: P.PlanNode) -> FrozenSet[str]:
    return infer_flow(plan)[-1].schema_out


# ---------------------------------------------------------------------------
# node signatures — structural equality modulo the ``input`` rebind
# ---------------------------------------------------------------------------

def node_sig(node: P.PlanNode) -> Tuple:
    """The node's identity with its child excluded: rewrites rebuild
    chains by rebinding ``input``, so two nodes are "the same node
    moved" iff their non-input fields are equal (callables compare by
    identity — rebuilds carry the original objects through)."""
    vals = tuple(getattr(node, f.name)
                 for f in dataclasses.fields(node) if f.name != "input")
    return (node.kind,) + vals


def _diff_window(before: P.PlanNode, after: P.PlanNode
                 ) -> Tuple[List[P.PlanNode], List[P.PlanNode]]:
    """The minimal changed windows of the two chains (root-first):
    strip the longest common signature prefix and suffix."""
    cb, ca = P.chain(before), P.chain(after)
    sb, sa = [node_sig(n) for n in cb], [node_sig(n) for n in ca]
    lo = 0
    while lo < min(len(sb), len(sa)) and sb[lo] == sa[lo]:
        lo += 1
    hi = 0
    while (hi < min(len(sb), len(sa)) - lo
           and sb[len(sb) - 1 - hi] == sa[len(sa) - 1 - hi]):
        hi += 1
    return cb[lo:len(cb) - hi], ca[lo:len(ca) - hi]


# ---------------------------------------------------------------------------
# standing plan invariants
# ---------------------------------------------------------------------------

def _scan_table(plan: P.PlanNode):
    leaf = P.chain(plan)[-1]
    return leaf.table if isinstance(leaf, P.Scan) else None


def _has_duplicates(values) -> bool:
    seen = set()
    for v in values:
        s = str(v)
        if s in seen:
            return True
        seen.add(s)
    return False


def verify_plan(plan: P.PlanNode) -> List[Diagnostic]:
    """Standing invariants any executable plan must satisfy."""
    diags: List[Diagnostic] = []
    leaf = P.chain(plan)[-1]
    if not isinstance(leaf, P.Scan):
        return [Diagnostic("PLAN003",
                           f"plan does not bottom out at a Scan: "
                           f"{type(leaf).__name__}",
                           "plan.chain")]
    flows = infer_flow(plan)
    writes_below: set = set()
    for flow in flows:
        node = flow.node
        where = P.describe(node)
        # every declared read must resolve in the input schema
        if flow.reads is not None and not isinstance(node, P.Scan):
            missing = sorted(flow.reads - flow.schema_in)
            if missing:
                diags.append(Diagnostic(
                    "PLAN004",
                    f"reads missing column(s) {missing}; available: "
                    f"{sorted(flow.schema_in)}", where,
                    hint="the rewrite moved this node above/below the "
                         "op that provides the column"))
        if isinstance(node, P.LLMJoin) and \
                node.on[1] not in node.right.columns:
            diags.append(Diagnostic(
                "PLAN004",
                f"join column {node.on[1]!r} not in right table "
                f"(has {sorted(node.right.columns)})", where))
        # dedup annotations: row-wise, pristine scan column, duplicates
        if getattr(node, "dedup", False):
            diags.extend(_check_dedup_node(node, writes_below, leaf.table,
                                           where))
        if isinstance(node, P.LLMFused):
            diags.extend(_check_fused_node(node, where))
        writes_below |= set(flow.writes) if flow.row_effect != "source" \
            else set()
    return diags


def _check_dedup_node(node: P.PlanNode, writes_below: set, table,
                      where: str) -> List[Diagnostic]:
    diags = []
    if node.kind not in P.ROWWISE_LLM_KINDS:
        diags.append(Diagnostic(
            "PLAN020", f"dedup annotation on non-row-wise op "
            f"{node.kind!r}", where,
            hint="dedup's scatter only preserves outputs when each "
                 "row's result is a pure function of its value"))
        return diags
    if node.col in writes_below:
        diags.append(Diagnostic(
            "PLAN021",
            f"dedup reads {node.col!r}, which an op below (re)writes — "
            "the Scan column's value distribution no longer applies",
            where,
            hint="drop the annotation; the engine's result cache "
                 "picks up residual duplicates at runtime"))
    elif node.col not in table.columns:
        diags.append(Diagnostic(
            "PLAN021",
            f"dedup reads {node.col!r}, which is not a Scan column",
            where))
    elif not _has_duplicates(table.columns[node.col]):
        diags.append(Diagnostic(
            "PLAN022",
            f"dedup on {node.col!r}, but the column's values are all "
            "unique — the rewrite's cardinality premise is false",
            where,
            hint="the rule only fires when the Scan column has "
                 "duplicate values"))
    return diags


def _check_fused_node(node: P.LLMFused, where: str) -> List[Diagnostic]:
    diags = []
    if len(node.outs) < 2:
        diags.append(Diagnostic(
            "PLAN030", f"fused node writes {len(node.outs)} column(s); "
            "fusion merges at least two ops", where))
    if len(set(node.outs)) != len(node.outs):
        diags.append(Diagnostic(
            "PLAN030", f"fused node writes duplicate columns "
            f"{list(node.outs)}", where))
    if node.col in node.outs:
        diags.append(Diagnostic(
            "PLAN033",
            f"fused node reads {node.col!r} and also writes it — a "
            "constituent depended on another's output", where,
            hint="fusion is only byte-identical when every constituent "
                 "reads the original column"))
    if node.src_kind not in ("map", "correct"):
        diags.append(Diagnostic(
            "PLAN030", f"fused src_kind {node.src_kind!r} is not a "
            "fusable row-wise kind", where))
    return diags


# ---------------------------------------------------------------------------
# per-rewrite proof obligations
# ---------------------------------------------------------------------------

def verify_rewrite(before: P.PlanNode, after: P.PlanNode,
                   rule: str) -> List[Diagnostic]:
    """Re-prove one rewrite's legality from the before/after plans."""
    where = f"optimizer.{rule}"
    diags: List[Diagnostic] = []
    # generic obligations first — they hold for every rule
    if _scan_table(before) is not _scan_table(after):
        diags.append(Diagnostic(
            "PLAN002", "rewrite replaced the scan table", where))
    sb, sa = output_schema(before), output_schema(after)
    if sb != sa:
        diags.append(Diagnostic(
            "PLAN001",
            f"output schema changed: {sorted(sb)} -> {sorted(sa)}",
            where,
            hint="a legal rewrite removes/reorders/merges model "
                 "invocations; it never changes what columns come out"))
    diags.extend(verify_plan(after))
    checker = {"pushdown": _verify_pushdown, "dedup": _verify_dedup,
               "fusion": _verify_fusion}.get(rule)
    if checker is None:
        diags.append(Diagnostic(
            "PLAN099", f"no proof obligations registered for rule "
            f"{rule!r}", where,
            hint="add a checker in olap/analysis.py before shipping a "
                 "new rewrite rule"))
        return diags
    diags.extend(checker(before, after, where))
    return diags


def _verify_pushdown(before: P.PlanNode, after: P.PlanNode,
                     where: str) -> List[Diagnostic]:
    wb, wa = _diff_window(before, after)
    shape_ok = (len(wb) == 2 and len(wa) == 2
                and isinstance(wb[0], P.Filter)
                and node_sig(wb[0]) == node_sig(wa[1])
                and node_sig(wb[1]) == node_sig(wa[0]))
    if not shape_ok:
        return [Diagnostic(
            "PLAN010",
            f"changed window is not a filter/op swap: "
            f"{[n.kind for n in wb]} -> {[n.kind for n in wa]}", where)]
    filt, op = wb[0], wb[1]
    diags: List[Diagnostic] = []
    if not P.is_llm(op):
        # pushing below a non-LLM op never fires today; treat as a
        # shape violation so a rule drift is loud
        diags.append(Diagnostic(
            "PLAN010", f"filter crossed a non-LLM op {op.kind!r}",
            where))
        return diags
    if op.kind == "join":
        diags.append(Diagnostic(
            "PLAN011",
            "filter crossed a join — join output rows are not the "
            "filter's input rows (l_/r_ renaming, fanout)", where,
            hint="pushdown must stop above any join"))
        return diags
    adds = set(P.added_cols(op))
    if adds:
        if filt.columns is None:
            diags.append(Diagnostic(
                "PLAN013",
                f"filter with an undeclared read set crossed "
                f"{op.kind!r}, which adds columns {sorted(adds)} — the "
                "predicate might read them", where,
                hint="declare the filter's read set via "
                     "Query.filter(..., columns=[...])"))
        elif set(filt.columns) & adds:
            diags.append(Diagnostic(
                "PLAN012",
                f"filter reads {sorted(set(filt.columns) & adds)}, "
                f"which {op.kind!r} produces — below the op those "
                "values do not exist yet", where))
    return diags


def _verify_dedup(before: P.PlanNode, after: P.PlanNode,
                  where: str) -> List[Diagnostic]:
    wb, wa = _diff_window(before, after)
    def _undedup_sig(n):
        return node_sig(dataclasses.replace(n, dedup=False)) \
            if hasattr(n, "dedup") else node_sig(n)
    shape_ok = (len(wb) == 1 and len(wa) == 1
                and hasattr(wa[0], "dedup")
                and not getattr(wb[0], "dedup", False)
                and getattr(wa[0], "dedup", False)
                and _undedup_sig(wb[0]) == _undedup_sig(wa[0]))
    if not shape_ok:
        return [Diagnostic(
            "PLAN020",
            f"changed window is not a single dedup annotation: "
            f"{[n.kind for n in wb]} -> {[n.kind for n in wa]}", where)]
    # the annotation's own invariants (row-wise / pristine column /
    # actual duplicates) are re-derived by verify_plan(after), which
    # the caller always runs; nothing further to prove here
    return []


def _constituents(node: P.PlanNode) -> Optional[List[P.PlanNode]]:
    """A fusable node as its flat constituent list, or None."""
    if node.kind in ("map", "correct"):
        return [node]
    if node.kind == "fused":
        return [node]
    return None


def _verify_fusion(before: P.PlanNode, after: P.PlanNode,
                   where: str) -> List[Diagnostic]:
    wb, wa = _diff_window(before, after)
    if not (len(wa) == 1 and isinstance(wa[0], P.LLMFused)
            and len(wb) >= 2):
        return [Diagnostic(
            "PLAN030",
            f"changed window is not a many-to-one fuse: "
            f"{[n.kind for n in wb]} -> {[n.kind for n in wa]}", where)]
    fused = wa[0]
    parts: List[P.PlanNode] = []
    for n in wb:
        c = _constituents(n)
        if c is None:
            return [Diagnostic(
                "PLAN030", f"constituent {n.kind!r} is not a fusable "
                "row-wise op", where)]
        parts.extend(c)
    diags: List[Diagnostic] = []
    # (1) byte-identical templates: every constituent reads the same
    # column through the same prompt with the same decode budget, and
    # its kind matches the fused node's src_kind — re-derived from the
    # nodes themselves, not from the rule's guard
    for p in parts:
        kind = p.src_kind if p.kind == "fused" else p.kind
        if kind != fused.src_kind:
            diags.append(Diagnostic(
                "PLAN031",
                f"constituent kind {kind!r} != fused src_kind "
                f"{fused.src_kind!r} — fusing across kinds forks the "
                "model-cache signature", where))
        if p.prompt != fused.prompt:
            diags.append(Diagnostic(
                "PLAN031",
                f"constituent prompt {p.prompt!r} != fused prompt "
                f"{fused.prompt!r} — one model pass would change what "
                "the model sees", where,
                hint="fusion requires byte-equal templates"))
        if getattr(p, "col", None) != fused.col:
            diags.append(Diagnostic(
                "PLAN031",
                f"constituent reads {getattr(p, 'col', None)!r} but "
                f"the fused pass reads {fused.col!r}", where))
        if p.max_new != fused.max_new:
            diags.append(Diagnostic(
                "PLAN031",
                f"constituent max_new={p.max_new} != fused "
                f"max_new={fused.max_new}", where))
        if getattr(p, "accuracy_budget", None) != fused.accuracy_budget:
            diags.append(Diagnostic(
                "PLAN031",
                f"constituent accuracy_budget="
                f"{getattr(p, 'accuracy_budget', None)} != fused "
                f"accuracy_budget={fused.accuracy_budget} — one fused "
                "pass has one cascade threshold, which would loosen the "
                "stricter constituent's contract", where))
    # (2) output fan-out: the fused outs are exactly the constituents'
    # outs in execution (scan->root) order
    expect: Tuple[str, ...] = ()
    for p in reversed(parts):          # chain windows are root-first
        expect = expect + P.added_cols(p)
    if expect != tuple(fused.outs):
        diags.append(Diagnostic(
            "PLAN032",
            f"fused outs {list(fused.outs)} != constituents' outs "
            f"{list(expect)} in execution order", where))
    # (3) dependency freedom: no constituent may read another's output
    # (all read fused.col, so it must not be among the outs)
    if fused.col in expect:
        diags.append(Diagnostic(
            "PLAN033",
            f"a constituent writes the read column {fused.col!r}; the "
            "ops were data-dependent and cannot share one prompt "
            "stream", where))
    return diags
