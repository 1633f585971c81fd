"""Declarative logical plan IR for OLAP queries with LLM operators.

A plan is an immutable chain of frozen dataclass nodes rooted at a
``Scan`` (the query API is linear, so every node is unary; ``LLMJoin``
carries its right table as a parameter, not a second child).  ``Query``
(olap/query.py) is a thin fluent builder over this IR; the optimizer
(olap/optimizer.py) rewrites plans by *reconstructing* chains — nodes
are never mutated in place, so a plan can be shared, cached, and
compared across rewrites safely.

Node zoo:

  ``Scan``        the input Table (leaf)
  ``Filter``      non-LLM predicate; ``columns`` is the declared read
                  set — declaring it is what licenses the optimizer to
                  push the filter below column-adding LLM ops
  ``Select``      column projection
  ``LLMMap``      prompt per row of ``col`` -> new column ``out_col``
  ``LLMCorrect``  fix each value of ``col`` -> ``out_col`` (default
                  ``col + "_fixed"``)
  ``LLMFilter``   semantic predicate: prompt per row, keep rows whose
                  model output passes ``keep``
  ``LLMJoin``     fuzzy join against ``right`` on ``on``
  ``LLMFused``    optimizer-only: adjacent same-(col, prompt) LLM ops
                  collapsed into one model pass writing every out col

``dedup`` on the per-row LLM nodes is a physical annotation set by the
optimizer's dedup rule: invoke the model once per *unique* input value
and scatter outputs back to rows (greedy decode is deterministic per
prompt, so outputs are byte-identical to the per-row path).

``accuracy_budget`` on LLM nodes opts the op into the **model
cascade** (olap/physical.py): the max fraction of rows that may be
answered by the instance-optimized proxy *and* disagree with the base
model.  ``None`` defers to the query-level default; ``0`` forces
base-only behavior.  The budget is NOT part of ``qsig`` — the same
proxy model serves every budget — and ``describe`` does not render it,
so logical-plan snapshots are budget-independent.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace
from typing import Callable, FrozenSet, List, Optional, Tuple

from repro_torch.olap.table import Table


def default_keep(out: str) -> bool:
    """LLMFilter's default verdict parser: affirmative prefix."""
    return out.strip().lower().startswith(("yes", "keep", "same", "true"))


_PRED_OPS: dict = {
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "contains": lambda a, b: str(b) in str(a),
    "prefix": lambda a, b: str(a).startswith(str(b)),
}


@dataclass(frozen=True)
class ColumnPredicate:
    """A serializable single-column comparison for ``Filter`` nodes.

    Opaque Python callables cannot cross a process boundary, so query
    plans shipped to the service as JSON (query.Query.to_spec) express
    non-LLM filters with this declarative form instead: ``col <op>
    value`` where ``op`` is one of eq/ne/lt/le/gt/ge/contains/prefix.
    It is itself a callable row predicate, so the rest of the stack
    (Table.filter, the optimizer's pushdown rule) treats it exactly
    like a lambda — with the bonus that its read set is known, so the
    builder auto-declares ``columns={col}``.
    """
    col: str
    op: str
    value: object

    def __post_init__(self):
        if self.op not in _PRED_OPS:
            raise ValueError(
                f"unknown predicate op {self.op!r}; "
                f"expected one of {sorted(_PRED_OPS)}")

    def __call__(self, row: dict) -> bool:
        return bool(_PRED_OPS[self.op](row[self.col], self.value))

    def to_dict(self) -> dict:
        return {"col": self.col, "op": self.op, "value": self.value}

    @staticmethod
    def from_dict(d: dict) -> "ColumnPredicate":
        return ColumnPredicate(col=d["col"], op=d["op"], value=d["value"])


@dataclass(frozen=True)
class PlanNode:
    """Base class; every concrete node is a frozen dataclass."""

    kind: str = field(init=False, default="node", repr=False)

    @property
    def child(self) -> Optional["PlanNode"]:
        return getattr(self, "input", None)


@dataclass(frozen=True)
class Scan(PlanNode):
    table: Table
    name: str = "scan"
    kind = "scan"


@dataclass(frozen=True)
class Filter(PlanNode):
    input: PlanNode
    pred: Callable[[dict], bool]
    # Declared read set of ``pred``.  None means "unknown": the
    # optimizer then refuses to move this filter past any op that adds
    # columns (the pred might read them).
    columns: Optional[FrozenSet[str]] = None
    kind = "filter"


@dataclass(frozen=True)
class Select(PlanNode):
    input: PlanNode
    cols: Tuple[str, ...]
    kind = "select"


@dataclass(frozen=True)
class LLMMap(PlanNode):
    input: PlanNode
    col: str
    prompt: str
    out_col: str
    max_new: int
    dedup: bool = False
    accuracy_budget: Optional[float] = None
    kind = "map"


@dataclass(frozen=True)
class LLMCorrect(PlanNode):
    input: PlanNode
    col: str
    prompt: str
    out_col: Optional[str]
    max_new: int
    dedup: bool = False
    accuracy_budget: Optional[float] = None
    kind = "correct"

    @property
    def out(self) -> str:
        return self.out_col or self.col + "_fixed"


@dataclass(frozen=True)
class LLMFilter(PlanNode):
    input: PlanNode
    col: str
    prompt: str
    max_new: int
    keep: Callable[[str], bool] = default_keep
    dedup: bool = False
    accuracy_budget: Optional[float] = None
    kind = "llm_filter"


@dataclass(frozen=True)
class LLMJoin(PlanNode):
    input: PlanNode
    right: Table
    on: Tuple[str, str]
    prompt: str
    max_new: int
    accuracy_budget: Optional[float] = None
    kind = "join"


@dataclass(frozen=True)
class LLMFused(PlanNode):
    """Fusion result: one prompt stream over ``col``, outputs fanned to
    every column in ``outs`` (in original op order).  Only created by
    the optimizer when the fused ops' templates are identical, so the
    single model pass is byte-identical to running each op alone.
    ``src_kind`` is the constituents' kind (the fusion rule only
    merges like-kinded ops), preserved so the fused node keeps its
    constituents' model-cache signature."""
    input: PlanNode
    col: str
    prompt: str
    outs: Tuple[str, ...]
    max_new: int
    src_kind: str = "map"
    dedup: bool = False
    accuracy_budget: Optional[float] = None
    kind = "fused"


LLM_KINDS = ("map", "correct", "llm_filter", "join", "fused")
# per-row LLM ops: one prompt per input row, output depends only on
# that row's value — the set the dedup rule may annotate
ROWWISE_LLM_KINDS = ("map", "correct", "llm_filter", "fused")


def is_llm(node: PlanNode) -> bool:
    return node.kind in LLM_KINDS


def with_child(node: PlanNode, child: PlanNode) -> PlanNode:
    """Immutably rebind a node's input."""
    return replace(node, input=child)


def chain(plan: PlanNode) -> List[PlanNode]:
    """The plan as a list, root first, Scan last."""
    out = []
    n: Optional[PlanNode] = plan
    while n is not None:
        out.append(n)
        n = n.child
    return out


def scan_of(plan: PlanNode) -> Scan:
    leaf = chain(plan)[-1]
    if not isinstance(leaf, Scan):
        raise ValueError(f"plan does not bottom out at a Scan: {leaf!r}")
    return leaf


def rebuild(nodes: List[PlanNode]) -> PlanNode:
    """Re-chain a root-first node list (last node must be the Scan)."""
    plan = nodes[-1]
    for n in reversed(nodes[:-1]):
        plan = with_child(n, plan)
    return plan


def added_cols(node: PlanNode) -> Tuple[str, ...]:
    """Columns this node introduces (empty for row-set-only ops)."""
    if node.kind == "map":
        return (node.out_col,)
    if node.kind == "correct":
        return (node.out,)
    if node.kind == "fused":
        return tuple(node.outs)
    return ()


def schema_at(node: PlanNode) -> FrozenSet[str]:
    """Columns available *after* this node runs (exact: the Scan's
    table is materialized, and every op's schema effect is static)."""
    if isinstance(node, Scan):
        return frozenset(node.table.columns)
    below = schema_at(node.child)
    if isinstance(node, Select):
        return frozenset(node.cols)
    if isinstance(node, LLMJoin):
        right = frozenset(f"r_{c}" for c in node.right.columns)
        return frozenset(f"l_{c}" for c in below) | right
    return below | frozenset(added_cols(node))


def qsig(node: PlanNode) -> str:
    """Query signature keying the instance-optimized model: sha256 of
    (operator kind, prompt template).  ``LLMFused`` keeps the signature
    of its constituents (same kind and identical prompts by the fusion
    rule's guard), so fusion never forks the model cache."""
    kind = node.src_kind if node.kind == "fused" else node.kind
    kind = {"llm_filter": "filter"}.get(kind, kind)
    base = f"{kind}:{getattr(node, 'prompt', '')}"
    return hashlib.sha256(base.encode()).hexdigest()[:12]


def describe(node: PlanNode) -> str:
    """One-line node rendering (stable: used by EXPLAIN snapshots)."""
    if isinstance(node, Scan):
        cols = ", ".join(node.table.columns)
        return f"Scan[{node.name}, rows={len(node.table)}, cols=({cols})]"
    if isinstance(node, Filter):
        cols = ("?" if node.columns is None
                else ", ".join(sorted(node.columns)))
        return f"Filter[reads=({cols})]"
    if isinstance(node, Select):
        return f"Select[{', '.join(node.cols)}]"
    dedup = ", dedup" if getattr(node, "dedup", False) else ""
    if isinstance(node, LLMMap):
        return (f"LLMMap[{node.col} -> {node.out_col}, "
                f"prompt={node.prompt!r}{dedup}]")
    if isinstance(node, LLMCorrect):
        return (f"LLMCorrect[{node.col} -> {node.out}, "
                f"prompt={node.prompt!r}{dedup}]")
    if isinstance(node, LLMFilter):
        return f"LLMFilter[{node.col}, prompt={node.prompt!r}{dedup}]"
    if isinstance(node, LLMJoin):
        return (f"LLMJoin[{node.on[0]} ~ {node.on[1]}, "
                f"right_rows={len(node.right)}, prompt={node.prompt!r}]")
    if isinstance(node, LLMFused):
        return (f"LLMFused[{node.col} -> ({', '.join(node.outs)}), "
                f"prompt={node.prompt!r}{dedup}]")
    return repr(node)


def render(plan: PlanNode, *, annotate=None, indent: str = "  ") -> str:
    """Tree rendering, root at top.  ``annotate(node) -> str`` appends
    per-node detail (the optimizer passes cost estimates in)."""
    lines = []
    for depth, node in enumerate(chain(plan)):
        extra = f"  {annotate(node)}" if annotate else ""
        lines.append(f"{indent * depth}{describe(node)}{extra}")
    return "\n".join(lines)


def validate(plan: PlanNode) -> None:
    """Static checks a builder bug would trip: the chain bottoms out at
    a Scan and every LLM/Filter/Select input column exists in the
    schema below it."""
    for node in chain(plan):
        if isinstance(node, Scan):
            continue
        below = schema_at(node.child)
        need: Tuple[str, ...] = ()
        if node.kind in ("map", "correct", "llm_filter", "fused"):
            need = (node.col,)
        elif isinstance(node, Select):
            need = node.cols
        elif isinstance(node, Filter) and node.columns is not None:
            need = tuple(node.columns)
        elif isinstance(node, LLMJoin):
            need = (node.on[0],)
            if node.on[1] not in node.right.columns:
                raise ValueError(
                    f"join column {node.on[1]!r} not in right table "
                    f"(has {sorted(node.right.columns)})")
        missing = [c for c in need if c not in below]
        if missing:
            raise ValueError(
                f"{describe(node)} reads missing column(s) {missing}; "
                f"available: {sorted(below)}")
    scan_of(plan)
