"""Physical planner: lower an optimized logical plan to executable ops.

Lowering walks the (optimizer-rewritten) chain Scan -> root and emits
one physical step per node:

  - non-LLM nodes (``Filter``/``Select``) become ``TableStep``s — pure
    Table -> Table functions executed inline by whichever executor
    drives the plan;
  - LLM nodes become ``PhysicalOp``s annotated with everything an
    executor needs to route the work: the model-cache query signature
    ``qsig``, the **engine choice** (``"optimized"`` = run the
    instance-optimization workflow and serve from the compressed
    recipe, ``"base"`` = the uncompressed model), the placement
    (``"pool"``: the session's shared byte-budgeted ``ModelPool``;
    ``"private"``: a per-operator engine), the resolved kernel backend,
    the shared **prefix template**, and the dedup flag + cost estimate
    the optimizer attached.

Execution is a *generator protocol* an executor drives (the serial
``Query.run`` and the multi-tenant scheduler's ``QueryDriver``,
serving/scheduler.py, drive the same protocol):
``execute(pplan)`` yields one ``ExecutableOp`` per LLM step — probe
sample and dedup-wrapped ``OpSpec`` built against the table state at
that point — and expects the executor to ``send`` back the output rows
(one per spec prompt); the final Table travels out via
``StopIteration.value``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

from repro_torch.kernels.backend import resolve_backend
from repro_torch.olap import analysis as ANA
from repro_torch.olap import operators as OPS
from repro_torch.olap import optimizer as OPT
from repro_torch.olap import plan as P
from repro_torch.olap.table import Table


@dataclass
class TableStep:
    """A non-LLM step: pure table transform, runs inline."""
    node: P.PlanNode
    apply: Callable[[Table], Table]


@dataclass
class PhysicalOp:
    """Static annotation of one LLM step (what EXPLAIN renders)."""
    node: P.PlanNode
    qsig: str
    engine: str          # "optimized" | "base" | "cascade"
    backend: str         # resolved KernelBackend: "reference" | "cuda"
    placement: str       # "pool" | "private"
    prefix: str
    dedup: bool
    max_new: int
    est: OPT.NodeEst
    # cascade annotations (engine == "cascade"): the effective per-op
    # accuracy budget (node override, else the query-level default) and
    # the planner's escalation prior — the fitted threshold replaces it
    # at run time (core/calibrate.py fit_confidence_threshold)
    accuracy_budget: Optional[float] = None
    est_escalation: float = 1.0


@dataclass
class PhysicalPlan:
    logical: P.PlanNode              # the plan as built
    optimized: P.PlanNode            # after rule rewriting
    steps: List[Union[TableStep, PhysicalOp]]     # Scan -> root order
    firings: List[OPT.RuleFiring]
    est: Dict[int, OPT.NodeEst]      # id(node) -> estimate (optimized)
    logical_cost: int
    optimized_cost: int

    @property
    def llm_ops(self) -> List[PhysicalOp]:
        return [s for s in self.steps if isinstance(s, PhysicalOp)]


@dataclass
class ExecutableOp:
    """One LLM step, bound to the live table state: ready to route to
    an engine.  ``spec.prompts`` is the (dedup-wrapped) prompt stream;
    the executor sends the aligned outputs back into the generator."""
    qsig: str
    probe: List[str]
    spec: OPS.OpSpec
    optimize: bool       # engine choice as a routing bool
    op: PhysicalOp


def lower(logical: P.PlanNode, *, optimize_models: bool = True,
          pooled: bool = False, use_optimizer: bool = True,
          verify: bool = True, backend: str = "auto", device="cuda",
          cascade_budget: Optional[float] = None,
          cascade: str = "auto") -> PhysicalPlan:
    """plan -> verify -> optimize (each rewrite re-proved) -> verify ->
    physical steps.

    The two verifier passes are the execution-time firewall: a
    hand-mutated plan carrying an illegal optimizer annotation (a
    dedup over a derived column, a fused node whose constituents were
    data-dependent, ...) raises ``PlanVerificationError`` with stable
    ``PLAN0xx`` diagnostics *here*, instead of producing wrong rows
    from an engine later.

    Cascades: an LLM node whose effective accuracy budget (its own
    ``accuracy_budget``, else ``cascade_budget``) is positive may be
    annotated ``engine="cascade"`` — every row runs the
    instance-optimized proxy first and only low-confidence rows
    re-submit to the base model.  ``cascade="auto"`` applies the cost
    inequality ``est_escalation * base + proxy < base``
    (olap/optimizer.py); ``"force"`` cascades every budgeted op;
    ``"off"`` disables the strategy.  Requires ``optimize_models=True``
    (the proxy IS the instance-optimized model).
    """
    if cascade not in ("auto", "force", "off"):
        raise ValueError(f"cascade must be auto/force/off, got {cascade!r}")
    P.validate(logical)
    if verify:
        pre = [d for d in ANA.verify_plan(logical)
               if d.severity == "error"]
        if pre:
            raise ANA.PlanVerificationError(pre)
    stats = OPT.column_stats(P.scan_of(logical).table)
    logical_cost = OPT.total_cost(logical, stats)
    if use_optimizer:
        optimized, firings = OPT.optimize(logical, stats, verify=verify)
    else:
        optimized, firings = logical, []
    if verify:
        post = [d for d in ANA.verify_plan(optimized)
                if d.severity == "error"]
        if post:
            raise ANA.PlanVerificationError(post)
    est = OPT.estimate(optimized, stats)
    engine = "optimized" if optimize_models else "base"
    # "auto" resolves HERE from the session's device (cuda on a CUDA
    # device, reference on the CPU) so EXPLAIN shows the kernel backend
    # each op will actually run on
    kbackend = resolve_backend(backend, device)
    placement = "pool" if pooled else "private"
    steps: List[Union[TableStep, PhysicalOp]] = []
    for node in reversed(P.chain(optimized)):
        if isinstance(node, P.Scan):
            continue
        if isinstance(node, P.Filter):
            steps.append(TableStep(node,
                                   lambda t, n=node: t.filter(n.pred)))
        elif isinstance(node, P.Select):
            steps.append(TableStep(node,
                                   lambda t, n=node: t.select(n.cols)))
        else:
            budget = getattr(node, "accuracy_budget", None)
            if budget is None:
                budget = cascade_budget
            node_engine, esc = engine, 1.0
            # "force" cascades every budgeted op — including budget 0,
            # where the threshold fits to inf and the op degenerates to
            # base-only at run time (the exactness contract); "auto"
            # only cascades when the cost inequality wins, which a
            # zero budget never does
            if (engine == "optimized" and cascade != "off"
                    and budget is not None
                    and (cascade == "force"
                         or (budget > 0 and OPT.cascade_wins(budget)))):
                node_engine = "cascade"
                esc = OPT.predicted_escalation(budget)
            steps.append(PhysicalOp(
                node=node, qsig=P.qsig(node), engine=node_engine,
                backend=kbackend, placement=placement, prefix=node.prompt,
                dedup=getattr(node, "dedup", False),
                max_new=node.max_new, est=est[id(node)],
                accuracy_budget=budget if node_engine == "cascade" else None,
                est_escalation=esc))
    return PhysicalPlan(logical=logical, optimized=optimized, steps=steps,
                        firings=firings, est=est,
                        logical_cost=logical_cost,
                        optimized_cost=sum(e.cost for e in est.values()))


def build_spec(node: P.PlanNode, t: Table) -> OPS.OpSpec:
    """The node's OpSpec against the live table state (dedup-wrapped
    when the optimizer annotated the node)."""
    dedup = getattr(node, "dedup", False)
    if isinstance(node, P.LLMMap):
        return OPS.map_spec(t, node.col, prompt=node.prompt,
                            out_col=node.out_col, max_new=node.max_new,
                            dedup=dedup)
    if isinstance(node, P.LLMCorrect):
        return OPS.correct_spec(t, node.col, prompt=node.prompt,
                                out_col=node.out_col, max_new=node.max_new,
                                dedup=dedup)
    if isinstance(node, P.LLMFilter):
        return OPS.filter_spec(t, node.col, prompt=node.prompt,
                               max_new=node.max_new, keep=node.keep,
                               dedup=dedup)
    if isinstance(node, P.LLMFused):
        return OPS.fused_spec(t, node.col, prompt=node.prompt,
                              outs=node.outs, max_new=node.max_new,
                              dedup=dedup)
    if isinstance(node, P.LLMJoin):
        return OPS.join_spec(t, node.right, node.on, prompt=node.prompt,
                             max_new=node.max_new)
    raise ValueError(f"not an LLM node: {node!r}")


def build_probe(node: P.PlanNode, t: Table, n_probe: int) -> List[str]:
    """Bounded calibration sample for the operator (the optimizer
    reads at most calib+eval rows and a 64-row data signature); the
    full column streams through the engine chunk-wise, never
    materialized as prompts here."""
    if isinstance(node, P.LLMJoin):
        # honor the caller's bound: ceil(n_probe/2) left values x 2
        # right values, capped at n_probe total — the cascade threshold
        # is fit on this probe, so a hardcoded slice would silently
        # ignore a caller asking for a larger (or smaller) fit sample
        n_left = max(1, -(-n_probe // 2))
        out = [f"{node.prompt}{a} | {b}"
               for a in t[node.on[0]][:n_left]
               for b in node.right[node.on[1]][:2]]
        return out[:n_probe]
    return [node.prompt + str(v) for v in t[node.col][:n_probe]]


def execute(pplan: PhysicalPlan, *, n_probe: int = 64):
    """The physical plan as a coroutine of LLM-operator submissions
    (see module docstring); every executor drives this one generator."""
    t = P.scan_of(pplan.optimized).table
    for step in pplan.steps:
        if isinstance(step, TableStep):
            t = step.apply(t)
            continue
        spec = build_spec(step.node, t)
        probe = build_probe(step.node, t, n_probe)
        outs = yield ExecutableOp(qsig=step.qsig, probe=probe, spec=spec,
                                  optimize=step.engine in ("optimized",
                                                           "cascade"),
                                  op=step)
        t = spec.finish(outs)
    return t
