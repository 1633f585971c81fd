"""Query pipeline with LLM-operator interception (the IOLM-DB workflow).

``Query`` is a fluent builder over the declarative logical plan IR
(olap/plan.py).  Execution is staged: the plan is rewritten by the
rule-based semantic optimizer (olap/optimizer.py — non-LLM predicate
pushdown below LLM ops, distinct-input dedup, same-template fusion),
lowered to annotated physical ops (olap/physical.py), and only then
driven through engines; ``Query.explain()`` renders the whole pipeline
without executing.  When the plan contains an LLM operator and
instance-optimization is enabled, execution:

  1. draws a **calibration sample** from the operator's actual input
     column (prompt-formatted — the model sees exactly the query's
     distribution),
  2. runs the InstanceOptimizer (calibrate -> recipe search -> Perf/Acc
     variant per the requested objective),
  3. executes the operator on an Engine wrapping the compressed model,
  4. memoizes the compressed model per (query signature, data signature)
     so repeated/interactive queries skip re-optimization (paper §2
     "recurring or predictable patterns").

The session lives on one device (``device=``, default ``"cuda"``; asking
for CUDA without a card raises): the base model, the calibration and
evaluation batches, every compressed instance in the model cache and
every engine sit there.  The session's kernel backend scopes the recipe
search as well as its engines, so a ``"reference"`` session launches no
kernel at all.  With ``pool_budget=`` (or ``pool=``) the engines come
from one shared byte-budgeted ``ModelPool`` (serving/scheduler.py),
which a ``Scheduler`` drives across tenants; with ``mesh=`` that pool
admits a model too big for one position as one tensor-parallel engine.
"""
from __future__ import annotations

import hashlib
import math
import time
from collections import OrderedDict
from dataclasses import dataclass
from textwrap import indent
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.core.calibrate import CascadeCalibration, fit_confidence_threshold
from repro_torch.core.pipeline import InstanceOptimizer, Recipe, needs_hessian
from repro_torch.core import policy as POL
from repro_torch.core.compressed import kernel_backend
from repro_torch.kernels.backend import normalize_backend, resolve_device
from repro_torch.olap import operators as OPS
from repro_torch.olap import physical as PHYS
from repro_torch.olap import plan as PLAN
from repro_torch.olap.table import Table
from repro_torch.serving.engine import Engine, _to_device
from repro_torch.serving.scheduler import ModelPool
from repro_torch.training.data import ByteTokenizer, PROMPTS


@dataclass
class OptimizedModel:
    params: Any
    cfg: Any
    report: Any
    recipe: Recipe
    version: str


class ModelCache:
    """(query signature, data signature) -> compressed model.

    LRU with a capacity cap: a multi-tenant session sees an unbounded
    stream of (query, data) pairs, and each entry holds a full
    compressed parameter set — without eviction the cache would grow
    with tenant count forever.
    """

    def __init__(self, capacity: int = 32):
        self.capacity = capacity
        self._d: "OrderedDict[Tuple[str, str], OptimizedModel]" = \
            OrderedDict()
        self.hits = 0
        self.evictions = 0

    @staticmethod
    def data_signature(values: List[str], k: int = 64) -> str:
        """Order-sensitive digest of a value sample.

        Collision-resistant beyond the head: mixes in the total value
        count, a tail sample (columns often share a head — e.g. sorted
        or defaulted values — and differ late), and each value's length
        so that truncated long values with a common 256-char prefix
        still separate.
        """
        h = hashlib.sha256()
        h.update(f"n={len(values)}".encode())
        sample = list(values[:k])
        if len(values) > k:
            sample += list(values[-k:])
        for v in sample:
            s = str(v)
            h.update(f"|{len(s)}:".encode())
            h.update(s[:256].encode())
        return h.hexdigest()[:16]

    def get(self, qsig: str, dsig: str) -> Optional[OptimizedModel]:
        m = self._d.get((qsig, dsig))
        if m is not None:
            self._d.move_to_end((qsig, dsig))
            self.hits += 1
        return m

    def put(self, qsig: str, dsig: str, m: OptimizedModel) -> None:
        self._d[(qsig, dsig)] = m
        self._d.move_to_end((qsig, dsig))
        if len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._d)


def _require_text_model(cfg) -> None:
    """A session feeds its models tokens only, as the reference's does: an
    encdec model's decoder needs ``enc_inputs`` for every row, which no
    operator carries, so its queries are refused before any build (the
    reference's fail in calibration, which reads ``batch["enc_inputs"]``).
    A vlm's queries run on the text alone."""
    if getattr(cfg, "family", None) == "encdec":
        raise ValueError(
            f"{cfg.name}: an encdec model's queries need enc_inputs for every row, "
            "which the session does not pass; serve it through Engine(extra_inputs="
            "{'enc_inputs': ...})")


class IOLMSession:
    """Holds the base model + optimization machinery across queries.

    With ``pool_budget`` set (or an explicit ``pool``), the session
    stops building a private engine per operator and instead draws
    engines from a shared byte-budgeted ``ModelPool``
    (serving/scheduler.py): engines persist across queries, many
    tenants' compressed models co-reside under one budget, and
    identical (model-version, prompt) work dedups across tenants
    through each pooled engine's result cache.  The pool's engines get
    the session's ``engine_kw``, so its ``device`` and ``backend`` too.

    ``devices=`` (a list of ``torch.device``s) makes that pool
    device-aware: the budget turns per-device and ``placement=`` picks
    each engine's device.  ``mesh=`` (a ``launch/mesh.py`` ``Mesh``) makes
    it mesh-aware: the budget turns per position, and a model over it
    whose share of the mesh fits is admitted as one tensor-parallel
    engine over every position.  Both configure a NEW pool, so they need
    ``pool_budget=`` and refuse ``pool=``, as in the reference.  Without
    a pool every operator gets a private engine on the session's
    ``device``, where the recipe search runs too.
    """

    def __init__(self, params, cfg, *, tokenizer: Optional[ByteTokenizer] = None,
                 objective: str = "perf", acc_floor: float = 0.9,
                 recipes: Optional[List[Recipe]] = None,
                 calib_rows: int = 16, eval_rows: int = 8,
                 engine_kw: Optional[Dict] = None,
                 pool_budget: Optional[int] = None,
                 pool: Optional[ModelPool] = None,
                 devices: Optional[List] = None,
                 mesh=None,
                 placement: str = "least_loaded",
                 backend: str = "auto",
                 device="cuda"):
        if pool is not None and (devices is not None or mesh is not None):
            raise ValueError("devices=/mesh= configure a NEW ModelPool and "
                             "are ignored with an explicit pool= — "
                             "construct the pool with them instead")
        if pool is None and pool_budget is None and (devices is not None
                                                     or mesh is not None):
            raise ValueError("devices=/mesh= require pool_budget= "
                             "(they configure the shared ModelPool)")
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.cfg = cfg
        self.tok = tokenizer or ByteTokenizer(max(cfg.vocab_size, 260))
        self.objective = objective
        self.acc_floor = acc_floor
        self.recipes = recipes
        self.calib_rows = calib_rows
        self.eval_rows = eval_rows
        self.model_cache = ModelCache()
        # fitted cascade thresholds, keyed (qsig, dsig, budget): the
        # same proxy model serves every budget (budget is not in qsig),
        # but each budget has its own acceptance threshold
        self.cascade_cache: Dict[Tuple[str, str, float],
                                 CascadeCalibration] = {}
        # KernelBackend for the recipe search and every engine this
        # session builds; an explicit engine_kw["backend"] wins for engines
        self.backend = normalize_backend(backend)
        self.engine_kw = dict(engine_kw or {})
        self.engine_kw.setdefault("backend", self.backend)
        self.engine_kw["device"] = self.device
        # pipeline counters: a repeated (qsig, dsig) must be answered with
        # both unchanged
        self.recalibrations = 0       # full InstanceOptimizer runs
        self.cascade_fits = 0         # cascade threshold fits
        self.log: List[str] = []
        self.pool = pool
        if pool is None and pool_budget is not None:
            self.pool = ModelPool(self, pool_budget, engine_kw=self.engine_kw,
                                  devices=devices, mesh=mesh, placement=placement)

    # -- engines --------------------------------------------------------
    def base_engine(self) -> Engine:
        _require_text_model(self.cfg)
        if self.pool is not None:
            return self.pool.engine_for("base", optimize=False)
        return Engine(self.params, self.cfg, tokenizer=self.tok,
                      version="base", **self.engine_kw)

    def optimized_engine(self, qsig: str, prompts: List[str]) -> Engine:
        if self.pool is not None:
            return self.pool.engine_for(qsig, prompts, optimize=True)
        m = self._optimize(qsig, prompts)
        return Engine(m.params, m.cfg, tokenizer=self.tok,
                      version=m.version, **self.engine_kw)

    # -- cascade calibration --------------------------------------------
    def _cascade(self, qsig: str, prompts: List[str], budget: float, *,
                 max_new: int = 12) -> CascadeCalibration:
        """Fit (and memoize) the cascade acceptance threshold for one
        operator: run the held-out slice of the probe through BOTH the
        instance-optimized proxy and the base model, score agreement,
        and pick the smallest confidence threshold whose
        accepted-but-disagreeing fraction stays within ``budget``
        (core/calibrate.py).  Deterministic for a fixed probe: greedy
        decode on both sides, and the fit is a pure function of the
        (confidence, agreement) sample."""
        dsig = ModelCache.data_signature(prompts)
        key = (qsig, dsig, float(budget))
        hit = self.cascade_cache.get(key)
        if hit is not None:
            return hit
        self.cascade_fits += 1
        if budget <= 0.0:
            cal = fit_confidence_threshold([], [], 0.0)
        else:
            hold = (prompts[self.calib_rows:
                            self.calib_rows + self.eval_rows]
                    or prompts[: self.eval_rows])
            proxy = self.optimized_engine(qsig, prompts)
            if hasattr(proxy, "generate_stream"):
                reqs = proxy.generate_stream(list(hold), max_new=max_new,
                                             return_requests=True)
                proxy_outs = [r.text for r in reqs]
                confs = [r.confidence for r in reqs]
            else:                       # fakes / remote backends
                proxy_outs = proxy.generate(list(hold), max_new=max_new)
                confs = [0.0] * len(proxy_outs)   # no signal: escalate
            base_outs = OPS._invoke(self.base_engine(), list(hold),
                                    max_new=max_new)
            agree = [p == b for p, b in zip(proxy_outs, base_outs)]
            cal = fit_confidence_threshold(confs, agree, budget)
        self.cascade_cache[key] = cal
        self.log.append(
            f"[cascade] {qsig}: threshold={cal.threshold:.4f} "
            f"est_escalation={cal.expected_escalation:.2f} "
            f"(budget={budget:g}, {cal.n_fit} holdout rows)")
        return cal

    def cascade_threshold_for(self, qsig: str,
                              budget: Optional[float]) -> Optional[float]:
        """The fitted threshold for (qsig, budget) if any probe has been
        calibrated yet, else None (EXPLAIN renders 'unfit')."""
        if budget is None:
            return None
        for (q, _, b), cal in self.cascade_cache.items():
            if q == qsig and b == float(budget):
                return cal.threshold
        return None

    # -- the instance-optimization workflow ------------------------------
    def _optimize(self, qsig: str, prompts: List[str]) -> OptimizedModel:
        _require_text_model(self.cfg)
        dsig = ModelCache.data_signature(prompts)
        cached = self.model_cache.get(qsig, dsig)
        if cached is not None:
            self.log.append(f"[iolm] model cache hit for {qsig}")
            return cached
        self.recalibrations += 1
        t0 = time.time()
        sample = prompts[: self.calib_rows]
        toks, _ = self.tok.pad_batch(
            [self.tok.encode(p, bos=True) for p in sample],
            seq_len=max(16, max(len(p) + 2 for p in sample)))
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        recipes = self.recipes or POL.default_recipe_space(self.cfg)
        hold = prompts[self.calib_rows:
                       self.calib_rows + self.eval_rows] or sample
        htoks, hlens = self.tok.pad_batch(
            [self.tok.encode(p, bos=True) + [self.tok.SEP] for p in hold],
            seq_len=max(16, max(len(p) + 3 for p in hold)))
        with kernel_backend(self.backend):
            opt = InstanceOptimizer(self.params, self.cfg)
            # Hessians only where a recipe reads them: an MoE model's expert
            # Hessians alone outgrow the card (119.5 GB for qwen2-moe-a2.7b)
            opt.run_calibration(batch, hessian=any(needs_hessian(r) for r in recipes))
            eval_fn = POL.make_agreement_eval(
                self.params, self.cfg, torch.from_numpy(htoks).to(self.device),
                max_new=12, lengths=torch.from_numpy(hlens).to(self.device))
            outcome = POL.search(opt, eval_fn, recipes,
                                 acc_floor=self.acc_floor, keep_params=True)
        pick = outcome.perf if self.objective == "perf" else outcome.acc
        if pick is None:  # nothing survived: identity model
            m = OptimizedModel(self.params, self.cfg, None,
                               Recipe(name="identity"), "base")
        else:
            # the version carries the DATA signature too: compression is
            # calibration-dependent, so same-prompt queries over
            # different data are different models — result-cache and
            # prefix-cache keys must never collapse them onto one
            # tenant's params
            m = OptimizedModel(pick.params, pick.cfg, pick.report,
                               pick.recipe,
                               f"{qsig}:{dsig}:{pick.recipe.name}")
            self.log.append(
                f"[iolm] {qsig}: picked {pick.recipe.name} "
                f"acc={pick.result.accuracy:.2f} "
                f"{pick.result.bytes / 1e6:.1f}MB "
                f"({time.time() - t0:.1f}s to optimize)")
        self.model_cache.put(qsig, dsig, m)
        return m


# ---------------------------------------------------------------------------
# the fluent builder over the logical plan IR
# ---------------------------------------------------------------------------

@dataclass
class OpRunStats:
    """Per-LLM-operator execution record from the last ``run()``.
    ``invocations`` counts prompts actually sent to the engine — with
    the optimizer's dedup/pushdown/fusion rules on, this is the number
    the rules exist to shrink.  For cascade ops, ``escalated`` is the
    subset of those rows that re-submitted to the base model (the
    full-model-invocation metric) and ``threshold`` the fitted
    acceptance cut."""
    kind: str
    qsig: str
    invocations: int
    engine: str = ""
    escalated: int = 0
    threshold: Optional[float] = None


class Query:
    """Thin fluent builder over the logical plan IR (olap/plan.py).

    Each builder call appends one immutable plan node; nothing runs
    until an executor drives the plan.  Execution is
    plan -> optimize (olap/optimizer.py rules: pushdown, dedup,
    fusion) -> lower (olap/physical.py) -> execute; ``explain()``
    renders the whole pipeline with cost estimates and the rules that
    fired.  ``optimize=`` picks the model engine (instance-optimized
    recipe vs base); ``optimize_plan=`` toggles the plan rewriter.
    The rules only remove, reorder, or merge model invocations whose
    results are determined, so for a fixed model the outputs are
    byte-identical either way.  One caveat under ``optimize=True``:
    pushdown also shrinks the calibration probe, so
    calibration-dependent recipes may resolve to a different
    compressed instance — pin ``recipes=`` to a deterministic
    weight-only recipe when exact on-vs-off equality matters (see
    olap/README.md).
    """

    def __init__(self, table: Table, session: IOLMSession, *,
                 optimize: bool = True, optimize_plan: bool = True,
                 cascade_budget: Optional[float] = None,
                 cascade: str = "auto"):
        self.session = session
        self.optimize = optimize
        self.optimize_plan = optimize_plan
        # query-level cascade default: LLM ops without their own
        # accuracy_budget inherit this; cascade= picks the planner mode
        # ("auto" = cost inequality, "force", "off")
        self.cascade_budget = cascade_budget
        self.cascade = cascade
        self._root: PLAN.PlanNode = PLAN.Scan(table)
        self.last_run_stats: List[OpRunStats] = []
        # memoized lowering: (root, flags) -> PhysicalPlan, so
        # explain-then-run describes and executes the SAME lowering
        # instead of re-running the optimizer fixpoint per call
        self._pplan: Optional[PHYS.PhysicalPlan] = None
        self._pplan_key: Optional[Tuple] = None

    @property
    def table(self) -> Table:
        return PLAN.scan_of(self._root).table

    # -- builders -------------------------------------------------------
    def llm_map(self, col: str, *, prompt: str = PROMPTS["summarize"],
                out_col: str = "summary", max_new: int = 24,
                accuracy_budget: Optional[float] = None) -> "Query":
        self._root = PLAN.LLMMap(input=self._root, col=col, prompt=prompt,
                                 out_col=out_col, max_new=max_new,
                                 accuracy_budget=accuracy_budget)
        return self

    def llm_correct(self, col: str, *, prompt: str = PROMPTS["correct"],
                    out_col: Optional[str] = None,
                    max_new: int = 16,
                    accuracy_budget: Optional[float] = None) -> "Query":
        self._root = PLAN.LLMCorrect(input=self._root, col=col,
                                     prompt=prompt, out_col=out_col,
                                     max_new=max_new,
                                     accuracy_budget=accuracy_budget)
        return self

    def llm_join(self, right: Table, on: Tuple[str, str], *,
                 prompt: str = PROMPTS["join"], max_new: int = 12,
                 accuracy_budget: Optional[float] = None) -> "Query":
        self._root = PLAN.LLMJoin(input=self._root, right=right, on=on,
                                  prompt=prompt, max_new=max_new,
                                  accuracy_budget=accuracy_budget)
        return self

    def llm_filter(self, col: str, *, prompt: str, max_new: int = 8,
                   keep: Optional[Callable[[str], bool]] = None,
                   accuracy_budget: Optional[float] = None) -> "Query":
        """Semantic predicate: keep rows whose model output for
        ``prompt + value`` passes ``keep`` (default: affirmative
        prefix)."""
        self._root = PLAN.LLMFilter(input=self._root, col=col,
                                    prompt=prompt, max_new=max_new,
                                    keep=keep or PLAN.default_keep,
                                    accuracy_budget=accuracy_budget)
        return self

    def filter(self, pred: Callable, *,
               columns: Optional[Iterable[str]] = None) -> "Query":
        """Non-LLM predicate.  Declaring ``columns`` (the set the pred
        reads) is what licenses the optimizer to push the filter below
        column-adding LLM ops; without it the pred is opaque and only
        moves past row-set-only ops."""
        self._root = PLAN.Filter(
            input=self._root, pred=pred,
            columns=frozenset(columns) if columns is not None else None)
        return self

    def select(self, cols: Iterable[str]) -> "Query":
        self._root = PLAN.Select(input=self._root, cols=tuple(cols))
        return self

    # -- plan access ----------------------------------------------------
    def logical_plan(self) -> PLAN.PlanNode:
        return self._root

    def physical_plan(self) -> PHYS.PhysicalPlan:
        """plan -> optimize -> lower, annotated with engine choice
        (base vs instance-optimized recipe), kernel backend, prefix
        template and pool placement.  Memoized until the plan or a
        routing flag changes (builder calls reassign ``_root``,
        invalidating the key)."""
        backend = getattr(self.session, "backend", "auto")
        # a session without a device (a test fake) runs on the host
        device = getattr(self.session, "device", "cpu")
        pooled = getattr(self.session, "pool", None) is not None
        flags = (self.optimize, self.optimize_plan, pooled, backend, str(device),
                 self.cascade_budget, self.cascade)
        if (self._pplan is None or self._pplan_key is None
                or self._pplan_key[0] is not self._root
                or self._pplan_key[1] != flags):
            self._pplan = PHYS.lower(
                self._root, optimize_models=self.optimize, pooled=pooled,
                use_optimizer=self.optimize_plan,
                backend=backend, device=device,
                cascade_budget=self.cascade_budget,
                cascade=self.cascade)
            self._pplan_key = (self._root, flags)
        return self._pplan

    def explain(self) -> str:
        """Render the optimized plan with per-node cost estimates, the
        rules that fired, and the physical ops — without executing."""
        pplan = self.physical_plan()
        est = pplan.est
        pooled = getattr(self.session, "pool", None) is not None

        def annotate(node):
            e = est.get(id(node))
            if e is None:
                return ""
            if PLAN.is_llm(node):
                return (f"(rows {e.rows_in} -> {e.rows_out}, "
                        f"{e.invocations} calls x {e.prompt_tokens} tok "
                        f"= cost {e.cost})")
            return f"(rows {e.rows_in} -> {e.rows_out})"

        # the cost unit is part of the EXPLAIN header so readers (and
        # the snapshot test) can never mistake the raw ints for row
        # counts or milliseconds
        lines = [
            f"EXPLAIN (models: {'optimized' if self.optimize else 'base'}, "
            f"placement: {'pool' if pooled else 'private'}, "
            f"plan optimizer: "
            f"{'on' if self.optimize_plan else 'off'}, "
            f"cost unit: rows x prompt_tokens)",
            "",
            "logical plan:",
            indent(PLAN.render(pplan.logical), "  "),
            "",
            "optimized plan:",
            indent(PLAN.render(pplan.optimized, annotate=annotate), "  "),
            "",
            "rules fired:",
        ]
        if pplan.firings:
            # ``[verified]`` = the independent plan verifier re-proved
            # this rewrite's legality (olap/analysis.py), not just the
            # rule's own guard
            lines += [f"  {i}. {f.rule}: {f.desc} "
                      f"(cost {f.cost_before} -> {f.cost_after} "
                      f"rows x prompt_tokens)"
                      + (" [verified]" if f.verified else "")
                      for i, f in enumerate(pplan.firings, 1)]
        else:
            lines.append("  (none)")
        lines += ["", "physical plan:"]
        for i, step in enumerate(pplan.steps, 1):
            if isinstance(step, PHYS.TableStep):
                lines.append(f"  {i}. table {step.node.kind}")
            else:
                line = (
                    f"  {i}. llm {step.node.kind} qsig={step.qsig} "
                    f"engine={step.engine} backend={step.backend} "
                    f"placement={step.placement} "
                    f"dedup={'on' if step.dedup else 'off'} "
                    f"est_calls={step.est.invocations} "
                    f"prefix={step.prefix!r}")
                if step.engine == "cascade":
                    # the fitted threshold appears once a probe has been
                    # calibrated (run() fits it); before
                    # that EXPLAIN shows the planner's escalation prior
                    thr = self.session.cascade_threshold_for(
                        step.qsig, step.accuracy_budget)
                    line += (
                        f" budget={step.accuracy_budget:g}"
                        f" est_escalation={step.est_escalation:.2f}"
                        f" threshold="
                        + (f"{thr:.4f}" if thr is not None else "unfit"))
                lines.append(line)
        ratio = (pplan.logical_cost / pplan.optimized_cost
                 if pplan.optimized_cost else 1.0)
        lines += ["",
                  f"estimated LLM cost: {pplan.logical_cost} -> "
                  f"{pplan.optimized_cost} prompt-tokens "
                  f"({ratio:.1f}x)"]
        return "\n".join(lines)

    # -- execution ------------------------------------------------------
    def _ops(self):
        """The physical plan as a coroutine of LLM-operator
        submissions: yields one ``ExecutableOp`` (olap/physical.py) per
        LLM step — carrying qsig, probe, dedup-wrapped OpSpec, and the
        engine-choice routing bit — and expects the executor to
        ``send`` back the output rows; table steps run inline.
        Returns (via StopIteration.value) the final Table.  ``run()``
        drives it serially; ``Scheduler.run_queries``
        (serving/scheduler.py) interleaves many tenants' plans through
        it.
        """
        n_probe = max(64, self.session.calib_rows + self.session.eval_rows)
        return PHYS.execute(self.physical_plan(), n_probe=n_probe)

    def _log_prefix_savings(self, engine, kind: str, hits0: int,
                            saved0: int) -> None:
        """Savings are logged as deltas over this operator, not lifetime
        engine totals (an engine may serve more than one operator)."""
        st = getattr(engine, "stats", None)
        if st is None:
            return
        hits = getattr(st, "prefix_hits", 0) - hits0
        saved = getattr(st, "prefill_tokens_saved", 0) - saved0
        if hits > 0:
            # the compressed variant's prefix entries are keyed by
            # engine.version, so a recompression never reuses stale
            # prefix state — hits here are same-version by construction
            self.session.log.append(
                f"[prefix] {kind}: {hits} rows seeded from shared "
                f"prefix, {saved} prefill tokens saved "
                f"(v={engine.version})")

    def _run_cascade(self, op) -> List[str]:
        """One cascade op: every row through the instance-optimized
        proxy, rows below the fitted confidence threshold re-submitted
        to the base engine.  Escalated rows are answered by the same
        greedy base decode a base-only run would use, so their outputs
        are byte-identical; with an unsatisfiable budget (threshold =
        inf) the proxy pass is skipped entirely and the op degenerates
        to base-only."""
        sess = self.session
        spec = op.spec
        budget = op.op.accuracy_budget or 0.0
        cal = sess._cascade(op.qsig, op.probe, budget,
                            max_new=spec.max_new)
        prompts = list(spec.prompts)
        if not math.isfinite(cal.threshold):
            outs = OPS._invoke(sess.base_engine(), prompts,
                               max_new=spec.max_new, prefix=spec.prefix)
            self.last_run_stats.append(OpRunStats(
                kind=spec.kind, qsig=op.qsig, invocations=len(outs),
                engine="cascade", escalated=len(outs),
                threshold=cal.threshold))
            return outs
        proxy = sess.optimized_engine(op.qsig, op.probe)
        reqs = proxy.generate_stream(prompts, max_new=spec.max_new,
                                     prefix=spec.prefix,
                                     return_requests=True)
        outs = [r.text for r in reqs]
        reject = [i for i, r in enumerate(reqs)
                  if r.confidence < cal.threshold]
        if reject:
            fixed = OPS._invoke(sess.base_engine(),
                                [prompts[i] for i in reject],
                                max_new=spec.max_new, prefix=spec.prefix)
            for i, o in zip(reject, fixed):
                outs[i] = o
        self.last_run_stats.append(OpRunStats(
            kind=spec.kind, qsig=op.qsig, invocations=len(prompts),
            engine="cascade", escalated=len(reject),
            threshold=cal.threshold))
        return outs

    def run(self) -> Table:
        """Serial execution: drive the plan coroutine op by op through
        the session's engines (pooled when the session has a
        ModelPool, private otherwise)."""
        _require_text_model(getattr(self.session, "cfg", None))   # fakes carry none
        gen = self._ops()
        send = None
        self.last_run_stats = []
        while True:
            try:
                op = gen.send(send)
            except StopIteration as stop:
                return stop.value
            if op.op.engine == "cascade":
                send = self._run_cascade(op)
                continue
            engine = (self.session.optimized_engine(op.qsig, op.probe)
                      if op.optimize else self.session.base_engine())
            st = getattr(engine, "stats", None)
            hits0 = getattr(st, "prefix_hits", 0) if st else 0
            saved0 = getattr(st, "prefill_tokens_saved", 0) if st else 0
            spec = op.spec
            send = OPS._invoke(engine, spec.prompts, max_new=spec.max_new,
                               prefix=spec.prefix)
            self.last_run_stats.append(
                OpRunStats(kind=spec.kind, qsig=op.qsig,
                           invocations=len(send), engine=op.op.engine))
            self._log_prefix_savings(engine, spec.kind, hits0, saved0)

    # -- JSON round-trip ------------------------------------------------
    def to_spec(self) -> Dict[str, Any]:
        """The query as a JSON-serializable spec dict — the wire format
        of the always-on service: inline table data,
        one entry per plan node (scan-first order), plus the query-
        level routing flags.  ``query_from_spec(spec, session)``
        rebuilds an equivalent ``Query``; the round-trip is exact for
        every builder surface except opaque Python callables —
        ``filter()`` predicates must be ``PLAN.ColumnPredicate`` and
        ``llm_filter`` must use the default ``keep`` parser.  Raises
        ``ValueError`` on a non-serializable plan (an opaque callable,
        or an optimizer-annotated node that only the rewriter emits).
        """
        nodes = PLAN.chain(self._root)[::-1]        # scan first
        scan = nodes[0]
        ops: List[Dict[str, Any]] = []
        for n in nodes[1:]:
            if n.kind == "map":
                ops.append({"op": "llm_map", "col": n.col,
                            "prompt": n.prompt, "out_col": n.out_col,
                            "max_new": n.max_new,
                            "accuracy_budget": n.accuracy_budget})
            elif n.kind == "correct":
                ops.append({"op": "llm_correct", "col": n.col,
                            "prompt": n.prompt, "out_col": n.out_col,
                            "max_new": n.max_new,
                            "accuracy_budget": n.accuracy_budget})
            elif n.kind == "llm_filter":
                if n.keep is not PLAN.default_keep:
                    raise ValueError(
                        "to_spec: llm_filter with a custom keep= "
                        "callable is not JSON-serializable")
                ops.append({"op": "llm_filter", "col": n.col,
                            "prompt": n.prompt, "max_new": n.max_new,
                            "accuracy_budget": n.accuracy_budget})
            elif n.kind == "join":
                ops.append({"op": "llm_join",
                            "right": dict(n.right.columns),
                            "on": list(n.on), "prompt": n.prompt,
                            "max_new": n.max_new,
                            "accuracy_budget": n.accuracy_budget})
            elif n.kind == "filter":
                if not isinstance(n.pred, PLAN.ColumnPredicate):
                    raise ValueError(
                        "to_spec: filter() with an opaque callable is "
                        "not JSON-serializable — use "
                        "plan.ColumnPredicate")
                ops.append({"op": "filter",
                            "pred": n.pred.to_dict()})
            elif n.kind == "select":
                ops.append({"op": "select", "cols": list(n.cols)})
            else:
                raise ValueError(
                    f"to_spec: node kind {n.kind!r} has no wire form "
                    "(optimizer-annotated plans are not serializable; "
                    "serialize the builder-level plan)")
        return {"version": 1,
                "table": {"columns": dict(scan.table.columns)},
                "ops": ops,
                "optimize": self.optimize,
                "optimize_plan": self.optimize_plan,
                "cascade_budget": self.cascade_budget,
                "cascade": self.cascade}


def query_from_spec(spec: Dict[str, Any],
                    session: IOLMSession) -> Query:
    """Rebuild a ``Query`` from its ``to_spec()`` wire form (the
    service's request body).  Strict: unknown spec versions, op names,
    or missing fields raise ``ValueError``/``KeyError`` so a malformed
    request fails at admission, not mid-plan."""
    if spec.get("version") != 1:
        raise ValueError(
            f"unsupported query spec version {spec.get('version')!r}")
    table = Table({k: list(v)
                   for k, v in spec["table"]["columns"].items()})
    q = Query(table, session,
              optimize=bool(spec.get("optimize", True)),
              optimize_plan=bool(spec.get("optimize_plan", True)),
              cascade_budget=spec.get("cascade_budget"),
              cascade=spec.get("cascade", "auto"))
    for o in spec.get("ops", []):
        kind = o.get("op")
        if kind == "llm_map":
            q.llm_map(o["col"], prompt=o["prompt"],
                      out_col=o.get("out_col", "summary"),
                      max_new=int(o.get("max_new", 24)),
                      accuracy_budget=o.get("accuracy_budget"))
        elif kind == "llm_correct":
            q.llm_correct(o["col"], prompt=o["prompt"],
                          out_col=o.get("out_col"),
                          max_new=int(o.get("max_new", 16)),
                          accuracy_budget=o.get("accuracy_budget"))
        elif kind == "llm_filter":
            q.llm_filter(o["col"], prompt=o["prompt"],
                         max_new=int(o.get("max_new", 8)),
                         accuracy_budget=o.get("accuracy_budget"))
        elif kind == "llm_join":
            q.llm_join(Table({k: list(v)
                              for k, v in o["right"].items()}),
                       tuple(o["on"]), prompt=o["prompt"],
                       max_new=int(o.get("max_new", 12)),
                       accuracy_budget=o.get("accuracy_budget"))
        elif kind == "filter":
            pred = PLAN.ColumnPredicate.from_dict(o["pred"])
            q.filter(pred, columns=(pred.col,))
        elif kind == "select":
            q.select(o["cols"])
        else:
            raise ValueError(f"unknown query spec op {kind!r}")
    return q
