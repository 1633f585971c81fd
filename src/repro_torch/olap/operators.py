"""LLM operators: first-class per-row model invocation inside queries.

The paper's three workloads as relational operators, plus a semantic
predicate:
  - ``map_spec``     (summarization): prompt per row -> new column
  - ``correct_spec`` (data correction): fix each value in a column
  - ``join_spec``    (fuzzy join): semantic row matching across tables
  - ``filter_spec``  (semantic predicate): keep rows the model affirms
  - ``fused_spec``   (optimizer-only): adjacent same-template ops
    merged into one model pass writing several columns

Each operator is built from an ``OpSpec``: a lazy prompt stream plus a
``finish`` closure that turns the model outputs back into a Table.
The split exists so two executors can drive the same operator:

  - the synchronous path (``Query.run``) funnels the spec through
    ``_invoke`` -> ``Engine.generate_stream``, which **streams** prompts into the
    engine's async core in bounded chunks (at most ``chunk``
    un-finished requests resident, so ``llm_join``'s O(n·k) candidate
    prompts never fully materialize);
  - the multi-tenant scheduler (``serving/scheduler.py``) consumes the
    spec's prompt stream directly, interleaving many tenants' operators
    across pooled engines tick-by-tick.

Every operator renders rows through a fixed template, so the spec
carries the template as ``prefix`` — the engine prefills the shared
prefix once per (template, model version) and seeds each row's
KV/state from it (serving/cache.py PrefixCache).  Engines without the
async API (test fakes, remote backends) fall back to ``generate``.
Blocking for the fuzzy join keeps the candidate set O(n·k) instead of
O(n·m).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

from repro_torch.olap.table import Table
from repro_torch.serving.engine import DEFAULT_CHUNK, Engine
from repro_torch.training.data import PROMPTS


@dataclass
class OpSpec:
    """One LLM operator, executor-agnostic: stream ``prompts`` through
    a model, then call ``finish(outs)`` for the result Table.  The
    prompt stream is lazy; ``finish`` must only run after every prompt
    has been consumed and answered (order-aligned with ``prompts``)."""
    kind: str
    prompts: Iterator[str]
    finish: Callable[[List[str]], Table]
    max_new: int
    prefix: Optional[str]


def _dedup_plan(values) -> Tuple[List[str], Callable[[List[str]], List[str]]]:
    """Unique stringified values in first-seen order, plus a scatter
    closure mapping per-unique outputs back to per-row outputs.
    Greedy decode is deterministic per prompt, so invoking once per
    unique value is byte-identical to invoking per row."""
    first: dict = {}
    order: List[str] = []
    idx_of: List[int] = []
    for v in values:
        s = str(v)
        if s not in first:
            first[s] = len(order)
            order.append(s)
        idx_of.append(first[s])
    return order, lambda uouts: [uouts[i] for i in idx_of]


def _rowwise_spec(kind: str, table: Table, col: str, prompt: str,
                  max_new: int, finish_rows: Callable[[List[str]], Table],
                  *, dedup: bool) -> OpSpec:
    """Shared shape of map/correct/llm_filter/fused: one prompt per row
    of ``col``, with an optional dedup wrapper (submit unique values
    only, scatter outputs back before ``finish_rows``)."""
    if dedup:
        uniq, scatter = _dedup_plan(table[col])
        return OpSpec(kind, (prompt + u for u in uniq),
                      lambda outs: finish_rows(scatter(outs)),
                      max_new, prompt)
    return OpSpec(kind, (prompt + str(v) for v in table[col]),
                  finish_rows, max_new, prompt)


def map_spec(table: Table, col: str, *, prompt: str = PROMPTS["summarize"],
             out_col: str = "summary", max_new: int = 24,
             dedup: bool = False) -> OpSpec:
    return _rowwise_spec("map", table, col, prompt, max_new,
                         lambda outs: table.with_column(out_col, outs),
                         dedup=dedup)


def correct_spec(table: Table, col: str, *, prompt: str = PROMPTS["correct"],
                 out_col: Optional[str] = None, max_new: int = 16,
                 dedup: bool = False) -> OpSpec:
    return _rowwise_spec("correct", table, col, prompt, max_new,
                         lambda outs: table.with_column(
                             out_col or col + "_fixed", outs),
                         dedup=dedup)


def filter_spec(table: Table, col: str, *, prompt: str, max_new: int = 8,
                keep: Optional[Callable[[str], bool]] = None,
                dedup: bool = False) -> OpSpec:
    """Semantic predicate: keep rows whose model output passes
    ``keep`` (default: affirmative prefix — yes/keep/same/true)."""
    from repro_torch.olap.plan import default_keep
    keep = keep or default_keep

    def finish_rows(outs: List[str]) -> Table:
        return table.take([i for i, o in enumerate(outs) if keep(o)])

    return _rowwise_spec("llm_filter", table, col, prompt, max_new,
                         finish_rows, dedup=dedup)


def fused_spec(table: Table, col: str, *, prompt: str,
               outs: Tuple[str, ...], max_new: int,
               dedup: bool = False) -> OpSpec:
    """Fusion of adjacent same-(col, prompt) ops: one prompt stream,
    outputs fanned to every column in ``outs`` (original op order)."""
    def finish_rows(vals: List[str]) -> Table:
        t = table
        for o in outs:
            t = t.with_column(o, vals)
        return t

    return _rowwise_spec("fused", table, col, prompt, max_new,
                         finish_rows, dedup=dedup)


def join_spec(left: Table, right: Table, on: Tuple[str, str], *,
              prompt: str = PROMPTS["join"], max_new: int = 12,
              blocker: Optional[Callable[[str], str]] = None) -> OpSpec:
    """Fuzzy-join spec: candidate pairs are generated by a cheap
    blocking key, prompts stream lazily (``pairs`` fills as the
    executor consumes them), and ``finish`` assembles matched rows."""
    blocker = blocker or _block_key
    lcol, rcol = on
    blocks: dict = {}
    for j, v in enumerate(right[rcol]):
        blocks.setdefault(blocker(v), []).append(j)
    pairs: List[Tuple[int, int]] = []   # index pairs only — O(n·k) ints

    def candidate_prompts():
        for i, v in enumerate(left[lcol]):
            for j in blocks.get(blocker(v), []):
                pairs.append((i, j))
                yield f"{prompt}{left[lcol][i]} | {right[rcol][j]}"

    def finish(verdicts: List[str]) -> Table:
        matched = [(i, j) for (i, j), v in zip(pairs, verdicts)
                   if v.strip().startswith("same")]
        rows = []
        for i, j in matched:
            row = {f"l_{k}": v[i] for k, v in left.columns.items()}
            row.update({f"r_{k}": v[j] for k, v in right.columns.items()})
            rows.append(row)
        if not rows:
            cols = {f"l_{k}": [] for k in left.columns}
            cols.update({f"r_{k}": [] for k in right.columns})
            return Table(cols)
        return Table.from_rows(rows)

    return OpSpec("join", candidate_prompts(), finish, max_new, prompt)


def _invoke(engine: Engine, prompts: Iterable[str], *,
            max_new: int = 24, chunk: int = DEFAULT_CHUNK,
            prefix: Optional[str] = None) -> List[str]:
    """Stream ``prompts`` (any iterable, lazily consumed) through the
    engine; returns outputs in prompt order.  ``prefix`` is the shared
    template prefix every prompt starts with — the engine prefills it
    once and seeds each row's state from the cached prefix, so per-row
    prefill covers only the row suffix."""
    if not hasattr(engine, "generate_stream"):   # plain-generate fallback
        return engine.generate(list(prompts), max_new=max_new)
    return engine.generate_stream(prompts, max_new=max_new, chunk=chunk,
                                  prefix=prefix)


def run_spec(spec: OpSpec, engine: Engine, *,
             chunk: int = DEFAULT_CHUNK) -> Table:
    """Synchronous executor: stream the spec through one engine."""
    outs = _invoke(engine, spec.prompts, max_new=spec.max_new,
                   chunk=chunk, prefix=spec.prefix)
    return spec.finish(outs)


def llm_map(table: Table, col: str, engine: Engine, *,
            prompt: str = PROMPTS["summarize"], out_col: str = "summary",
            max_new: int = 24, chunk: int = DEFAULT_CHUNK) -> Table:
    """SELECT *, LLM('<prompt> ' || col) AS out_col FROM table"""
    return run_spec(map_spec(table, col, prompt=prompt, out_col=out_col,
                             max_new=max_new), engine, chunk=chunk)


def llm_correct(table: Table, col: str, engine: Engine, *,
                prompt: str = PROMPTS["correct"],
                out_col: Optional[str] = None,
                max_new: int = 16, chunk: int = DEFAULT_CHUNK) -> Table:
    """Per-row error correction of a column (typos, format drift)."""
    return run_spec(correct_spec(table, col, prompt=prompt, out_col=out_col,
                                 max_new=max_new), engine, chunk=chunk)


def llm_filter(table: Table, col: str, engine: Engine, *, prompt: str,
               max_new: int = 8,
               keep: Optional[Callable[[str], bool]] = None,
               chunk: int = DEFAULT_CHUNK) -> Table:
    """SELECT * FROM table WHERE LLM('<prompt> ' || col) ≈ 'yes'."""
    return run_spec(filter_spec(table, col, prompt=prompt, max_new=max_new,
                                keep=keep), engine, chunk=chunk)


def _block_key(v: str) -> str:
    s = "".join(ch for ch in str(v).lower() if ch.isalnum())
    return s[:1]


def llm_join(left: Table, right: Table, on: Tuple[str, str],
             engine: Engine, *, prompt: str = PROMPTS["join"],
             max_new: int = 12, chunk: int = DEFAULT_CHUNK,
             blocker: Callable[[str], str] = _block_key) -> Table:
    """Fuzzy (semantic) join: rows match when the model says 'same'.

    Candidate pairs are generated by a cheap blocking key first; the LLM
    adjudicates only within blocks (classic entity-resolution shape).
    Candidate prompts stream lazily into the engine, so peak prompt
    residency is bounded by ``chunk``, not by the O(n·k) pair count.
    """
    return run_spec(join_spec(left, right, on, prompt=prompt,
                              max_new=max_new, blocker=blocker),
                    engine, chunk=chunk)
