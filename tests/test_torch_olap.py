"""Port OLAP layer (``olap/``, the session, the workloads) vs the reference's.

- Over a fake engine, the same query builders give the same logical and
  optimized plans, rule firings and EXPLAIN text; EXPLAIN's ``backend=``
  resolves from the session's device (``reference`` on the CPU,
  ``cuda`` on a CUDA device).  Hand-mutated plans draw the same verifier
  diagnostics.
- ``workload_rows`` strings, ``ModelCache.data_signature`` and
  ``fit_confidence_threshold`` equal the reference's.
- On the tiny dense model (tests/conftest.py's shape) in f32 with the
  recipe pinned to ``w8-absmax``, the queries of
  ``examples/olap_queries.py`` (map, correct, fuzzy join, correct +
  pushed-down filter with dedup) at a few rows give tables and
  ``last_run_stats`` identical to the reference session's; a cascade
  with budget 0 equals the base-only run.
- ``to_spec`` equals the reference's dict and ``query_from_spec``
  round-trips; the model pool's arguments get the reference's checks
  (``mesh=`` needs ``pool_budget=``).
- The eager operators (``run_spec``, ``llm_map``, ``llm_correct``,
  ``llm_filter``, ``llm_join``) give the reference's tables over a fake
  engine and over the tiny model's engine, with the reference's bound on
  a streamed join's resident requests.
"""
import dataclasses
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs.base import ModelConfig as RConfig  # noqa: E402
from repro.core import calibrate as RC  # noqa: E402
from repro.core.pipeline import Recipe as RRecipe  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.olap import analysis as RANA  # noqa: E402
from repro.olap import plan as RP  # noqa: E402
from repro.olap import query as RQ  # noqa: E402
from repro.olap.table import Table as RTable  # noqa: E402
from repro.training import data as RD  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.core import calibrate as C  # noqa: E402
from repro_torch.core.pipeline import Recipe  # noqa: E402
from repro_torch.olap import analysis as ANA  # noqa: E402
from repro_torch.olap import plan as P  # noqa: E402
from repro_torch.olap import query as Q  # noqa: E402
from repro_torch.olap.table import Table  # noqa: E402
from repro_torch.training import data as D  # noqa: E402

W8 = dict(name="w8-absmax", wbits=8, quant_method="absmax")
ENGINE_KW = dict(slots=4, max_len=64, buckets=(32, 48))


# ---------------------------------------------------------------------------
# the plan layer over a fake engine
# ---------------------------------------------------------------------------

class FakeEngine:
    """Output is a pure function of the prompt (like greedy decode)."""

    def __init__(self):
        self.calls = []

    def generate(self, prompts, max_new=8):
        prompts = list(prompts)
        self.calls.extend(prompts)
        return [("same" if len(p) % 3 == 0 else "out(") + p[-6:] for p in prompts]


class FakeSession:
    calib_rows = 4
    eval_rows = 2
    pool = None

    def __init__(self, device=None):
        self.log = []
        self.eng = FakeEngine()
        if device is not None:
            self.device = device

    def base_engine(self):
        return self.eng

    def optimized_engine(self, qsig, probe):
        return self.eng

    def cascade_threshold_for(self, qsig, budget):
        return None


def _columns():
    return {"category": ["pyhton", "rust", "pyhton", "jva", "rust", "go", "jva", "go"],
            "status": ["ok", "wip", "ok", "ok", "wip", "ok", "ok", "wip"]}


def _build(mod, table_cls, sess, kind):
    """The same query on either side (``mod`` is the reference's or the
    port's query module)."""
    t = table_cls(_columns())
    q = mod.Query(t, sess)
    if kind == "pushdown_dedup":
        q = q.llm_correct("category", max_new=8).filter(
            lambda r: r["status"] == "ok", columns=["status"])
    elif kind == "fusion":
        q = q.llm_map("category", prompt="label: ", out_col="a", max_new=4) \
             .llm_map("category", prompt="label: ", out_col="b", max_new=4)
    elif kind == "join_select":
        q = q.llm_join(table_cls({"name": ["Python", "ruby", "golang"]}),
                       ("category", "name"), max_new=4).select(["l_category", "r_name"])
    elif kind == "llm_filter":
        q = q.llm_filter("status", prompt="keep? ", max_new=2) \
             .llm_map("category", max_new=4)
    else:
        q = q.llm_correct("category", max_new=4, accuracy_budget=0.2)
        q.cascade = "force"
    return q


KINDS = ["pushdown_dedup", "fusion", "join_select", "llm_filter", "cascade"]


@pytest.mark.parametrize("kind", KINDS)
def test_plans_explain_and_runs_match_reference_over_fake_engine(kind):
    rq = _build(RQ, RTable, FakeSession(), kind)
    pq = _build(Q, Table, FakeSession(), kind)
    assert P.render(pq.logical_plan()) == RP.render(rq.logical_plan())
    rpp, ppp = rq.physical_plan(), pq.physical_plan()
    assert P.render(ppp.optimized) == RP.render(rpp.optimized)
    assert [(f.rule, f.desc, f.cost_before, f.cost_after, f.verified) for f in ppp.firings] \
        == [(f.rule, f.desc, f.cost_before, f.cost_after, f.verified) for f in rpp.firings]
    assert (ppp.logical_cost, ppp.optimized_cost) == (rpp.logical_cost, rpp.optimized_cost)
    # the CPU resolves "auto" to the plain backend on both sides
    assert pq.explain() == rq.explain()
    assert "backend=reference" in pq.explain()
    on_card = _build(Q, Table, FakeSession(device="cuda"), kind).explain()
    assert re.sub("backend=cuda", "backend=reference", on_card) == rq.explain()
    assert "backend=cuda" in on_card
    if kind != "cascade":      # the fake engine has no confidence signal
        want, got = rq.run(), pq.run()
        assert got.columns == want.columns
        assert [dataclasses.asdict(s) for s in pq.last_run_stats] \
            == [dataclasses.asdict(s) for s in rq.last_run_stats]


def _mutations(P_, Table_):
    """Hand-mutated (before, after, rule) rewrites, the same on either side."""
    t = Table_(_columns())
    scan = P_.Scan(t)

    def m(inp, prompt="label: ", out="label", col="category"):
        return P_.LLMMap(input=inp, col=col, prompt=prompt, out_col=out, max_new=8)

    out = []
    mm = m(scan)
    filt = P_.Filter(input=mm, pred=lambda r: True, columns=frozenset({"label"}))
    out.append((filt, P_.with_child(mm, P_.with_child(filt, scan)), "pushdown"))
    opaque = P_.Filter(input=mm, pred=lambda r: True, columns=None)
    out.append((opaque, P_.with_child(mm, P_.with_child(opaque, scan)), "pushdown"))
    lower = m(scan, prompt="a: ", out="l1")
    upper = m(lower, prompt="b: ", out="l2")
    out.append((upper, P_.LLMFused(input=scan, col="category", prompt="b: ",
                                   outs=("l1", "l2"), max_new=8, src_kind="map"), "fusion"))
    lower = m(scan, prompt="p: ", out="label")
    upper = m(lower, prompt="p: ", col="label", out="l2")
    out.append((upper, P_.LLMFused(input=scan, col="label", prompt="p: ",
                                   outs=("label", "l2"), max_new=8, src_kind="map"), "fusion"))
    uniq = P_.Scan(Table_({"category": [f"u{i}" for i in range(8)]}))
    plain = m(uniq)
    out.append((plain, dataclasses.replace(plain, dedup=True), "dedup"))
    out.append((plain, plain, "no_such_rule"))
    return out


def test_verifier_diagnostics_match_reference_on_mutated_plans():
    want = [RANA.verify_rewrite(b, a, rule) for b, a, rule in _mutations(RP, RTable)]
    got = [ANA.verify_rewrite(b, a, rule) for b, a, rule in _mutations(P, Table)]
    assert [[dataclasses.asdict(d) for d in ds] for ds in got] \
        == [[dataclasses.asdict(d) for d in ds] for ds in want]
    assert all(got) and {d.code for ds in got for d in ds} >= {"PLAN012", "PLAN013",
                                                              "PLAN031", "PLAN033"}
    with pytest.raises(ANA.PlanVerificationError):
        from repro_torch.olap import physical as PHYS
        b, a, _ = _mutations(P, Table)[4]
        PHYS.lower(a)


# ---------------------------------------------------------------------------
# workloads, signatures, threshold fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["summarize", "correct", "join"])
def test_workload_rows_match_reference(name):
    for seed in (0, 7):
        want = RD.workload_rows(name, 64, seed=seed)
        got = D.workload_rows(name, 64, seed=seed)
        assert [(r.text, r.target, r.meta) for r in got] \
            == [(r.text, r.target, r.meta) for r in want]
    assert [r.text for r in D.eval_rows(name, 16)] == [r.text for r in RD.eval_rows(name, 16)]
    assert D.PROMPTS == RD.PROMPTS


def test_data_signature_and_threshold_fit_match_reference():
    rng = np.random.default_rng(11)
    samples = [[], ["a"], [str(v) for v in rng.integers(0, 9, 200)],
               ["x" * 300 + str(i) for i in range(70)],
               [r.text for r in RD.workload_rows("correct", 64)]]
    for vals in samples:
        assert Q.ModelCache.data_signature(vals) == RQ.ModelCache.data_signature(vals)
    for budget in (0.0, 0.05, 0.25, 1.0, None):
        for n in (0, 1, 16):
            conf = rng.random(n)
            agree = rng.random(n) < 0.6
            want = RC.fit_confidence_threshold(conf, agree, budget)
            got = C.fit_confidence_threshold(conf, agree, budget)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            back = C.CascadeCalibration.from_dict(json.loads(json.dumps(got.to_dict())))
            assert back == got
    inf = C.fit_confidence_threshold([0.9], [False], 0.0)
    assert inf.threshold == float("inf")
    assert C.CascadeCalibration.from_dict(json.loads(json.dumps(inf.to_dict()))) == inf


# ---------------------------------------------------------------------------
# the session on the tiny model: the example queries, end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    rcfg = RConfig(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, d_ff=128, vocab_size=260, max_seq=256,
                   param_dtype="float32")
    rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, rparams, from_reference(rcfg), bridge.from_reference(rparams, device="cpu")


def _queries(mod, table_cls, sess, rows):
    """Q1-Q4 of examples/olap_queries.py at ``rows`` rows; returns
    [(table, last_run_stats)] and Q4's EXPLAIN."""
    out = []
    reviews = table_cls({"review": [r.text for r in RD.workload_rows("summarize", rows)]})
    q = mod.Query(reviews, sess).llm_map("review", max_new=6)
    out.append((q.run(), q.last_run_stats))
    commits = table_cls({"lang": [r.text for r in RD.workload_rows("correct", rows)]})
    q = mod.Query(commits, sess).llm_correct("lang", max_new=6)
    out.append((q.run(), q.last_run_stats))
    pairs = RD.workload_rows("join", 4)
    left = table_cls({"name": [p.text.split(" | ")[0] for p in pairs]})
    right = table_cls({"name": [p.text.split(" | ")[1] for p in pairs]})
    q = mod.Query(left, sess).llm_join(right, ("name", "name"), max_new=4)
    out.append((q.run(), q.last_run_stats))
    commits4 = table_cls({"lang": [commits["lang"][i % (rows // 2)] for i in range(rows)],
                          "status": ["ok" if i % 2 == 0 else "wip" for i in range(rows)]})
    q = mod.Query(commits4, sess).llm_correct("lang", max_new=6) \
        .filter(lambda r: r["status"] == "ok", columns=["status"])
    explain = q.explain()
    out.append((q.run(), q.last_run_stats))
    return out, explain


@pytest.fixture(scope="module")
def sessions(tiny):
    rcfg, rparams, cfg, params = tiny
    kw = dict(calib_rows=4, eval_rows=2)
    rsess = RQ.IOLMSession(rparams, rcfg, recipes=[RRecipe(**W8)],
                           engine_kw=dict(ENGINE_KW), **kw)
    psess = Q.IOLMSession(params, cfg, recipes=[Recipe(**W8)], engine_kw=dict(ENGINE_KW),
                          device="cpu", **kw)
    return (rsess, _queries(RQ, RTable, rsess, 6)), (psess, _queries(Q, Table, psess, 6))


def test_session_queries_match_reference(sessions):
    (rsess, (want, rexplain)), (psess, (got, pexplain)) = sessions
    assert pexplain == rexplain and "backend=reference" in pexplain
    for (gt, gstats), (wt, wstats) in zip(got, want):
        assert gt.columns == wt.columns
        assert [dataclasses.asdict(s) for s in gstats] == [dataclasses.asdict(s) for s in wstats]
    # Q4: the filter ran below the LLM op and the op ran once per distinct value
    t4, stats4 = got[3]
    assert len(t4) == 3 and stats4[0].invocations == len(set(t4["lang"]))
    assert psess.recalibrations == rsess.recalibrations == 4
    picked = [ln.split(" acc=")[0] for ln in psess.log if ln.startswith("[iolm]")]
    assert picked == [ln.split(" acc=")[0] for ln in rsess.log if ln.startswith("[iolm]")]
    assert len(picked) == 4 and all("picked w8-absmax" in ln for ln in picked)
    # every instance in the model cache lives on the session's device
    for m in psess.model_cache._d.values():
        assert m.params["blocks"][0]["attn"]["wq"].q.device == psess.device


def test_repeated_query_hits_model_cache(sessions):
    (_, _), (psess, _) = sessions
    n = psess.recalibrations
    commits = Table({"lang": [r.text for r in RD.workload_rows("correct", 6)]})
    Q.Query(commits, psess).llm_correct("lang", max_new=6).run()
    assert psess.recalibrations == n and psess.model_cache.hits >= 1


def test_cascade_budget_zero_equals_base_only(tiny):
    _, _, cfg, params = tiny
    sess = Q.IOLMSession(params, cfg, recipes=[Recipe(**W8)], calib_rows=4, eval_rows=2,
                         engine_kw=dict(ENGINE_KW), device="cpu")
    commits = Table({"lang": [r.text for r in RD.workload_rows("correct", 6)]})
    base = Q.Query(commits, sess, optimize=False).llm_correct("lang", max_new=6).run()
    q = Q.Query(commits, sess, cascade="force").llm_correct("lang", max_new=6,
                                                            accuracy_budget=0.0)
    assert "engine=cascade" in q.explain()
    out = q.run()
    assert out.columns == base.columns
    st = q.last_run_stats[0]
    # the dedup rule sends each distinct value once, all of them to the base
    n = len(set(commits["lang"]))
    assert st.engine == "cascade" and st.escalated == st.invocations == n
    assert st.threshold == float("inf")
    assert sess.cascade_fits == 1 and sess.recalibrations == 0


def test_to_spec_matches_reference_and_round_trips():
    right = {"name": ["Python", "ruby"]}

    def build(mod, table_cls, plan_mod):
        q = mod.Query(table_cls(_columns()), FakeSession(), cascade_budget=0.1,
                      cascade="off")
        return q.llm_map("category", max_new=5) \
                .llm_correct("category", out_col="fixed", accuracy_budget=0.3) \
                .llm_filter("status", prompt="keep? ") \
                .filter(plan_mod.ColumnPredicate("status", "eq", "ok"), columns=["status"]) \
                .llm_join(table_cls(right), ("category", "name")) \
                .select(["l_category", "r_name"])

    want = build(RQ, RTable, RP).to_spec()
    got = build(Q, Table, P).to_spec()
    assert got == want
    back = Q.query_from_spec(json.loads(json.dumps(got)), FakeSession())
    assert back.to_spec() == got
    with pytest.raises(ValueError):
        Q.Query(Table(_columns()), FakeSession()).filter(lambda r: True).to_spec()
    with pytest.raises(ValueError):
        Q.query_from_spec({"version": 2}, FakeSession())


@pytest.mark.parametrize("arg", ["pool_budget", "pool", "devices", "mesh"])
def test_pool_arguments_raise(tiny, arg):
    """The model pool's arguments take the reference's checks:
    ``pool_budget=`` builds a pool (EXPLAIN says so), ``pool=`` with
    ``devices=`` and ``devices=`` without a budget raise ``ValueError``,
    and so do ``mesh=`` without a budget and ``mesh=`` with ``pool=``;
    with a budget, ``mesh=`` makes the pool's devices its positions."""
    _, _, cfg, params = tiny
    cpu = [torch.device("cpu")]
    if arg == "pool_budget":
        sess = Q.IOLMSession(params, cfg, device="cpu", pool_budget=1 << 30)
        assert sess.pool is not None and sess.pool.byte_budget == 1 << 30
        txt = Q.Query(Table({"lang": ["pyton"]}), sess).llm_correct("lang").explain()
        assert "placement: pool," in txt and " placement=pool " in txt
    elif arg == "pool":
        shared = Q.IOLMSession(params, cfg, device="cpu", pool_budget=1 << 30).pool
        with pytest.raises(ValueError, match="pool="):
            Q.IOLMSession(params, cfg, device="cpu", pool=shared, devices=cpu)
        assert Q.IOLMSession(params, cfg, device="cpu", pool=shared).pool is shared
    elif arg == "devices":
        with pytest.raises(ValueError, match="pool_budget="):
            Q.IOLMSession(params, cfg, device="cpu", devices=cpu)
    else:
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
        with pytest.raises(ValueError, match="pool_budget="):
            Q.IOLMSession(params, cfg, device="cpu", mesh=mesh)
        shared = Q.IOLMSession(params, cfg, device="cpu", pool_budget=1 << 30).pool
        with pytest.raises(ValueError, match="pool="):
            Q.IOLMSession(params, cfg, device="cpu", pool=shared, mesh=mesh)
        sess = Q.IOLMSession(params, cfg, device="cpu", pool_budget=1 << 30, mesh=mesh)
        assert sess.pool.mesh is mesh and sess.pool.devices == list(mesh.devices.flat)


def test_session_defaults_to_the_card(tiny):
    _, _, cfg, params = tiny
    if torch.cuda.is_available():
        assert Q.IOLMSession(params, cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            Q.IOLMSession(params, cfg)


# ---------------------------------------------------------------------------
# the eager operators (run_spec, llm_map, llm_correct, llm_filter, llm_join)
# ---------------------------------------------------------------------------

class FnEngine:
    """Output is ``fn(prompt)``; no async API, so ``_invoke`` falls back
    to ``generate`` (the reference's ``tests/test_serving_olap.py`` fake)."""

    def __init__(self, fn):
        self.fn = fn

    def generate(self, prompts, max_new=8):
        return [self.fn(p) for p in prompts]


def _same_verdict(seen):
    def fn(p):
        seen.append(p)
        body = p.split(":", 1)[1]
        a, b = [s.strip().lower().replace(",", "").replace(" inc.", "")
                for s in body.split("|")]
        return "same" if a == b else "different"
    return fn


def test_eager_operators_over_a_fake_engine_match_reference():
    """``llm_map`` adds the column and ``llm_join`` blocks its candidate
    pairs by first character, as in the reference's operator tests."""
    from repro.olap import operators as ROPS
    from repro_torch.olap import operators as OPS
    t2 = OPS.llm_map(Table({"review": ["good mouse", "bad lamp"]}), "review",
                     FnEngine(lambda p: p.split()[-2]), out_col="s")
    assert t2["s"] == ["good", "bad"]
    rt2 = ROPS.llm_map(RTable({"review": ["good mouse", "bad lamp"]}), "review",
                       FnEngine(lambda p: p.split()[-2]), out_col="s")
    assert t2.columns == rt2.columns
    names = (["Acme Corp", "Globex"], ["Acme Corp Inc.", "Initech", "acme corp"])
    seen, rseen = [], []
    out = OPS.llm_join(Table({"name": names[0]}), Table({"name": names[1]}),
                       ("name", "name"), FnEngine(_same_verdict(seen)))
    rout = ROPS.llm_join(RTable({"name": names[0]}), RTable({"name": names[1]}),
                         ("name", "name"), FnEngine(_same_verdict(rseen)))
    assert all("globex" not in p.lower() or "initech" not in p.lower() for p in seen)
    assert len(out) == 2 and out.columns == rout.columns and seen == rseen


def _op_engines(tiny, **kw):
    from repro.serving.engine import Engine as REngine
    from repro_torch.serving.engine import Engine
    rcfg, rparams, cfg, params = tiny
    kw = dict(slots=2, max_len=64, use_result_cache=False, **kw)
    return REngine(rparams, rcfg, **kw), Engine(params, cfg, device="cpu", **kw)


def test_llm_join_residency_bounded_by_chunk(tiny):
    """O(n·k) join candidates stream through the engine: peak resident
    requests track the chunk bound, not the pair count; the joined table
    is the reference's."""
    from repro.olap import operators as ROPS
    from repro_torch.olap import operators as OPS
    n, chunk = 6, 4
    names = ([f"acme{i}" for i in range(n)], [f"acme{i}x" for i in range(n)])
    outs = []
    for ops, table_cls, eng in zip((ROPS, OPS), (RTable, Table),
                                   _op_engines(tiny, buckets=(32,))):
        outs.append(ops.llm_join(table_cls({"name": names[0]}), table_cls({"name": names[1]}),
                                 ("name", "name"), eng, max_new=2, chunk=chunk))
        assert eng.stats.rows == n * n          # one block: every left x every right
        assert eng.stats.peak_inflight <= chunk + eng.slots < n * n
    assert outs[1].columns == outs[0].columns


def test_streamed_map_matches_generate(tiny):
    from repro.olap import operators as ROPS
    from repro_torch.olap import operators as OPS
    vals = [f"row {i}" for i in range(9)]
    reng, eng = _op_engines(tiny, buckets=(32,))
    t = OPS.llm_map(Table({"c": vals}), "c", eng, prompt="sum: ", out_col="o",
                    max_new=4, chunk=3)
    rt = ROPS.llm_map(RTable({"c": vals}), "c", reng, prompt="sum: ", out_col="o",
                      max_new=4, chunk=3)
    assert t.columns == rt.columns
    _, fresh = _op_engines(tiny, buckets=(32,))
    assert t["o"] == fresh.generate(["sum: " + v for v in vals], max_new=4)


def test_llm_correct_filter_and_run_spec_match_reference(tiny):
    """``llm_correct``, ``llm_filter`` (kept by a predicate on the model's
    output) and ``run_spec`` of a ``map_spec`` give the reference's
    tables on the tiny model."""
    from repro.olap import operators as ROPS
    from repro_torch.olap import operators as OPS
    langs = [r.text for r in RD.workload_rows("correct", 4)]
    keep = lambda s: len(s) % 2 == 0  # noqa: E731
    got, want = [], []
    for ops, table_cls, eng, out in zip((ROPS, OPS), (RTable, Table),
                                        _op_engines(tiny, buckets=(32, 48)), (want, got)):
        t = table_cls({"lang": langs})
        out.append(ops.llm_correct(t, "lang", eng, max_new=4))
        out.append(ops.llm_filter(t, "lang", eng, prompt="is it a language? ", max_new=3,
                                  keep=keep))
        out.append(ops.run_spec(ops.map_spec(t, "lang", out_col="m", max_new=3), eng, chunk=2))
    for g, w in zip(got, want):
        assert g.columns == w.columns
