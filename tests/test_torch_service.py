"""The port's always-on service (``repro_torch.service``) against the
reference's contracts (tests/test_service.py).

- SLO admission: the in-flight row cap under random admit/release
  interleavings, the token bucket on an injected clock, the query cap,
  and a shed that charges nothing.
- Quarantine through the port's scheduler: an engine that faults on a
  step or a submit is retried on the base engine with the clean rows, a
  bounded retry budget ends in a terminal error, an innocent tenant is
  unaffected; a ``KernelError`` is never served around: it stops the
  service's pump, fails the query with kind ``KernelError``, turns
  ``/healthz`` to 503 and is re-raised by ``stop()``.
- The plan wire format: ``to_spec``/``query_from_spec`` round trips.
- HTTP end to end on a tiny f32 model bridged from the reference's init:
  healthz, rows equal to ``Scheduler.run_queries`` (the acceptance bar)
  and to the reference's ``run_queries`` on the same weights, streaming
  order, 429 with ``Retry-After``, the stats schema and its text form,
  400 on a malformed spec, the checkpoint endpoint.
- Warm restart: a fresh session restored from the saved state answers
  the seen query with the same rows, no recalibration and no cascade
  fit; warm state written by the reference's service restores in the
  port's and the reverse, each answering the same spec with the
  writer's rows.
"""
import http.client
import json
import random
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs.base import ModelConfig as RConfig  # noqa: E402
from repro.core.pipeline import Recipe as RRecipe  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.olap import query as RQ  # noqa: E402
from repro.service import checkpoint as RWARM  # noqa: E402
from repro.service.core import table_rows as ref_table_rows  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.core.pipeline import Recipe  # noqa: E402
from repro_torch.kernels.build import KernelError  # noqa: E402
from repro_torch.olap import plan as PLAN  # noqa: E402
from repro_torch.olap.query import IOLMSession, Query, query_from_spec  # noqa: E402
from repro_torch.olap.table import Table  # noqa: E402
from repro_torch.serving.metrics import render_stats  # noqa: E402
from repro_torch.serving.scheduler import ModelPool, Scheduler  # noqa: E402
from repro_torch.service import (SemanticQueryService, ServiceClient,  # noqa: E402
                                 TenantSLO, restore_warm_state, save_warm_state,
                                 serve)
from repro_torch.service.client import QueryError, ShedError  # noqa: E402
from repro_torch.service.core import table_rows  # noqa: E402
from repro_torch.service.slo import AdmissionController  # noqa: E402

from test_torch_scheduler import FakeEngine, FakeSession  # noqa: E402

ENGINE_KW = dict(slots=2, max_len=64, buckets=(16, 48))
W8 = dict(name="w8", wbits=8, quant_method="absmax")
BUDGET = 64 * 1024 * 1024


# ---------------------------------------------------------------------------
# SLO admission control
# ---------------------------------------------------------------------------

class TestAdmission:
    def test_inflight_rows_never_exceed_cap(self):
        rng = random.Random(0)
        cap = 10
        ac = AdmissionController(
            {"t": TenantSLO(max_inflight_rows=cap, max_queries=10 ** 6)})
        live = []
        admitted = shed = 0
        for _ in range(800):
            if live and rng.random() < 0.45:
                ac.release("t", live.pop(rng.randrange(len(live))))
            else:
                rows = rng.randint(1, 6)
                if ac.try_admit("t", rows, 0.0) is None:
                    live.append(rows)
                    admitted += 1
                else:
                    shed += 1
            cur = ac.inflight_rows("t")
            assert cur == sum(live)
            assert cur <= cap
        snap = ac.snapshot()["t"]
        assert snap["admitted"] == admitted and snap["shed"] == shed

    def test_token_bucket_refills_on_injected_clock(self):
        now = [0.0]
        ac = AdmissionController(
            {"t": TenantSLO(max_inflight_rows=100, max_queries=100,
                            token_budget=10.0, refill_per_s=5.0)},
            clock=lambda: now[0])
        assert ac.try_admit("t", 1, 8.0) is None
        shed = ac.try_admit("t", 1, 8.0)
        assert shed is not None and shed.reason == "token_budget"
        assert shed.retry_after_s == pytest.approx(6.0 / 5.0)
        now[0] += 2.0
        assert ac.try_admit("t", 1, 8.0) is None

    def test_max_queries_cap(self):
        ac = AdmissionController(
            {"t": TenantSLO(max_inflight_rows=100, max_queries=1)})
        assert ac.try_admit("t", 1, 0.0) is None
        shed = ac.try_admit("t", 1, 0.0)
        assert shed is not None and shed.reason == "max_queries"
        ac.release("t", 1)
        assert ac.try_admit("t", 1, 0.0) is None

    def test_shed_charges_nothing(self):
        ac = AdmissionController(
            {"t": TenantSLO(max_inflight_rows=5, max_queries=10)})
        assert ac.try_admit("t", 4, 0.0) is None
        assert ac.try_admit("t", 4, 0.0) is not None
        assert ac.inflight_rows("t") == 4


# ---------------------------------------------------------------------------
# quarantine through the port's scheduler
# ---------------------------------------------------------------------------

class FlakyEngine:
    """A fake engine raising ``exc`` on its Nth ``step()`` or ``submit()``
    (1-based), through the scheduler's whole-step path
    (tests/fault_utils.py's ``FlakyEngine``)."""

    def __init__(self, inner, *, fail_on_step=None, fail_on_submit=None,
                 exc=RuntimeError):
        self.inner, self.version, self.device = inner, inner.version, None
        self.fail_on_step, self.fail_on_submit, self.exc = fail_on_step, fail_on_submit, exc
        self.steps = self.submits = 0
        self.fired = False

    def submit(self, text, *, max_new=8, prefix=None):
        self.submits += 1
        if self.submits == self.fail_on_submit:
            self.fired = True
            raise self.exc(f"injected fault: submit #{self.submits} on {self.version}")
        return self.inner.submit(text, max_new=max_new, prefix=prefix)

    def has_work(self):
        return self.inner.has_work()

    def step(self):
        self.steps += 1
        if self.steps == self.fail_on_step:
            self.fired = True
            raise self.exc(f"injected fault: step #{self.steps} on {self.version}")
        return self.inner.step()


def flaky_pool(budget=100, faults=None):
    """Fake session and pool; only the first engine of a version is flaky."""
    built = {}

    def factory(m, device=None):
        e = FakeEngine(m.version, slots=2)
        kw = (faults or {}).get(m.version)
        if kw and m.version not in built:
            e = FlakyEngine(e, **kw)
        built.setdefault(m.version, []).append(e)
        return e

    pool = ModelPool(FakeSession(), budget, engine_factory=factory,
                     entry_bytes=lambda m: 20)
    return pool, built


class TestQuarantine:
    PROMPTS = ["alpha", "br", "charlie", "dx", "echo!"]

    def _clean_rows(self):
        pool, _ = flaky_pool()
        sched = Scheduler(pool, share=4)
        s = sched.submit("t", list(self.PROMPTS), qsig="q")
        sched.run()
        return s.results()

    @pytest.mark.parametrize("fault", [{"fail_on_step": 2}, {"fail_on_submit": 2}],
                             ids=["step", "submit"])
    def test_fault_retries_to_clean_rows(self, fault):
        clean = self._clean_rows()
        pool, built = flaky_pool(faults={"q": fault})
        sched = Scheduler(pool, share=4)
        s = sched.submit("t", list(self.PROMPTS), qsig="q")
        sched.run()
        assert s.done and s.error is None
        assert s.results() == clean
        assert built["q"][0].fired
        assert sched.stats.degradations == 1
        ev = sched.stats.events[0]
        assert ev["action"] == "retry_base" and ev["tenant"] == "t"
        assert "injected fault" in ev["error"]
        assert "q" not in pool.resident_versions

    def test_retry_budget_exhaustion_is_terminal(self):
        pool, _ = flaky_pool(faults={"q": {"fail_on_step": 1},
                                     "base": {"fail_on_step": 1}})
        sched = Scheduler(pool, share=4, max_retries=1)
        s = sched.submit("t", list(self.PROMPTS), qsig="q")
        sched.run()
        assert s.done and s.error is not None
        assert sched.stats.events[-1]["action"] == "failed"
        with pytest.raises(RuntimeError):
            s.results()

    def test_innocent_tenant_unaffected_by_fault(self):
        pool, _ = flaky_pool(faults={"q": {"fail_on_step": 2}})
        sched = Scheduler(pool, share=4)
        s1 = sched.submit("t1", list(self.PROMPTS), qsig="q")
        s2 = sched.submit("t2", ["x", "yy", "zzz"], qsig="ok")
        sched.run()
        assert s1.done and s1.error is None
        assert s2.results() == ["out(x)", "out(yy)", "out(zzz)"]
        assert sched.stats.tenants["t2"].degradations == 0


# ---------------------------------------------------------------------------
# plan <-> JSON wire format
# ---------------------------------------------------------------------------

class TestSpecRoundTrip:
    SESS = SimpleNamespace(pool=None, backend="auto")

    def _query(self):
        t = Table({"city": ["ab", "cdef", "gh"], "pop": [1, 9, 4]})
        return (Query(t, self.SESS, cascade_budget=0.2, cascade="off")
                .filter(PLAN.ColumnPredicate("pop", "ge", 4), columns=["pop"])
                .llm_map("city", prompt="Summarize: ", out_col="s", max_new=6)
                .llm_filter("city", prompt="Keep? ", max_new=4)
                .select(["city", "s"]))

    def test_roundtrip_is_fixpoint(self):
        spec = self._query().to_spec()
        q2 = query_from_spec(json.loads(json.dumps(spec)), self.SESS)
        assert q2.to_spec() == spec
        assert PLAN.render(q2._root) == PLAN.render(self._query()._root)

    def test_join_and_correct_roundtrip(self):
        q = (Query(Table({"name": ["aa", "bb"]}), self.SESS)
             .llm_correct("name", prompt="Fix: ", max_new=5)
             .llm_join(Table({"ref": ["aa!", "zz"]}), ("name", "ref"),
                       prompt="Same? ", max_new=4, accuracy_budget=0.1))
        spec = json.loads(json.dumps(q.to_spec()))
        assert query_from_spec(spec, self.SESS).to_spec() == q.to_spec()

    def test_malformed_specs_rejected(self):
        with pytest.raises(ValueError, match="version"):
            query_from_spec({"version": 99, "table": {"columns": {}}, "ops": []},
                            self.SESS)
        with pytest.raises(ValueError, match="unknown query spec op"):
            query_from_spec({"version": 1, "table": {"columns": {"a": ["x"]}},
                             "ops": [{"op": "drop_table"}]}, self.SESS)


# ---------------------------------------------------------------------------
# the tiny model: HTTP end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    rcfg = RConfig(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, d_ff=128, vocab_size=260, max_seq=256,
                   param_dtype="float32")
    rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, rparams, from_reference(rcfg), bridge.from_reference(
        jax.device_get(rparams), device="cpu")


def make_session(tiny, **kw):
    _, _, cfg, params = tiny
    kw.setdefault("recipes", [Recipe(**W8)])
    kw.setdefault("calib_rows", 4)
    kw.setdefault("eval_rows", 2)
    kw.setdefault("engine_kw", dict(ENGINE_KW))
    return IOLMSession(params, cfg, device="cpu", **kw)


def ref_session(tiny, **kw):
    rcfg, rparams, _, _ = tiny
    return RQ.IOLMSession(rparams, rcfg, recipes=[RRecipe(**W8)], calib_rows=4,
                          eval_rows=2, engine_kw=dict(ENGINE_KW), **kw)


def demo_spec(rows=4, optimize=True):
    langs = ["pyton", "javascrpt", "golang", "rst", "kotln", "hskell"][:rows]
    return (Query(Table({"lang": langs}), SimpleNamespace(pool=None, backend="auto"),
                  optimize=optimize)
            .llm_correct("lang", max_new=6).to_spec())


@pytest.fixture(scope="module")
def served(tiny):
    sess = make_session(tiny, pool_budget=BUDGET)
    svc = SemanticQueryService(
        sess, slos={"capped": TenantSLO(max_inflight_rows=1, max_queries=2)},
        default_slo=TenantSLO(max_inflight_rows=256, max_queries=8))
    server, _ = serve(svc, port=0, block=False)
    host, port = server.server_address[:2]
    try:
        yield svc, ServiceClient(host, port, max_retries=0)
    finally:
        server.shutdown()
        server.server_close()
        svc.stop()


class TestServiceHTTP:
    def test_healthz(self, served):
        h = served[1].healthz()
        assert h["ok"] is True and h["uptime_s"] >= 0

    def test_http_rows_match_run_queries(self, served, tiny):
        svc, client = served
        spec = demo_spec(rows=4)
        got = client.query("t1", spec)
        ref_sess = make_session(tiny, pool_budget=BUDGET)
        res = Scheduler(ref_sess.pool, share=8).run_queries(
            {"t1": query_from_spec(spec, ref_sess)})
        assert got == table_rows(res["t1"])
        assert len(got) == 4 and "lang_fixed" in got[0]
        rsess = ref_session(tiny, pool_budget=BUDGET)
        from repro.serving.scheduler import Scheduler as RScheduler
        want = RScheduler(rsess.pool, share=8).run_queries(
            {"t1": RQ.query_from_spec(spec, rsess)})
        assert got == ref_table_rows(want["t1"])

    def test_streaming_order_and_event_schema(self, served):
        events = list(served[1].iter_query("t2", demo_spec(rows=3)))
        kinds = [e["event"] for e in events]
        assert kinds[-1] == "done"
        ops = [e for e in events if e["event"] == "op"]
        rows = [e for e in events if e["event"] == "row"]
        assert len(ops) >= 1 and {"kind", "qsig", "rows"} <= set(ops[0])
        assert [e["index"] for e in rows] == list(range(len(rows)))
        assert kinds.index("row") > kinds.index("op")
        assert events[-1]["rows"] == len(rows) == 3

    def test_slo_shed_is_429_with_retry_after(self, served):
        svc, client = served
        shed_before = svc.shed
        with pytest.raises(ShedError) as ei:
            client.query("capped", demo_spec(rows=4))
        assert ei.value.verdict["reason"] == "max_inflight_rows"
        assert float(ei.value.verdict["retry_after_s"]) > 0
        assert svc.shed > shed_before
        assert svc.stats_dict()["admission"]["capped"]["shed"] >= 1

    def test_stats_schema_and_percentiles(self, served):
        svc, client = served
        client.query("t1", demo_spec(rows=3))
        stats = client.stats()
        assert {"service", "scheduler", "admission", "pool", "session"} <= set(stats)
        assert stats["service"]["queries"] >= 1
        t1 = stats["scheduler"]["tenants"]["t1"]
        for hist in (t1["latency"], t1["queue_wait"]):
            assert {"count", "mean", "p50", "p95", "p99"} <= set(hist)
            assert hist["count"] > 0 and hist["p50"] is not None
            assert hist["p50"] <= hist["p95"] <= hist["p99"]
        assert stats["session"]["recalibrations"] >= 1
        text = client.stats_text()
        assert "SERVICE STATS" in text and "tenants:" in text
        assert render_stats(stats) == text

    def test_malformed_spec_is_400(self, served):
        with pytest.raises(QueryError, match="HTTP 400"):
            served[1].query("t1", {"version": 99, "table": {"columns": {}}, "ops": []})

    def test_checkpoint_endpoint(self, served, tmp_path):
        svc, client = served
        client.query("t1", demo_spec(rows=3))
        out = client.checkpoint(str(tmp_path / "warm"))
        assert out["ok"] is True
        with open(tmp_path / "warm" / "service_state.json") as f:
            manifest = json.load(f)
        assert manifest["version"] == 1 and manifest["models"]


def test_kernel_error_stops_the_service(tiny):
    """A KernelError out of an engine is not a query's error: no retry on
    the base engine, the pump stops, the query ends with kind
    KernelError, healthz turns to 503 and stop() re-raises it."""
    sess = make_session(tiny, pool_budget=BUDGET)
    real = sess.pool._engine_factory
    fault = KernelError("quant_matmul launch failed with CUDA error 700")
    sess.pool._engine_factory = lambda m, **kw: FlakyEngine(
        real(m, **kw), fail_on_step=1, exc=lambda msg: fault)
    svc = SemanticQueryService(sess)
    server, _ = serve(svc, port=0, block=False)
    client = ServiceClient(*server.server_address[:2], max_retries=0)
    try:
        with pytest.raises(QueryError, match="KernelError"):
            client.query("t", demo_spec(rows=2, optimize=False))
        assert svc.fault is fault and svc.sched.stats.degradations == 0
        with pytest.raises(QueryError, match="HTTP 500"):
            client.query("t", demo_spec(rows=2))
        c = http.client.HTTPConnection(*server.server_address[:2], timeout=10)
        c.request("GET", "/healthz")
        r = c.getresponse()
        assert r.status == 503 and json.loads(r.read())["ok"] is False
        c.close()
    finally:
        server.shutdown()
        server.server_close()
        with pytest.raises(KernelError):
            svc.stop()


# ---------------------------------------------------------------------------
# warm restart
# ---------------------------------------------------------------------------

def _cascade_query(mod, table_cls, sess):
    return (mod.Query(table_cls({"lang": ["pyton", "javascrpt", "golang"]}), sess,
                      cascade="force")
            .llm_correct("lang", max_new=6, accuracy_budget=0.5))


def test_restart_answers_seen_query_without_recalibration(tiny, tmp_path):
    import repro_torch.olap.query as PQ
    sess = make_session(tiny, pool_budget=BUDGET)
    q = _cascade_query(PQ, Table, sess)
    spec = q.to_spec()
    rows = table_rows(q.run())
    assert sess.recalibrations >= 1 and sess.cascade_fits >= 1
    ckpt = str(tmp_path / "warm")
    save_warm_state(sess, ckpt)
    fresh = make_session(tiny, pool_budget=BUDGET)
    restore_warm_state(fresh, ckpt)
    assert fresh.recalibrations == 0 and fresh.cascade_fits == 0
    assert {k: m.recipe.name for k, m in fresh.model_cache._d.items()} == \
        {k: m.recipe.name for k, m in sess.model_cache._d.items()}
    assert set(fresh.pool.resident_versions) == set(sess.pool.resident_versions)
    assert table_rows(query_from_spec(spec, fresh).run()) == rows
    assert fresh.recalibrations == 0 and fresh.cascade_fits == 0


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_warm_state_crosses_packages(tiny, writer, tmp_path):
    """Warm state saved by one package's service restores in the other's
    and answers the same spec with the writer's rows, with no
    recalibration and no cascade fit."""
    import repro_torch.olap.query as PQ
    ckpt = str(tmp_path / "warm")
    if writer == "reference":
        w = ref_session(tiny, pool_budget=BUDGET)
        q = _cascade_query(RQ, __import__("repro.olap.table", fromlist=["x"]).Table, w)
        spec, rows = q.to_spec(), ref_table_rows(q.run())
        RWARM.save_warm_state(w, ckpt)
        r = make_session(tiny, pool_budget=BUDGET)
        manifest = restore_warm_state(r, ckpt)
        got = table_rows(query_from_spec(spec, r).run())
    else:
        w = make_session(tiny, pool_budget=BUDGET)
        q = _cascade_query(PQ, Table, w)
        spec, rows = q.to_spec(), table_rows(q.run())
        save_warm_state(w, ckpt)
        r = ref_session(tiny, pool_budget=BUDGET)
        manifest = RWARM.restore_warm_state(r, ckpt)
        got = ref_table_rows(RQ.query_from_spec(spec, r).run())
    assert manifest["models"] and manifest["cascades"]
    assert {k: m.recipe.name for k, m in r.model_cache._d.items()} == \
        {k: m.recipe.name for k, m in w.model_cache._d.items()}
    assert {k: m.version for k, m in r.model_cache._d.items()} == \
        {k: m.version for k, m in w.model_cache._d.items()}
    assert r.recalibrations == 0 and r.cascade_fits == 0
    assert got == rows
