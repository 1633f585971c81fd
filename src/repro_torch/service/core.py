"""The service core: one pump thread driving the scheduler tick loop.

Threading model: ALL engine and device work happens on ONE thread (the
pump).  HTTP handler threads (server.py) only parse specs, run
admission, and enqueue ``QueryJob``s on the inbox; the pump thread
starts a ``QueryDriver`` per job, ticks the shared ``Scheduler`` while
any driver is live, polls each driver, and emits progress events onto
the job's private event queue, which the handler thread drains back to
the client as NDJSON.  Single-threaded engine access means the service
inherits the scheduler's determinism: the HTTP path and a direct
``Scheduler.run_queries`` call give identical rows.

Event stream per query (in order):

  {"event": "op",    "index": i, "kind": ..., "qsig": ..., "rows": n}
  {"event": "row",   "index": i, "row": {col: value, ...}}   (per row)
  {"event": "done",  "rows": n, "ops": k}
  {"event": "error", "error": "...", "kind": "ExcType"}      (terminal)

Rows stream strictly in index order.

The reference's ``repro/service/core.py`` over the port's ``Scheduler``
and ``QueryDriver``, with one rule of the port's scheduler kept: a
:class:`KernelError` (a hand-written kernel that fails to build, load or
launch, or refuses its inputs) is a fault of the service, not of one
query.  It is never retried on another engine and never reported as a
plan error: the pump stops, every queued and running job gets a
terminal ``KernelError`` event, later submissions raise it, ``/healthz``
reports it, and :meth:`SemanticQueryService.stop` re-raises it to the
owner.  The catch of any other exception around plan construction stays
as in the reference.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from repro_torch.kernels.build import KernelError
from repro_torch.olap.query import IOLMSession, Query, query_from_spec
from repro_torch.olap.table import Table
from repro_torch.serving.scheduler import QueryDriver, Scheduler
from repro_torch.service.slo import AdmissionController, Shed, TenantSLO


def table_rows(table: Table) -> List[Dict[str, Any]]:
    """A Table as an ordered list of row dicts (the wire row form)."""
    cols = list(table.columns)
    return [dict(zip(cols, vals))
            for vals in zip(*(table.columns[c] for c in cols))] \
        if cols else []


class QueryJob:
    """One admitted query: the spec-built plan plus its event queue."""

    def __init__(self, jid: int, tenant: str, query: Query, *,
                 est_rows: int, est_tokens: float,
                 share: Optional[int] = None):
        self.jid = jid
        self.tenant = tenant
        self.query = query
        self.est_rows = est_rows
        self.est_tokens = est_tokens
        self.share = share
        self.events: "queue.Queue[Dict[str, Any]]" = queue.Queue()
        self.driver: Optional[QueryDriver] = None

    def stream(self, timeout: float = 120.0) -> Iterator[Dict[str, Any]]:
        """Drain events until the terminal done/error event (incl.)."""
        while True:
            ev = self.events.get(timeout=timeout)
            yield ev
            if ev.get("event") in ("done", "error"):
                return

    def rows(self, timeout: float = 120.0) -> List[Dict[str, Any]]:
        """Block for the result rows; raises on a query error."""
        out: List[Dict[str, Any]] = []
        for ev in self.stream(timeout=timeout):
            if ev["event"] == "row":
                out.append(ev["row"])
            elif ev["event"] == "error":
                raise RuntimeError(
                    f"query failed ({ev.get('kind')}): {ev['error']}")
        return out


class SemanticQueryService:
    """Always-on front half of the stack: admission + pump + stats.

    Wraps one ``IOLMSession`` (which must carry a ``ModelPool``) and
    one ``Scheduler``; jobs admitted by the ``AdmissionController``
    flow through ``QueryDriver``s interleaved tick-by-tick exactly as
    ``Scheduler.run_queries`` would interleave them.
    """

    def __init__(self, session: IOLMSession, *,
                 slos: Optional[Dict[str, TenantSLO]] = None,
                 default_slo: Optional[TenantSLO] = None,
                 share: int = 8, max_retries: int = 2,
                 idle_wait_s: float = 0.02):
        if session.pool is None:
            raise ValueError("SemanticQueryService needs a pooled session "
                             "(pass pool_budget= to IOLMSession)")
        self.session = session
        self.sched = Scheduler(session.pool, share=share,
                               max_retries=max_retries)
        self.admission = AdmissionController(slos, default=default_slo)
        self.idle_wait_s = idle_wait_s
        self.t0 = time.time()
        self.queries = 0
        self.shed = 0
        self.errors = 0
        self.fault: Optional[KernelError] = None
        self._jid = itertools.count(1)
        self._inbox: "queue.Queue[QueryJob]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "SemanticQueryService":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._pump, name="service-pump", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 60.0) -> None:
        """Graceful: the pump finishes every started job, then exits.
        Re-raises the kernel fault that stopped the pump, if one did."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        if self.fault is not None:
            raise self.fault

    # -- admission + submit ---------------------------------------------
    def estimate(self, q: Query) -> tuple:
        """(est result rows, est prompt tokens) from the physical plan
        — the admission charge.  Plan lowering does no engine work, so
        this is safe on a handler thread."""
        pplan = q.physical_plan()
        rows = len(q.table)
        for step in pplan.llm_ops:
            rows = max(rows, step.est.invocations)
        return max(1, rows), float(pplan.optimized_cost)

    def submit_spec(self, tenant: str, spec: Dict[str, Any]):
        """Parse + admit one query spec.  Returns a ``QueryJob`` whose
        events stream the execution, or a ``Shed`` verdict (the HTTP
        layer's 429).  Raises ``ValueError`` on a malformed spec (the
        HTTP layer's 400)."""
        q = query_from_spec(spec, self.session)
        return self.submit_query(tenant, q)

    def submit_query(self, tenant: str, q: Query):
        if self.fault is not None:
            raise self.fault
        est_rows, est_tokens = self.estimate(q)
        slo = self.admission.slo_for(tenant)
        verdict = self.admission.try_admit(tenant, est_rows, est_tokens)
        if isinstance(verdict, Shed):
            self.shed += 1
            return verdict
        job = QueryJob(next(self._jid), tenant, q,
                       est_rows=est_rows, est_tokens=est_tokens,
                       share=slo.share)
        self.queries += 1
        self._inbox.put(job)
        if self.fault is not None:      # the pump stopped meanwhile
            job.events.put({"event": "error", "error": str(self.fault),
                            "kind": type(self.fault).__name__})
        return job

    # -- the pump -------------------------------------------------------
    def _pump(self) -> None:
        active: List[QueryJob] = []
        try:
            self._pump_loop(active)
        except KernelError as e:
            self.fault = e
            pending = list(active)
            while not self._inbox.empty():
                pending.append(self._inbox.get_nowait())
            for job in pending:
                self.admission.release(job.tenant, job.est_rows)
                self.errors += 1
                job.events.put({"event": "error", "error": str(e),
                                "kind": type(e).__name__})

    def _pump_loop(self, active: List[QueryJob]) -> None:
        while True:
            # drain newly admitted jobs; block briefly when idle so an
            # idle service costs no CPU, never when work is in flight
            try:
                while True:
                    job = (self._inbox.get_nowait() if active else
                           self._inbox.get(timeout=self.idle_wait_s))
                    self._start_job(job, active)
            except queue.Empty:
                pass
            if not active:
                if self._stop.is_set() and self._inbox.empty():
                    return
                continue
            self.sched.step()
            for job in list(active):
                job.driver.poll()
                if job.driver.finished:
                    self._finish_job(job)
                    active.remove(job)

    def _start_job(self, job: QueryJob, active: List[QueryJob]) -> None:
        def on_op(driver, op, outs):
            job.events.put({"event": "op", "index": driver.ops_done,
                            "kind": op.spec.kind, "qsig": op.qsig,
                            "rows": len(outs)})

        job.driver = QueryDriver(self.sched, job.tenant, job.query,
                                 share=job.share, on_op_done=on_op)
        active.append(job)
        try:
            job.driver.start()
        except KernelError:
            raise
        except Exception as e:     # plan construction failure
            job.driver.error = e
        if job.driver.finished:
            self._finish_job(job)
            active.remove(job)

    def _finish_job(self, job: QueryJob) -> None:
        """Emit a finished job's rows or its error; a kernel fault is
        raised with the job still active, so the pump fails it too."""
        d = job.driver
        if isinstance(d.error, KernelError):
            raise d.error
        self.admission.release(job.tenant, job.est_rows)
        if d.error is not None:
            self.errors += 1
            job.events.put({"event": "error", "error": str(d.error),
                            "kind": type(d.error).__name__})
            return
        rows = table_rows(d.result)
        for i, row in enumerate(rows):
            job.events.put({"event": "row", "index": i, "row": row})
        job.events.put({"event": "done", "rows": len(rows),
                        "ops": d.ops_done})

    # -- observability --------------------------------------------------
    def stats_dict(self) -> Dict[str, Any]:
        pool = self.session.pool
        ps = pool.stats
        return {
            "service": {"uptime_s": time.time() - self.t0,
                        "queries": self.queries, "shed": self.shed,
                        "errors": self.errors},
            "scheduler": self.sched.stats.as_dict(),
            "admission": self.admission.snapshot(),
            "pool": {"resident_models": len(pool),
                     "resident_bytes": pool.resident_bytes,
                     "hits": ps.hits, "misses": ps.misses,
                     "evictions": ps.evictions},
            "session": {"recalibrations": self.session.recalibrations,
                        "cascade_fits": self.session.cascade_fits,
                        "model_cache": len(self.session.model_cache),
                        "cascade_cache": len(self.session.cascade_cache)},
        }


__all__ = ["QueryJob", "SemanticQueryService", "table_rows"]
