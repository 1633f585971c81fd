"""Per-tenant SLOs and token-budget admission control.

The fair-share ``Scheduler`` (serving/scheduler.py) keeps admitted work
fair *between* tenants, but a long-running service also needs a gate in
FRONT of the scheduler: without one, a single tenant can enqueue
unbounded work and every other tenant's queue wait grows without limit.
``AdmissionController`` is that gate — it decides, per incoming query,
whether the tenant is within its SLO envelope:

  * **in-flight rows**: the number of result rows the tenant has
    admitted-but-unfinished across all its queries must stay under
    ``TenantSLO.max_inflight_rows`` (tested in
    tests/test_torch_service.py under random interleavings);
  * **concurrent queries**: at most ``max_queries`` plans in flight;
  * **token budget**: a classic token bucket over *estimated prompt
    tokens* (the physical planner's cost estimate) — capacity
    ``token_budget``, refilled at ``refill_per_s``; a query whose
    estimate exceeds the current level is shed.

A rejected query gets a ``Shed`` verdict carrying the machine-readable
reason and a ``retry_after_s`` hint; the HTTP layer maps it to a 429
with a ``Retry-After`` header and the client (client.py) backs off and
retries within a bounded budget.  Shedding is *load* control, not an
error: the verdict is recorded in per-tenant admission stats surfaced
by ``/stats``.

Thread-safety: the controller is called from HTTP handler threads
(admission) and the service pump thread (release), so every mutation
holds one lock.  Time is injected (``clock=``) so tests can drive the
bucket deterministically.

The module is the reference's ``repro/service/slo.py`` line for line (it
imports only the standard library).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional


@dataclass(frozen=True)
class TenantSLO:
    """Admission envelope for one tenant.

    ``share`` caps the tenant's in-flight rows *inside* the scheduler
    (forwarded to every submission) — distinct from
    ``max_inflight_rows``, which gates admission of whole queries.
    """
    max_inflight_rows: int = 64
    max_queries: int = 4
    token_budget: float = float("inf")   # bucket capacity (prompt tokens)
    refill_per_s: float = 0.0            # bucket refill rate
    retry_after_s: float = 0.5           # 429 Retry-After hint
    share: Optional[int] = None          # scheduler in-flight row cap


@dataclass(frozen=True)
class Shed:
    """A 429 verdict: why the query was refused and when to retry."""
    reason: str
    retry_after_s: float
    detail: str = ""


@dataclass
class _TenantState:
    inflight_rows: int = 0
    inflight_queries: int = 0
    tokens: float = 0.0                  # current bucket level
    last_refill: float = 0.0
    admitted: int = 0
    shed: int = 0


class AdmissionController:
    """SLO gate in front of the scheduler (see module docstring)."""

    def __init__(self, slos: Optional[Dict[str, TenantSLO]] = None, *,
                 default: Optional[TenantSLO] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.slos = dict(slos or {})
        self.default = default or TenantSLO()
        self._clock = clock
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantState] = {}

    def slo_for(self, tenant: str) -> TenantSLO:
        return self.slos.get(tenant, self.default)

    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            slo = self.slo_for(tenant)
            st = _TenantState(tokens=min(slo.token_budget, 1e18),
                              last_refill=self._clock())
            self._tenants[tenant] = st
        return st

    def _refill(self, tenant: str, st: _TenantState) -> None:
        slo = self.slo_for(tenant)
        now = self._clock()
        if slo.refill_per_s > 0:
            st.tokens = min(slo.token_budget,
                            st.tokens
                            + (now - st.last_refill) * slo.refill_per_s)
        st.last_refill = now

    def try_admit(self, tenant: str, rows: int,
                  tokens: float) -> Optional[Shed]:
        """Admit one query of ``rows`` estimated result rows and
        ``tokens`` estimated prompt tokens; None means admitted (the
        caller MUST later ``release`` the same rows), a ``Shed`` means
        refused with nothing charged."""
        slo = self.slo_for(tenant)
        with self._lock:
            st = self._state(tenant)
            self._refill(tenant, st)
            if st.inflight_queries + 1 > slo.max_queries:
                st.shed += 1
                return Shed("max_queries", slo.retry_after_s,
                            f"{st.inflight_queries} queries in flight "
                            f"(cap {slo.max_queries})")
            if st.inflight_rows + rows > slo.max_inflight_rows:
                st.shed += 1
                return Shed("max_inflight_rows", slo.retry_after_s,
                            f"{st.inflight_rows}+{rows} rows "
                            f"(cap {slo.max_inflight_rows})")
            if tokens > st.tokens:
                st.shed += 1
                # a refill-rate hint beats the static one when we can
                # compute how long the deficit actually takes to clear
                wait = (slo.retry_after_s if slo.refill_per_s <= 0
                        else max(slo.retry_after_s,
                                 (tokens - st.tokens) / slo.refill_per_s))
                return Shed("token_budget", wait,
                            f"need {tokens:.0f} tokens, have "
                            f"{st.tokens:.0f}")
            st.inflight_queries += 1
            st.inflight_rows += rows
            st.tokens -= tokens
            st.admitted += 1
            return None

    def release(self, tenant: str, rows: int) -> None:
        """Return an admitted query's row charge (on completion OR
        failure — the charge tracks liveness, not success)."""
        with self._lock:
            st = self._state(tenant)
            st.inflight_queries = max(0, st.inflight_queries - 1)
            st.inflight_rows = max(0, st.inflight_rows - rows)

    def inflight_rows(self, tenant: str) -> int:
        with self._lock:
            return self._state(tenant).inflight_rows

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Per-tenant admission counters for ``/stats``."""
        with self._lock:
            out = {}
            for name, st in sorted(self._tenants.items()):
                out[name] = {"admitted": st.admitted, "shed": st.shed,
                             "inflight_rows": st.inflight_rows,
                             "inflight_queries": st.inflight_queries,
                             "tokens": st.tokens}
            return out
