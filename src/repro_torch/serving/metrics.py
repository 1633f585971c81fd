"""Streaming per-tenant latency metrics for the serving layer.

A long-running service cannot keep every row latency in memory, yet the
SLO numbers operators actually watch are tail percentiles.  ``Reservoir``
is a classic Algorithm-R reservoir sampler (Vitter 1985) over a latency
stream: exact below ``capacity`` observations (it simply stores them
all), an unbiased uniform sample beyond it, with exact count / sum /
min / max tracked on the side.  Percentiles are read off the sorted
sample with the same linear interpolation as
``statistics.quantiles(..., method="inclusive")``, so for streams that
fit the reservoir the estimator IS the exact quantile (tested in
tests/test_torch_metrics.py against ``statistics.quantiles``).

Determinism: the sampler draws from a private ``random.Random(seed)``,
never the global RNG — two services fed the same stream report the same
percentiles, and tests can assert on estimates for streams longer than
the capacity.

The module is the reference's ``repro/serving/metrics.py`` line for
line (it imports only the standard library): the same seed and stream
keep the same sample on either side.

``TenantStats`` bundles the two histograms the scheduler maintains per
tenant — queue wait (submit -> first activation) and per-row latency
(engine submit -> row completion) — plus row/degradation counters.
``render_stats`` turns a stats dict (SchedulerStats.as_dict + service
counters) into the EXPLAIN-style text block served by ``/stats?format=
text``.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

PERCENTILES = (0.50, 0.95, 0.99)


class Reservoir:
    """Algorithm-R reservoir percentile estimator (pure Python).

    Exact for streams up to ``capacity`` (every observation is kept);
    beyond that each observation is retained with probability
    ``capacity / n`` — a uniform sample of the whole stream.  count,
    sum, min and max are always exact.
    """

    def __init__(self, capacity: int = 512, seed: int = 0xA5):
        if capacity < 1:
            raise ValueError("reservoir capacity must be >= 1")
        self.capacity = int(capacity)
        self._rng = random.Random(seed)
        self.sample: List[float] = []
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def add(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        self.vmin = x if self.vmin is None else min(self.vmin, x)
        self.vmax = x if self.vmax is None else max(self.vmax, x)
        if len(self.sample) < self.capacity:
            self.sample.append(x)
        else:
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self.sample[j] = x

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> Optional[float]:
        """Linear interpolation over the sorted sample at position
        ``q * (n - 1)`` — the "inclusive" quantile method, so a full
        (un-overflowed) reservoir matches ``statistics.quantiles(data,
        method="inclusive")`` exactly.  None before any observation."""
        if not self.sample:
            return None
        s = sorted(self.sample)
        pos = q * (len(s) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        frac = pos - lo
        return s[lo] * (1.0 - frac) + s[hi] * frac

    def as_dict(self) -> Dict[str, object]:
        d: Dict[str, object] = {"count": self.count, "mean": self.mean,
                                "min": self.vmin, "max": self.vmax}
        for q in PERCENTILES:
            d[f"p{int(q * 100)}"] = self.quantile(q)
        return d


@dataclass
class TenantStats:
    """Per-tenant serving record inside ``SchedulerStats``."""
    rows: int = 0
    degradations: int = 0
    queue_wait: Reservoir = field(default_factory=Reservoir)
    latency: Reservoir = field(default_factory=Reservoir)

    def as_dict(self) -> Dict[str, object]:
        return {"rows": self.rows, "degradations": self.degradations,
                "queue_wait": self.queue_wait.as_dict(),
                "latency": self.latency.as_dict()}


def _fmt(v: object) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v * 1e3:.1f}ms"
    return str(v)


def render_stats(stats: Dict[str, object]) -> str:
    """EXPLAIN-style text rendering of a service stats dict (the JSON
    shape built by ``SemanticQueryService.stats_dict``; scheduler-only
    dicts from ``SchedulerStats.as_dict`` render too)."""
    sched = stats.get("scheduler", stats)
    lines = ["SERVICE STATS"]
    svc = stats.get("service")
    if svc:
        lines.append(
            f"  service: uptime={svc.get('uptime_s', 0.0):.1f}s "
            f"queries={svc.get('queries', 0)} "
            f"shed={svc.get('shed', 0)} errors={svc.get('errors', 0)}")
    lines.append(
        f"  scheduler: ticks={sched.get('ticks', 0)} "
        f"rows={sched.get('rows', 0)} "
        f"rows/s={sched.get('rows_per_s', 0.0):.1f} "
        f"degradations={sched.get('degradations', 0)}")
    tenants = sched.get("tenants", {})
    if tenants:
        lines.append("  tenants:")
        for i, (name, ts) in enumerate(sorted(tenants.items()), 1):
            lat, qw = ts.get("latency", {}), ts.get("queue_wait", {})
            lines.append(
                f"    {i}. {name}: rows={ts.get('rows', 0)}"
                + (f" degradations={ts['degradations']}"
                   if ts.get("degradations") else ""))
            lines.append(
                "       latency p50=" + _fmt(lat.get("p50"))
                + " p95=" + _fmt(lat.get("p95"))
                + " p99=" + _fmt(lat.get("p99"))
                + " | queue_wait p50=" + _fmt(qw.get("p50"))
                + " p95=" + _fmt(qw.get("p95"))
                + " p99=" + _fmt(qw.get("p99")))
    events = sched.get("events", [])
    if events:
        lines.append("  degradation events:")
        for e in events[-8:]:
            lines.append(
                f"    tick {e.get('tick')}: tenant={e.get('tenant')} "
                f"engine={e.get('engine')} action={e.get('action')} "
                f"({e.get('error')})")
    pool = stats.get("pool")
    if pool:
        lines.append(
            f"  pool: resident={pool.get('resident_models', 0)} "
            f"hits={pool.get('hits', 0)} misses={pool.get('misses', 0)} "
            f"evictions={pool.get('evictions', 0)}")
    adm = stats.get("admission")
    if adm:
        lines.append("  admission:")
        for name, a in sorted(adm.items()):
            lines.append(
                f"    {name}: admitted={a.get('admitted', 0)} "
                f"shed={a.get('shed', 0)} "
                f"inflight_rows={a.get('inflight_rows', 0)}")
    return "\n".join(lines)
