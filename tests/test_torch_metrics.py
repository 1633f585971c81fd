"""Port latency metrics (``serving/metrics.py``) vs the reference's.

For the same seed and stream the port's ``Reservoir`` keeps the same
sample and gives the same quantiles as the reference's, past capacity
too; within capacity it is exact against ``statistics.quantiles(...,
method="inclusive")``.  ``TenantStats.as_dict`` and ``render_stats``
text equal the reference's.  (The overflow property of
tests/test_service_props.py fails in the reference, so it is no oracle
here.)
"""
import random
import statistics

import pytest

pytest.importorskip("torch")

from repro.serving import metrics as RM  # noqa: E402
from repro_torch.serving import metrics as M  # noqa: E402


def _stream(n, seed):
    rng = random.Random(seed)
    return [rng.lognormvariate(-3.0, 1.0) for _ in range(n)]


@pytest.mark.parametrize("n,capacity,seed", [(10, 512, 0), (500, 64, 1), (5000, 512, 0xA5),
                                             (3, 1, 7)])
def test_reservoir_sample_and_quantiles_equal_reference(n, capacity, seed):
    xs = _stream(n, seed)
    got, want = M.Reservoir(capacity, seed=seed), RM.Reservoir(capacity, seed=seed)
    for x in xs:
        got.add(x)
        want.add(x)
    assert got.sample == want.sample
    assert got.as_dict() == want.as_dict()
    for q in (0.0, 0.1, 0.5, 0.95, 0.99, 1.0):
        assert got.quantile(q) == want.quantile(q)
    assert (got.count, got.vmin, got.vmax) == (n, min(xs), max(xs))


@pytest.mark.parametrize("n", [2, 5, 17, 512])
def test_reservoir_within_capacity_is_exact(n):
    xs = _stream(n, n)
    r = M.Reservoir(512)
    for x in xs:
        r.add(x)
    cuts = statistics.quantiles(xs, n=100, method="inclusive")
    for pct in (5, 50, 95, 99):
        assert r.quantile(pct / 100) == pytest.approx(cuts[pct - 1], rel=1e-12, abs=1e-15)
    assert r.mean == pytest.approx(statistics.fmean(xs))


def test_reservoir_empty_and_bad_capacity():
    r = M.Reservoir()
    assert r.quantile(0.5) is None and r.mean == 0.0
    assert r.as_dict() == RM.Reservoir().as_dict()
    with pytest.raises(ValueError):
        M.Reservoir(0)


def _stats(mod):
    a, b = mod.TenantStats(), mod.TenantStats(degradations=2)
    for i, x in enumerate(_stream(40, 3)):
        (a if i % 3 else b).latency.add(x)
        a.queue_wait.add(x / 10)
        a.rows += 1
    return {
        "service": {"uptime_s": 12.5, "queries": 3, "shed": 1, "errors": 0},
        "scheduler": {"ticks": 40, "rows": 40, "rows_per_s": 3.25, "degradations": 2,
                      "tenants": {"t1": a.as_dict(), "t0": b.as_dict()},
                      "events": [{"tick": 3, "tenant": "t0", "engine": "q:v",
                                  "action": "retry_base", "error": "RuntimeError: x"}]},
        "pool": {"resident_models": 2, "hits": 5, "misses": 2, "evictions": 1},
        "admission": {"t0": {"admitted": 3, "shed": 1, "inflight_rows": 2}}}


def test_tenant_stats_and_render_equal_reference():
    got, want = _stats(M), _stats(RM)
    assert got == want
    assert M.render_stats(got) == RM.render_stats(want)
    sched_only = got["scheduler"]
    assert M.render_stats(sched_only) == RM.render_stats(sched_only)
    assert "tenants:" in M.render_stats(got) and "degradation events:" in M.render_stats(got)
