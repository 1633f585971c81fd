"""Port multi-tenant serving (``serving/scheduler.py``) vs the reference's.

- Over fake engines (no model compute): the pool's LRU eviction, hard
  byte budget, pins, retryable and unretryable refusals, and the
  fair-share scheduler's interleaving, share cap and head-of-line
  activation, as ``tests/test_scheduler.py`` holds the reference to; the
  same sequence of calls gives the port and the reference the same
  ``Scheduler.trace``, ``pool.eviction_log``, ``PoolStats`` and events.
- The device-aware pool over ``devices=[torch.device("cpu")] * 4``
  (per-device budget, placement policies) as
  ``tests/test_device_parallel.py`` holds the reference's; ``mesh=``
  is held in ``tests/test_torch_device_parallel.py``.
- Quarantine: an engine that raises in ``step_finish`` gives one
  ``retry_base`` event, keeps every finished row and replays the rest,
  in order, on the pooled base engine.
- On the tiny dense model (tests/conftest.py's shape) in f32 with
  weights bridged from the reference's init: ``run_queries`` tables
  equal the port's serial ``Query.run`` and the reference's
  ``run_queries``; cross-tenant dedup; the shared prefix cache keeps
  model versions apart; the cascade's two-phase form equals the serial
  cascade, and an unfit threshold or budget 0 is base-only.
- ``slot_state_bytes`` equals the reference's for the tiny config and
  for gemma2-2b at its published widths.
- The reference's scheduler and pool properties (hypothesis).
"""
import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import gemma2_2b as rgemma  # noqa: E402
from repro.configs.base import ModelConfig as RConfig  # noqa: E402
from repro.core.pipeline import Recipe as RRecipe  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.olap import query as RQ  # noqa: E402
from repro.olap.table import Table as RTable  # noqa: E402
from repro.serving import scheduler as RS  # noqa: E402
from repro.serving.batcher import Request as RRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference, gemma2_2b  # noqa: E402
from repro_torch.core.calibrate import CascadeCalibration  # noqa: E402
from repro_torch.core.compressed import param_bytes  # noqa: E402
from repro_torch.core.pipeline import InstanceOptimizer, Recipe  # noqa: E402
from repro_torch.kernels.ops import KernelError, KernelInputError  # noqa: E402
from repro_torch.olap.query import IOLMSession, Query  # noqa: E402
from repro_torch.olap.table import Table  # noqa: E402
from repro_torch.serving.batcher import Request  # noqa: E402
from repro_torch.serving.cache import PrefixCache  # noqa: E402
from repro_torch.serving.engine import Engine, StepPending  # noqa: E402
from repro_torch.serving.scheduler import (ModelPool, PoolBudgetError,  # noqa: E402
                                           PoolEntry, Scheduler,
                                           slot_state_bytes)

W8 = dict(name="w8", wbits=8, quant_method="absmax")
CPU = torch.device("cpu")
SETTINGS = dict(max_examples=25, deadline=None)


# ---------------------------------------------------------------------------
# fakes: pool/scheduler mechanics without model compute
# ---------------------------------------------------------------------------

class FakeEngine:
    """Deterministic async-engine stand-in: FIFO slots, each request
    decodes for ``1 + len(text) % 3`` ticks, then finishes as
    ``out(text)``.  ``request`` is the port's or the reference's
    ``Request``, so one fake drives either scheduler."""

    def __init__(self, version, slots=2, device=None, request=Request):
        self.version = version
        self.slots = slots
        self.device = device
        self.request = request
        self.queue = []
        self.active = {}
        self._rid = 0

    def submit(self, text, *, max_new=8, prefix=None):
        r = self.request(rid=self._rid, prompt_ids=[], max_new=max_new)
        self._rid += 1
        r.ticks_left = 1 + (len(text) % 3)
        r.src = text
        self.queue.append(r)
        return r

    def has_work(self):
        return bool(self.queue or self.active)

    def step(self):
        while self.queue and len(self.active) < self.slots:
            r = self.queue.pop(0)
            self.active[r.rid] = r
        finished = []
        for rid in list(self.active):
            r = self.active[rid]
            r.ticks_left -= 1
            if r.ticks_left <= 0:
                r.done, r.text = True, self.output(r.src)
                del self.active[rid]
                finished.append(r)
        return finished

    def output(self, text):
        return f"out({text})"


class FakeSession:
    """Duck-typed IOLMSession: versions == qsigs."""

    params = cfg = tok = None

    def __init__(self):
        self.optimize_calls = []

    def _optimize(self, qsig, probe):
        self.optimize_calls.append(qsig)
        return SimpleNamespace(params=None, cfg=None, version=qsig)


def fake_pool(sizes, budget, slots=2, mod=None, devices=None, placement="least_loaded"):
    """A pool of ``mod`` (the port's scheduler module by default, or the
    reference's) over fake engines charged ``sizes[version]`` bytes."""
    mod = mod or __import__("repro_torch.serving.scheduler", fromlist=["x"])
    request = Request if mod.__name__.startswith("repro_torch") else RRequest
    sess = FakeSession()
    kw = dict(devices=devices, placement=placement) if devices is not None else {}
    pool = mod.ModelPool(
        sess, budget,
        engine_factory=lambda m, device=None: FakeEngine(
            m.version, slots=slots, device=device, request=request),
        entry_bytes=lambda m: sizes[m.version], **kw)
    return sess, pool


def placed_pool(sizes, budget, *, ndev=3, placement="least_loaded"):
    return fake_pool(sizes, budget, devices=[CPU] * ndev, placement=placement)


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

class TestModelPool:
    def test_lru_eviction_under_budget(self):
        sess, pool = fake_pool({"a": 40, "b": 40, "c": 40}, budget=100)
        ea = pool.engine_for("a")
        pool.engine_for("b")
        pool.engine_for("a")                     # refresh a
        pool.engine_for("c")                     # evicts b (LRU), not a
        assert pool.resident_versions == ["a", "c"]
        assert pool.eviction_log == ["b"]
        assert pool.resident_bytes == 80 <= pool.byte_budget
        assert pool.engine_for("a") is ea        # a survived

    def test_budget_is_hard_invariant(self):
        sess, pool = fake_pool({f"m{i}": 30 for i in range(10)}, budget=100)
        for i in range(10):
            pool.engine_for(f"m{i}")
            assert pool.resident_bytes <= pool.byte_budget
        assert len(pool) == 3                    # 3 * 30 <= 100

    def test_oversize_model_raises_unretryable(self):
        sess, pool = fake_pool({"big": 200}, budget=100)
        with pytest.raises(PoolBudgetError) as ei:
            pool.engine_for("big")
        assert not ei.value.retryable

    def test_pinned_entries_never_evicted(self):
        sess, pool = fake_pool({"a": 60, "b": 60}, budget=100)
        pool.engine_for("a")
        pool.pin("a")
        with pytest.raises(PoolBudgetError) as ei:
            pool.engine_for("b")                 # a pinned: cannot make room
        assert ei.value.retryable
        assert pool.resident_versions == ["a"]
        pool.unpin("a")
        pool.engine_for("b")                     # now a is evictable
        assert pool.eviction_log == ["a"]

    def test_retryable_refusal_evicts_nothing(self):
        sess, pool = fake_pool({"a": 60, "b": 30, "c": 50}, budget=100)
        pool.engine_for("a")
        pool.pin("a")
        pool.engine_for("b")                 # resident but idle
        with pytest.raises(PoolBudgetError) as ei:
            pool.engine_for("c")             # 60 pinned + 50 > 100
        assert ei.value.retryable
        assert pool.resident_versions == ["a", "b"]
        assert pool.eviction_log == []

    def test_blocked_submission_optimizes_once(self):
        sess, pool = fake_pool({"a": 80, "b": 80}, budget=100)
        sched = Scheduler(pool, share=2)
        sched.submit("t1", ["xxxx", "yyyy"], qsig="a")
        s2 = sched.submit("t2", ["zz"], qsig="b")
        sched.run()
        assert s2.done
        assert sess.optimize_calls.count("b") == 1

    def test_eviction_reoptimizes_on_readmit(self):
        sess, pool = fake_pool({"a": 60, "b": 60}, budget=100)
        pool.engine_for("a")
        pool.engine_for("b")                     # evicts a
        pool.engine_for("a")                     # miss: optimize again
        assert sess.optimize_calls == ["a", "b", "a"]
        assert pool.stats.misses == 3 and pool.stats.evictions == 2

    def test_resident_hit_skips_rebuild(self):
        sess, pool = fake_pool({"a": 10}, budget=100)
        e1 = pool.engine_for("a")
        e2 = pool.engine_for("a")
        assert e1 is e2
        assert pool.stats.hits == 1
        assert sess.optimize_calls == ["a", "a"]

    def test_discard_drops_a_pinned_entry_once(self):
        sess, pool = fake_pool({"a": 60, "b": 60}, budget=100)
        ea = pool.engine_for("a")
        pool.pin("a")
        assert not pool.discard("a", engine=object())     # another engine: kept
        assert pool.discard("a", engine=ea)
        assert not pool.pinned("a") and pool.resident_versions == []
        assert pool.eviction_log == ["a"] and pool.stats.evictions == 1
        pool.engine_for("b")                              # the room is free


class TestSchedulerFairness:
    def test_tenants_interleave_not_serialize(self):
        sess, pool = fake_pool({"a": 10, "b": 10}, budget=100, slots=4)
        sched = Scheduler(pool, share=2)
        s1 = sched.submit("t1", [f"p{i}" for i in range(6)], qsig="a")
        s2 = sched.submit("t2", [f"q{i}" for i in range(6)], qsig="b")
        sched.run()
        assert s1.done and s2.done
        assert len(s1.results()) == 6 and len(s2.results()) == 6
        assert max(s1.first_done_tick, s2.first_done_tick) \
            <= min(s1.last_done_tick, s2.last_done_tick)
        assert s1.peak_inflight <= 2 and s2.peak_inflight <= 2

    @pytest.mark.parametrize("share,sub_share,cap", [(3, None, 3), (8, 2, 2), (2, 5, 2)])
    def test_share_bounds_admission_per_tenant(self, share, sub_share, cap):
        sess, pool = fake_pool({"a": 10}, budget=100, slots=8)
        sched = Scheduler(pool, share=share)
        s = sched.submit("t", [f"p{i}" for i in range(10)], qsig="a", share=sub_share)
        sched.run()
        assert s.peak_inflight == cap and len(s.results()) == 10

    def test_budget_wait_head_of_line_activation(self):
        sess, pool = fake_pool({"a": 80, "b": 80}, budget=100)
        sched = Scheduler(pool, share=2)
        s1 = sched.submit("t1", ["x", "yy"], qsig="a")
        s2 = sched.submit("t2", ["zzz"], qsig="b")
        assert s1.active and not s2.active       # b blocked by pinned a
        sched.run()
        assert s1.done and s2.done
        assert pool.eviction_log == ["a"]        # evicted once unpinned
        assert len(s2.results()) == 1
        assert sched.stats.tenants["t2"].queue_wait.count == 1

    def test_oversize_submission_fails_alone(self):
        sess, pool = fake_pool({"ok": 40, "big": 200}, budget=100)
        sched = Scheduler(pool, share=2)
        s1 = sched.submit("t1", ["xx", "yy"], qsig="ok")
        s2 = sched.submit("t2", ["zz"], qsig="big")
        sched.run()                              # must not raise
        assert s1.done and len(s1.results()) == 2
        assert s2.done and s2.error is not None
        with pytest.raises(PoolBudgetError):
            s2.results()

    def test_zero_prompt_submission_completes(self):
        sess, pool = fake_pool({"a": 10}, budget=100)
        sched = Scheduler(pool, share=2)
        s = sched.submit("t", [], qsig="a")
        sched.run()
        assert s.done and s.results() == []


def _drive(mod):
    """One fixed sequence of pool and scheduler calls over fake engines:
    three tenants, a budget that holds two of their models, one model
    that never fits, a pin held across an admission."""
    sizes = {"a": 45, "b": 45, "c": 45, "big": 500}
    sess, pool = fake_pool(sizes, budget=100, mod=mod)
    pool.engine_for("c")
    pool.pin("c")
    try:
        pool.engine_for("big")
    except mod.PoolBudgetError:
        pass
    pool.unpin("c")
    sched = mod.Scheduler(pool, share=2)
    sched.submit("t1", [f"row{i}" * (i % 3 + 1) for i in range(7)], qsig="a")
    sched.submit("t2", [f"x{i}" for i in range(5)], qsig="b", share=1)
    sched.submit("t3", ["yy", "zzz", "w"], qsig="c")
    sched.submit("t4", ["never"], qsig="big")
    sched.run()
    subs = sorted(sched.finished, key=lambda s: s.tenant)
    outs = [(s.tenant, s.results() if s.error is None else type(s.error).__name__,
             s.peak_inflight, s.first_done_tick, s.last_done_tick) for s in subs]
    return (sched.trace, pool.eviction_log, dataclasses.asdict(pool.stats),
            (sched.stats.ticks, sched.stats.rows, sched.stats.degradations,
             sched.stats.events, sched.stats.peak_concurrent_devices),
            {t: (ts.rows, ts.degradations, ts.queue_wait.count, ts.latency.count)
             for t, ts in sched.stats.tenants.items()}, outs, sess.optimize_calls)


def test_trace_eviction_log_and_stats_equal_reference():
    got, want = _drive(__import__("repro_torch.serving.scheduler", fromlist=["x"])), _drive(RS)
    for g, w in zip(got, want):
        assert g == w
    trace, log = got[0], got[1]
    assert len(trace) == 15 and log          # every row, and evictions happened


# ---------------------------------------------------------------------------
# quarantine
# ---------------------------------------------------------------------------

class SplitFakeEngine(FakeEngine):
    """A fake with the ``step_begin``/``step_finish`` split; the engine
    for version ``bad`` raises ``error`` in ``step_finish`` on its
    ``fail_at``-th tick.  Outputs name the engine's version."""

    def __init__(self, version, fail_at=None, error=None, **kw):
        super().__init__(version, **kw)
        self.fail_at, self.ticks = fail_at, 0
        self.error = error or RuntimeError("decode step failed")

    def output(self, text):
        return f"{self.version}:{text}"

    def step_begin(self):
        return StepPending([], "launched")

    def step_finish(self, pending):
        self.ticks += 1
        if self.ticks == self.fail_at:
            raise self.error
        return self.step()


def test_quarantine_retries_on_base_and_replays_unfinished_rows_in_order():
    sess = FakeSession()
    engines = []

    def factory(m, device=None):
        engines.append(SplitFakeEngine(m.version, slots=2,
                                       fail_at=3 if m.version == "bad" else None))
        return engines[-1]

    pool = ModelPool(sess, 100, engine_factory=factory, entry_bytes=lambda m: 10)
    sched = Scheduler(pool, share=2)
    prompts = ["p0", "p1x", "p2xx", "p3", "p4x", "p5xx"]
    sub = sched.submit("t1", prompts, qsig="bad")
    other = sched.submit("t2", ["q0", "q1"], qsig="good")
    sched.run()
    assert sched.stats.degradations == 1
    (ev,) = sched.stats.events
    assert ev == {"tick": 3, "tenant": "t1", "engine": "bad",
                  "error": "RuntimeError: decode step failed", "action": "retry_base"}
    # p1x (one tick of decode) finished on the faulty engine at tick 1 and
    # keeps its output; p0 and p2xx were in flight at the fault and p3..p5xx
    # not yet submitted: all five ran on the pooled base engine, in order
    assert sub.results() == ["base:p0", "bad:p1x", "base:p2xx", "base:p3",
                             "base:p4x", "base:p5xx"]
    assert [t for t, who in sched.trace if who == "t1"] == [1, 5, 6, 7, 8, 9]
    assert other.results() == ["good:q0", "good:q1"]
    assert "bad" not in pool.resident_versions and pool.eviction_log == ["bad"]
    assert sched.stats.tenants["t1"].degradations == 1
    assert sched.stats.rows == len(prompts) + 2


def test_quarantine_gives_up_after_max_retries():
    sess = FakeSession()
    pool = ModelPool(sess, 100, entry_bytes=lambda m: 10,
                     engine_factory=lambda m, device=None: SplitFakeEngine(
                         m.version, fail_at=1))
    sched = Scheduler(pool, share=2, max_retries=1)
    sub = sched.submit("t", ["a", "b"], qsig="bad")
    sched.run()
    assert [e["action"] for e in sched.stats.events] == ["retry_base", "failed"]
    with pytest.raises(RuntimeError, match="decode step failed"):
        sub.results()


@pytest.mark.parametrize("error", [
    KernelError("quant_matmul launch failed with CUDA error 700"),
    KernelError("nvcc failed for paged_attention.cu"),
    KernelInputError("quant_matmul: q must be [K, N] int8"),
], ids=["launch", "build", "input"])
def test_kernel_error_is_not_served_around(error):
    """A kernel fault propagates out of the tick: no quarantine, no
    retry on the base engine, no event."""
    sess = FakeSession()
    pool = ModelPool(sess, 100, entry_bytes=lambda m: 10,
                     engine_factory=lambda m, device=None: SplitFakeEngine(
                         m.version, fail_at=2 if m.version == "bad" else None,
                         error=error))
    sched = Scheduler(pool, share=2)
    sched.submit("t", ["a", "bb", "ccc"], qsig="bad")
    with pytest.raises(type(error)) as raised:
        sched.run()
    assert raised.value is error
    assert sched.stats.degradations == 0 and sched.stats.events == []
    assert pool.eviction_log == [] and "base" not in pool.resident_versions


# ---------------------------------------------------------------------------
# the device-aware pool
# ---------------------------------------------------------------------------

class TestPerDeviceBudget:
    def test_budget_is_per_device_hard_invariant(self):
        sizes = {f"m{i}": 30 + 7 * (i % 3) for i in range(12)}
        _, pool = placed_pool(sizes, budget=100, ndev=3)
        for i in range(12):
            try:
                pool.engine_for(f"m{i}")
            except PoolBudgetError:
                pass
            for d in range(3):
                assert pool.device_bytes(d) <= pool.byte_budget

    def test_capacity_scales_with_device_count(self):
        sizes = {f"m{i}": 40 for i in range(8)}
        _, pool1 = placed_pool(sizes, budget=100, ndev=1)
        _, pool4 = placed_pool(sizes, budget=100, ndev=4)
        for i in range(8):
            pool1.engine_for(f"m{i}")
            pool4.engine_for(f"m{i}")
        assert len(pool1) == 2
        assert len(pool4) == 8

    def test_least_loaded_placement_spreads_and_is_deterministic(self):
        sizes = {f"m{i}": 40 for i in range(6)}
        placements = []
        for _ in range(2):
            _, pool = placed_pool(sizes, budget=100, ndev=3)
            for i in range(6):
                pool.engine_for(f"m{i}")
            placements.append([pool.placement_of(f"m{i}")[0] for i in range(6)])
        assert placements[0] == placements[1] == [0, 1, 2, 0, 1, 2]
        # the factory built each engine on its pool device
        assert all(pool._entries[f"m{i}"].engine.device == CPU for i in range(6))

    def test_eviction_is_per_device_lru(self):
        sizes = {"a": 80, "b": 80, "c": 80, "d": 80}
        _, pool = placed_pool(sizes, budget=100, ndev=3)
        for v in ("a", "b", "c"):
            pool.engine_for(v)
        pool.engine_for("d")
        assert pool.eviction_log == ["a"]
        assert pool.placement_of("d") == (0,)
        assert pool.resident_versions == ["b", "c", "d"]

    def test_pinned_devices_block_retryable(self):
        _, pool = placed_pool({"a": 80, "b": 80}, budget=100, ndev=1)
        pool.engine_for("a")
        pool.pin("a")
        with pytest.raises(PoolBudgetError) as ei:
            pool.engine_for("b")
        assert ei.value.retryable
        pool.unpin("a")
        pool.engine_for("b")
        assert pool.eviction_log == ["a"]

    def test_unknown_placement_policy_raises(self):
        with pytest.raises(ValueError, match="placement"):
            placed_pool({}, budget=100, placement="random")

    def test_placed_trace_equals_reference(self):
        """The same placed admissions give the same placements, evictions
        and stats on either side."""
        sizes = {f"m{i}": 25 + 9 * (i % 4) for i in range(9)}
        seq = [0, 3, 1, 4, 0, 5, 2, 8, 6, 1, 7, 3, 0]

        def drive(mod, devices, placement):
            _, pool = fake_pool(sizes, 100, mod=mod, devices=devices, placement=placement)
            out = []
            for i in seq:
                try:
                    pool.engine_for(f"m{i}")
                except mod.PoolBudgetError as e:
                    out.append(("refused", e.retryable))
                out.append(tuple(pool.placement_of(v)[0] for v in pool.resident_versions))
            return out, pool.eviction_log, dataclasses.asdict(pool.stats)

        for placement in ("least_loaded", "affinity"):
            got = drive(__import__("repro_torch.serving.scheduler", fromlist=["x"]),
                        [CPU] * 3, placement)
            want = drive(RS, ["d0", "d1", "d2"], placement)
            assert got == want


class TestAffinityPlacement:
    def test_readmission_returns_home(self):
        sizes = {"a": 80, "b": 80, "c": 80, "d": 80}
        _, pool = placed_pool(sizes, budget=100, ndev=2, placement="affinity")
        pool.engine_for("a")
        pool.engine_for("b")
        home_a = pool.placement_of("a")[0]
        pool.engine_for("c")
        assert "a" not in pool.resident_versions
        pool.engine_for("a")
        assert pool.placement_of("a") == (home_a,)

    def test_affinity_falls_back_when_home_pinned(self):
        sizes = {"a": 80, "b": 80, "c": 80}
        _, pool = placed_pool(sizes, budget=100, ndev=2, placement="affinity")
        pool.engine_for("a")
        pool.engine_for("c")
        pool.pin("a")
        pool.engine_for("b")
        assert pool.placement_of("b") == (1,)
        assert "c" not in pool.resident_versions
        pool.engine_for("c")
        assert pool.placement_of("c") == (1,)


class TestShardedAdmission:
    def test_oversize_without_mesh_is_unretryable(self):
        _, pool = placed_pool({"big": 250}, budget=100, ndev=3)
        with pytest.raises(PoolBudgetError, match="no mesh") as ei:
            pool.engine_for("big")
        assert not ei.value.retryable
        assert pool.stats.sharded_admissions == 0

    @pytest.mark.parametrize("where", ["pool", "pooled_session", "session", "engine"])
    def test_mesh_raises_naming_item_11(self, where, tiny):
        """Every entry point takes ``mesh=`` (ported from ROADMAP queue 1
        item 11) and keeps the reference's refusals: a pool given both
        ``devices=`` and ``mesh=``, a session's ``mesh=`` without
        ``pool_budget=``, an engine given ``device=`` and ``mesh=``."""
        from repro_torch.launch.mesh import make_mesh
        _, _, cfg, params = tiny
        mesh = make_mesh((1, 3), ("data", "model"), device="cpu")
        if where == "pool":
            pool = ModelPool(FakeSession(), 100, mesh=mesh)
            assert pool.mesh is mesh and pool.devices == list(mesh.devices.flat)
            with pytest.raises(ValueError, match="not both"):
                ModelPool(FakeSession(), 100, mesh=mesh, devices=[CPU])
        elif where == "pooled_session":
            sess = IOLMSession(params, cfg, device="cpu", pool_budget=1 << 30, mesh=mesh)
            assert sess.pool.mesh is mesh
        elif where == "session":
            with pytest.raises(ValueError, match="pool_budget="):
                IOLMSession(params, cfg, device="cpu", mesh=mesh)
        else:
            with pytest.raises(ValueError, match="not both"):
                Engine(params, cfg, device="cpu", mesh=mesh)
            assert Engine(params, cfg, mesh=mesh).mesh is mesh


class TestSchedulerFanOut:
    def test_fake_engines_without_split_still_work(self):
        _, pool = placed_pool({"a": 40, "b": 40}, budget=100, ndev=2)
        sched = Scheduler(pool, share=2)
        sa = sched.submit("ta", ["x", "yy"], qsig="a")
        sb = sched.submit("tb", ["zzz"], qsig="b")
        sched.run()
        assert sa.results() == ["out(x)", "out(yy)"]
        assert sb.results() == ["out(zzz)"]
        assert sched.stats.peak_concurrent_devices == 1


# ---------------------------------------------------------------------------
# the tiny model, end to end
# ---------------------------------------------------------------------------

ENGINE_KW = dict(slots=2, max_len=64, buckets=(16, 48))
LANGS = ["pyton", "javascrpt", "golang", "rst"]
REVIEWS = ["good mouse here", "bad lamp sadly", "fine chair ok"]
VALS = ["pyton", "javascrpt", "golang", "rst", "kotln", "swft"]


@pytest.fixture(scope="module")
def tiny():
    rcfg = RConfig(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, d_ff=128, vocab_size=260, max_seq=256,
                   param_dtype="float32")
    rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, rparams, from_reference(rcfg), bridge.from_reference(rparams, device="cpu")


def port_session(tiny, **kw):
    _, _, cfg, params = tiny
    kw.setdefault("recipes", [Recipe(**W8)])
    kw.setdefault("calib_rows", 4)
    kw.setdefault("eval_rows", 2)
    kw.setdefault("engine_kw", dict(ENGINE_KW))
    return IOLMSession(params, cfg, device="cpu", **kw)


def ref_session(tiny, **kw):
    rcfg, rparams, _, _ = tiny
    kw.setdefault("recipes", [RRecipe(**W8)])
    kw.setdefault("calib_rows", 4)
    kw.setdefault("eval_rows", 2)
    kw.setdefault("engine_kw", dict(ENGINE_KW))
    return RQ.IOLMSession(rparams, rcfg, **kw)


def two_queries(mod, table_cls, sess):
    q1 = mod.Query(table_cls({"lang": list(LANGS)}), sess).llm_correct("lang", max_new=6)
    q2 = mod.Query(table_cls({"review": list(REVIEWS)}), sess) \
        .llm_map("review", out_col="s", max_new=6)
    return q1, q2


class TestSchedulerIntegration:
    def test_concurrent_queries_match_serial_and_reference(self, tiny):
        pooled = port_session(tiny, pool_budget=64 * 1024 * 1024)
        q1, q2 = two_queries(__import__("repro_torch.olap.query", fromlist=["x"]),
                             Table, pooled)
        assert "placement: pool," in q1.explain()
        assert all(" placement=pool " in ln for ln in q1.explain().splitlines()
                   if " llm " in ln)
        res = Scheduler(pooled.pool, share=2).run_queries({"a": q1, "b": q2})
        serial = port_session(tiny)
        s1, s2 = two_queries(__import__("repro_torch.olap.query", fromlist=["x"]),
                             Table, serial)
        r1, r2 = s1.run(), s2.run()
        rpooled = ref_session(tiny, pool_budget=64 * 1024 * 1024)
        rq1, rq2 = two_queries(RQ, RTable, rpooled)
        want = RS.Scheduler(rpooled.pool, share=2).run_queries({"a": rq1, "b": rq2})
        assert res["a"].columns == r1.columns == want["a"].columns
        assert res["b"].columns == r2.columns == want["b"].columns
        assert pooled.pool.stats.peak_resident_models >= 2
        assert dataclasses.asdict(pooled.pool.stats) == dataclasses.asdict(rpooled.pool.stats)
        assert pooled.pool.resident_versions == rpooled.pool.resident_versions

    def test_cross_tenant_dedup_decodes_once(self, tiny):
        sess = port_session(tiny, pool_budget=64 * 1024 * 1024)
        sched = Scheduler(sess.pool, share=4)
        prompts = [f"fix: val{i}" for i in range(4)]
        s1 = sched.submit("t1", list(prompts), qsig="q", optimize=False, max_new=4)
        s2 = sched.submit("t2", list(prompts), qsig="q", optimize=False, max_new=4)
        sched.run()
        assert s1.results() == s2.results()
        eng = s1.engine
        assert eng is s2.engine
        assert eng.stats.cache_hits >= len(prompts)
        assert eng.stats.rows == 2 * len(prompts)
        assert eng.device == CPU and eng.backend == "reference"

    def test_serial_pooled_query_reuses_resident_engine(self, tiny):
        sess = port_session(tiny, pool_budget=64 * 1024 * 1024)
        t = Table({"lang": ["pyton", "javascrpt"]})
        Query(t, sess).llm_correct("lang", max_new=4).run()
        misses = sess.pool.stats.misses
        Query(t, sess).llm_correct("lang", max_new=4).run()
        assert sess.pool.stats.misses == misses
        assert sess.pool.stats.hits >= 1
        assert sess.model_cache.hits >= 1

    def test_pool_charges_params_and_slot_state(self, tiny):
        _, _, cfg, params = tiny
        sess = port_session(tiny, pool_budget=64 * 1024 * 1024)
        eng = sess.base_engine()
        want = param_bytes(params) + ENGINE_KW["slots"] * slot_state_bytes(
            cfg, ENGINE_KW["max_len"])
        assert sess.pool.resident_bytes == want
        # the base engine serves the session's own tensors: no copy
        assert eng.params["embed"].data_ptr() == params["embed"].data_ptr()

    def test_fanout_over_four_cpu_placements_equals_serial(self, tiny):
        _, _, cfg, params = tiny

        class SameParams:
            tok = None

            def _optimize(self, qsig, probe):
                return SimpleNamespace(params=params, cfg=cfg, version=qsig)

        kw = dict(ENGINE_KW, device="cpu")
        entry = param_bytes(params) + kw["slots"] * slot_state_bytes(cfg, kw["max_len"])
        pool = ModelPool(SameParams(), int(1.5 * entry), engine_kw=kw, devices=[CPU] * 4)
        sched = Scheduler(pool, share=2)
        prompts = {f"t{i}": [f"tenant {i} row {j}" for j in range(3)] for i in range(4)}
        subs = [sched.submit(t, ps, qsig=t, max_new=8) for t, ps in prompts.items()]
        sched.run()
        assert len(pool) == 4
        assert sorted(pool.placement_of(f"t{i}")[0] for i in range(4)) == [0, 1, 2, 3]
        # four placements, one physical device: the fan-out counts devices
        assert sched.stats.peak_concurrent_devices == 1
        for sub in subs:
            ref = Engine(params, cfg, version=sub.qsig, **kw).generate(
                prompts[sub.tenant], max_new=8)
            assert sub.results() == ref

    def test_evicted_engine_is_released(self, tiny):
        """The shared prefix cache holds its engines' evict listeners
        weakly, so an engine the pool evicts (and its KV pool) goes."""
        import gc
        import weakref
        _, _, cfg, params = tiny
        shared = PrefixCache(capacity=8)
        eng = Engine(params, cfg, version="v", prefix_cache=shared, device="cpu", **ENGINE_KW)
        eng.generate(["fix: a", "fix: b"], max_new=3, prefix="fix: ")
        ref = weakref.ref(eng)
        del eng
        gc.collect()
        assert ref() is None
        shared.capacity = 0
        shared.put(("x",), None, 0)        # eviction skips the dead listener
        assert shared._evict_listeners == []

    def test_slot_state_bytes_positive_and_scales(self, tiny):
        _, _, cfg, _ = tiny
        assert 0 < slot_state_bytes(cfg, 64) < slot_state_bytes(cfg, 128)


@pytest.mark.parametrize("which", ["tiny", "gemma2-2b"])
@pytest.mark.parametrize("max_len", [64, 1024])
def test_slot_state_bytes_equals_reference(tiny, which, max_len):
    if which == "tiny":
        rcfg, _, cfg, _ = tiny
    else:
        rcfg, cfg = rgemma.CONFIG, gemma2_2b.CONFIG
    assert slot_state_bytes(cfg, max_len) == RS.slot_state_bytes(rcfg, max_len)
    if which == "gemma2-2b" and max_len == 1024:
        # 26 layers x (k, v) x 4 KV heads x head_dim 256 x 1024 positions, bf16
        assert slot_state_bytes(cfg, max_len) == 26 * 2 * 4 * 256 * 1024 * 2


TEMPLATE = "fix the category value please: "


class TestSharedPrefixCacheIsolation:
    def test_no_prefilled_state_leaks_across_model_versions(self, tiny):
        _, _, cfg, params = tiny
        p8, c8, _ = InstanceOptimizer(params, cfg).apply(Recipe(**W8))
        kw = dict(slots=2, max_len=96, buckets=(16, 64), device="cpu")
        prompts = [f"{TEMPLATE}val{i}" for i in range(5)]
        shared = PrefixCache(capacity=8)
        e_base = Engine(params, cfg, version="base", prefix_cache=shared, **kw)
        e_int8 = Engine(p8, c8, version="q:w8", prefix_cache=shared, **kw)
        out_base = e_base.generate_stream(iter(prompts), max_new=6, prefix=TEMPLATE)
        out_int8 = e_int8.generate_stream(iter(prompts), max_new=6, prefix=TEMPLATE)
        assert e_base.stats.prefix_hits > 0 and e_int8.stats.prefix_hits > 0
        assert len(shared) == 2
        r_base = Engine(params, cfg, version="base", **kw) \
            .generate_stream(iter(prompts), max_new=6, prefix=TEMPLATE)
        r_int8 = Engine(p8, c8, version="q:w8", **kw) \
            .generate_stream(iter(prompts), max_new=6, prefix=TEMPLATE)
        assert out_base == r_base and out_int8 == r_int8
        # one token prefix, split by version (and placement)
        assert sorted(v for _, v in shared._d) == ["base@cpu", "q:w8@cpu"]
        assert len({ids for ids, _ in shared._d}) == 1


# ---------------------------------------------------------------------------
# the cascade's two-phase form
# ---------------------------------------------------------------------------

def cascade_query(sess, **kw):
    kw.setdefault("cascade_budget", 0.5)
    kw.setdefault("cascade", "force")
    return Query(Table({"lang": list(VALS)}), sess, **kw).llm_correct("lang", max_new=6)


def base_only_outputs(tiny):
    q = Query(Table({"lang": list(VALS)}), port_session(tiny, engine_kw=dict(
        slots=2, max_len=64, buckets=(32,))), optimize=False).llm_correct("lang", max_new=6)
    return q.run()["lang_fixed"]


CASCADE_KW = dict(engine_kw=dict(slots=2, max_len=64, buckets=(32,)))


class TestSchedulerCascade:
    def test_run_queries_matches_serial_cascade(self, tiny):
        pooled = port_session(tiny, pool_budget=64 * 1024 * 1024, **CASCADE_KW)
        q = cascade_query(pooled)
        sched = Scheduler(pooled.pool, share=2)
        res = sched.run_queries({"a": q})
        serial = cascade_query(port_session(tiny, **CASCADE_KW))
        want = serial.run()["lang_fixed"]
        assert res["a"]["lang_fixed"] == want
        (st,) = serial.last_run_stats
        # the escalation submission carries exactly the serial run's rejects
        esc = [s for s in sched.finished if not s.optimize]
        assert sum(len(s.reqs) for s in esc) == st.escalated
        # proxy and base share the one pool
        assert "base" in pooled.pool.resident_versions
        assert pooled.pool.stats.peak_resident_models >= 2

    def test_run_queries_unfit_threshold_is_base_only(self, tiny, monkeypatch):
        base = base_only_outputs(tiny)
        pooled = port_session(tiny, pool_budget=64 * 1024 * 1024, **CASCADE_KW)
        cal = CascadeCalibration(threshold=float("inf"), expected_escalation=1.0,
                                 accuracy_budget=0.5, n_fit=0)
        monkeypatch.setattr(pooled, "_cascade", lambda qsig, prompts, budget, **kw: cal)
        sched = Scheduler(pooled.pool, share=2)
        res = sched.run_queries({"a": cascade_query(pooled)})
        assert res["a"]["lang_fixed"] == base
        assert [s.optimize for s in sched.finished] == [False]

    def test_run_queries_budget_zero_is_base_only(self, tiny):
        base = base_only_outputs(tiny)
        pooled = port_session(tiny, pool_budget=64 * 1024 * 1024, **CASCADE_KW)
        sched = Scheduler(pooled.pool, share=2)
        res = sched.run_queries({"a": cascade_query(pooled, cascade_budget=0.0)})
        assert res["a"]["lang_fixed"] == base
        assert math.isinf(next(iter(pooled.cascade_cache.values())).threshold)
        assert pooled.pool.resident_versions == ["base"]


# ---------------------------------------------------------------------------
# properties (hypothesis)
# ---------------------------------------------------------------------------

@given(sizes=st.lists(st.integers(1, 50), min_size=1, max_size=8),
       budget=st.integers(20, 120),
       accesses=st.lists(st.integers(0, 7), min_size=1, max_size=30))
@settings(**SETTINGS)
def test_pool_budget_never_exceeded(sizes, budget, accesses):
    table = {f"q{i}": sz for i, sz in enumerate(sizes)}
    _, pool = fake_pool(table, budget=budget)
    for a in accesses:
        q = f"q{a % len(sizes)}"
        try:
            pool.engine_for(q)
        except PoolBudgetError as e:
            assert not e.retryable and table[q] > budget
        assert pool.resident_bytes <= pool.byte_budget


@given(sizes=st.lists(st.integers(1, 50), min_size=1, max_size=6),
       budget=st.integers(50, 120),
       accesses=st.lists(st.integers(0, 5), min_size=1, max_size=25))
@settings(**SETTINGS)
def test_pool_eviction_order_deterministic_and_equal_to_reference(sizes, budget, accesses):
    table = {f"q{i}": sz for i, sz in enumerate(sizes)}
    logs = []
    for mod in (None, None, RS):
        _, pool = fake_pool(table, budget=budget, mod=mod)
        for a in accesses:
            try:
                pool.engine_for(f"q{a % len(sizes)}")
            except (PoolBudgetError, RS.PoolBudgetError):
                pass
        logs.append(list(pool.eviction_log))
    assert logs[0] == logs[1] == logs[2]


@given(n_tenants=st.integers(2, 4), rows=st.integers(2, 6),
       share=st.integers(1, 3), seed=st.integers(0, 100))
@settings(**SETTINGS)
def test_scheduler_no_tenant_starvation(n_tenants, rows, share, seed):
    rng = np.random.default_rng(seed)
    per_tenant = {f"t{i}": [f"{'x' * 3}{j}" for j in range(rows)]
                  for i in range(n_tenants)}
    sizes = {f"t{i}": 1 for i in range(n_tenants)}
    _, pool = fake_pool(sizes, budget=10 * n_tenants, slots=4)
    sched = Scheduler(pool, share=share)
    subs = [sched.submit(t, prompts, qsig=t) for t, prompts in per_tenant.items()]
    rng.shuffle(subs)
    sched.run()
    firsts = [s.first_done_tick for s in subs]
    for s in subs:
        assert s.done and len(s.results()) == rows
        assert s.peak_inflight == min(share, rows)
    assert max(firsts) - min(firsts) <= 1


_SERIAL = {}


def _tiny_serving():
    """Module-level 1-layer model and two persistent engines."""
    if not _SERIAL:
        from repro_torch.configs.base import ModelConfig
        from repro_torch.models import api
        cfg = ModelConfig(name="p", family="dense", n_layers=1, d_model=32, n_heads=2,
                          n_kv_heads=1, d_ff=64, vocab_size=260, max_seq=128,
                          param_dtype="float32")
        gen = torch.Generator().manual_seed(0)
        params = api.init_params(gen, cfg)
        kw = dict(slots=2, max_len=48, buckets=(16,), device="cpu")
        _SERIAL["shared"] = Engine(params, cfg, version="base", **kw)
        _SERIAL["serial"] = Engine(params, cfg, version="base", **kw)
    return _SERIAL


@given(p1=st.lists(st.text(alphabet="ab ", max_size=6), min_size=1, max_size=4),
       p2=st.lists(st.text(alphabet="ab ", max_size=6), min_size=1, max_size=4))
@settings(max_examples=8, deadline=None)
def test_scheduler_byte_identical_to_serial(p1, p2):
    env = _tiny_serving()
    pool = ModelPool(FakeSession(), byte_budget=1, entry_bytes=lambda m: 1)
    pool._entries["base"] = PoolEntry(engine=env["shared"], nbytes=1)
    sched = Scheduler(pool, share=2)
    s1 = sched.submit("t1", list(p1), qsig="base", optimize=False, max_new=4)
    s2 = sched.submit("t2", list(p2), qsig="base", optimize=False, max_new=4)
    sched.run()
    assert s1.results() == env["serial"].generate(list(p1), max_new=4)
    assert s2.results() == env["serial"].generate(list(p2), max_new=4)


@pytest.mark.parametrize("devices", [(), (0,), (0, 1), (0, 1, 2, 3)])
def test_pool_entry_sharded_equals_reference(devices):
    assert PoolEntry(engine=None, nbytes=1, devices=devices).sharded == \
        RS.PoolEntry(engine=None, nbytes=1, devices=devices).sharded == (len(devices) > 1)
