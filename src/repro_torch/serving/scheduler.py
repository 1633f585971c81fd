"""Multi-tenant serving: byte-budgeted model residency + fair scheduling.

The paper's headline systems claim is that instance-optimization
"enables higher parallelism on existing hardware": a compressed
per-query model is small enough that *many* specialized instances
co-reside in the memory where one base model fit, so concurrent OLAP
queries from different tenants run simultaneously instead of queueing
behind a single engine.  This module supplies the two pieces that turn
the single-model async engine (engine.py) into that fleet:

``ModelPool``
    Byte-budgeted residency of per-query compressed models.  An entry
    is one resident ``Engine`` (model params + its decode-slot state);
    ``engine_for(qsig, probe)`` returns the resident engine for the
    query's optimized model, re-running the instance-optimization
    workflow through the owning ``IOLMSession`` on a miss (the
    session's ``ModelCache`` makes an evicted-but-remembered model
    cheap to re-admit: only the engine is rebuilt, not the compression
    search).  Residency is LRU with pin counts — engines with live
    scheduler work are never evicted — and the byte budget is a hard
    invariant: an admission evicts least-recently-used unpinned
    entries first and fails rather than overshoot.  All resident
    engines share one ``PrefixCache`` keyed by (template tokens, model
    version), so tenants on different compressed models can never
    collide on prefilled state while tenants on the *same* model share
    it.

``Scheduler``
    Fair-share round-robin interleaving of ``Engine.step()`` across
    the pool's resident engines.  A ``Submission`` is one tenant's
    prompt stream bound for one model; every scheduler tick tops each
    active submission up to ``share`` in-flight rows (round-robin, so
    no tenant starves at admission) and then runs one decode tick on
    every engine that has work.  Tenants whose prompts and model
    version coincide dedup through the shared engine's result cache
    and leader/follower path — identical work is decoded once across
    the whole fleet.  Greedy outputs equal running each submission
    alone on a private engine: per-slot decode state is independent,
    so interleaving changes only the schedule, never the tokens.

``Scheduler.run_queries`` drives whole OLAP query *plans* (not just
prompt streams) concurrently: each ``Query`` exposes its plan as a
coroutine of operator submissions, and the scheduler interleaves the
operators of all tenants' queries while respecting each plan's own
sequential dependencies (``QueryDriver``, including the cascade's
two-phase form: a proxy submission, then the escalated rows on the
base engine).

The pool charges an entry ``param_bytes(model) + slots *
slot_state_bytes(cfg, max_len)``, as the reference does.  That is a
count of what the entry needs, not of what the card holds: the owning
session's model cache keeps every built instance's params on the
device whether or not its engine is resident, and an engine over
params already on its device copies nothing, so evicting an engine
frees its KV pool only.

Device-aware pools: ``devices=`` (a list of ``torch.device``s) makes
the byte budget **per device**, and each admitted engine is built on
one device (``Engine(device=...)``) under a least-loaded or affinity
placement policy.  The scheduler's tick *fans out*: it dispatches
``Engine.step_begin()`` on every engine with work before collecting
any ``step_finish()``, so engines on distinct devices overlap their
decode steps while outputs stay identical to the serial executor
(dispatch order is deterministic and per-engine sequencing is
unchanged).  Engines sharing one card still step one after another on
the host thread.  ``mesh=`` (a ``launch/mesh.py`` ``Mesh``) makes the
mesh's positions the pool's devices, and a model larger than one
position's budget whose ``ceil(need / positions)`` fits is admitted as
ONE tensor-parallel engine over the whole mesh (``Engine(mesh=)``),
charged that share on every position, as in the reference.  Positions
are logical: on one card every position of a ``(1, 4)`` mesh is
``cuda:0``, and the budget is still charged per position.
``devices=None, mesh=None`` is the single-device pool.
"""
from __future__ import annotations

import math
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Set, Tuple)

from repro_torch.core.compressed import param_bytes
from repro_torch.kernels.build import KernelError
from repro_torch.models import api
from repro_torch.serving.batcher import Request
from repro_torch.serving.cache import PrefixCache
from repro_torch.serving.engine import Engine
from repro_torch.serving.metrics import TenantStats

def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def slot_state_bytes(cfg, max_len: int) -> int:
    """Per-decode-slot state bytes (KV cache / recurrent state, batch=1),
    computed from shapes only: the contiguous cache is built on the
    ``meta`` device, which allocates nothing.  A hybrid's slot counts
    every Mamba layer's SSD and conv state beside its sites' KV (zamba2-7b
    at max_len 1024: 131.5 MB of state, 161.5 MB of KV), and an rwkv
    slot its O(1) state alone, the same at any ``max_len`` (rwkv6-3b:
    21,626,880 B, its f32 WKV states and token-shift carries), as the
    reference's does."""
    cache = api.init_cache(cfg, 1, max_len, compact_local=False,
                           device="meta")
    return sum(t.numel() * t.element_size() for t in _leaves(cache))


class PoolBudgetError(RuntimeError):
    """Raised when an admission cannot fit inside the byte budget.

    ``retryable`` distinguishes "blocked by pinned residents, wait for
    a pin to release" (the scheduler queues the submission) from "the
    model alone exceeds the budget, it can never fit" (always raised
    through to the caller).
    """

    def __init__(self, msg: str, *, retryable: bool):
        super().__init__(msg)
        self.retryable = retryable


@dataclass
class _BaseModel:
    """Duck-typed OptimizedModel for the un-optimized (base) path."""
    params: Any
    cfg: Any
    version: str = "base"


@dataclass
class PoolEntry:
    engine: Engine
    nbytes: int
    hits: int = 0
    # device-aware pools: indices into pool.devices this entry occupies
    # (one for a placed replica, all of them for a sharded TP entry)
    # and the bytes charged against EACH of those devices' budgets.
    devices: Tuple[int, ...] = ()
    dev_bytes: int = 0
    # a sharded entry: the bytes each position holds (params and slot
    # state, ``Engine.position_bytes``) beside the ``dev_bytes`` charged
    # to each
    held: Tuple[int, ...] = ()

    @property
    def sharded(self) -> bool:
        return len(self.devices) > 1


@dataclass
class PoolStats:
    hits: int = 0            # engine_for served by a resident engine
    misses: int = 0          # engine (re)built — optimize and/or admit
    evictions: int = 0
    peak_resident_models: int = 0
    peak_resident_bytes: int = 0
    sharded_admissions: int = 0   # models admitted tensor-parallel


class ModelPool:
    """Byte-budgeted LRU residency of per-query (compressed) engines.

    ``session`` is duck-typed: the pool needs ``session._optimize(qsig,
    probe) -> model`` (with ``.params/.cfg/.version``), ``session.params``
    / ``session.cfg`` for the base path, and ``session.tok``.
    ``engine_factory`` / ``entry_bytes`` are injection points for tests
    and alternate backends; the defaults build a real ``Engine`` with
    ``engine_kw`` (which carries the session's ``device`` and
    ``backend``) and charge it ``param_bytes(model) + slots *
    slot_state_bytes(cfg)``.

    Device-aware mode — pass ``devices=`` (a list of ``torch.device``s):

    * ``byte_budget`` becomes **per-device**; total fleet capacity is
      ``byte_budget * len(devices)``.
    * Each admitted engine is built on one device (``Engine(device=)``
      moves its params there); ``placement`` picks it:
      ``"least_loaded"`` (fewest resident bytes, lowest index on ties —
      deterministic) or ``"affinity"`` (re-admit an evicted version to
      its previous home while it fits, so same-placement prefix-cache
      entries and warm state stay reusable; falls back to
      least-loaded).
    * The budget stays a hard per-device invariant: admission evicts
      LRU unpinned entries *on the chosen device* and refuses rather
      than overshoot.  A model larger than one device's budget is
      refused for good, unless the pool has a mesh.

    ``mesh=`` (a ``Mesh``; exclusive with ``devices=``): its positions
    are the devices, and a model over the per-device budget whose
    ``ceil(need / positions)`` fits is admitted as one sharded engine
    over every position (``stats.sharded_admissions``); evicting it frees
    every position.  The charge stays ``ceil(need / positions)`` a
    position; :meth:`held_bytes` is what the sharded engines hold there
    (``Engine.position_bytes``: their params' pieces, a replicated param
    counted whole as the reference counts it, and their slot state as
    placed, its unsharded leaves at position 0 alone).

    ``devices=None`` (the default) is the single-device pool:
    ``byte_budget`` is the total budget and engines are built on
    ``engine_kw``'s device.
    """

    def __init__(self, session, byte_budget: int, *,
                 engine_kw: Optional[Dict] = None,
                 prefix_capacity: int = 32,
                 engine_factory: Optional[Callable] = None,
                 entry_bytes: Optional[Callable] = None,
                 devices: Optional[List] = None,
                 mesh=None,
                 placement: str = "least_loaded"):
        self.session = session
        self.byte_budget = int(byte_budget)
        self.engine_kw = dict(engine_kw or {})
        self.prefix_cache = PrefixCache(capacity=prefix_capacity)
        self._engine_factory = engine_factory or self._default_factory
        self._entry_bytes = entry_bytes or self._default_bytes
        self._entries: "OrderedDict[str, PoolEntry]" = OrderedDict()
        self._pins: Dict[str, int] = {}
        self.stats = PoolStats()
        self.eviction_log: List[str] = []
        if placement not in ("least_loaded", "affinity"):
            raise ValueError(f"unknown placement policy {placement!r}")
        self.placement = placement
        self.mesh = mesh
        if mesh is not None:
            if devices is not None:
                raise ValueError("pass devices= or mesh=, not both")
            self.devices = list(mesh.devices.flat)
        else:
            self.devices = list(devices) if devices is not None else None
        self._homes: Dict[str, int] = {}   # version -> last device index

    @property
    def device_aware(self) -> bool:
        return self.devices is not None

    # -- defaults -------------------------------------------------------
    def _default_factory(self, model, *, device=None, mesh=None) -> Engine:
        kw = dict(self.engine_kw)
        if device is not None:          # a placed engine: its device wins
            kw["device"] = device
        if mesh is not None:            # a sharded engine: no single device
            kw.pop("device", None)
            kw["mesh"] = mesh
        return Engine(model.params, model.cfg, tokenizer=self.session.tok,
                      version=model.version, prefix_cache=self.prefix_cache,
                      **kw)

    def _default_bytes(self, model) -> int:
        slots = self.engine_kw.get("slots", 8)
        max_len = self.engine_kw.get("max_len", 256)
        return (param_bytes(model.params)
                + slots * slot_state_bytes(model.cfg, max_len))

    # -- residency ------------------------------------------------------
    @property
    def resident_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    @property
    def resident_versions(self) -> List[str]:
        return list(self._entries)

    def device_bytes(self, i: int) -> int:
        """Bytes charged against device ``i``'s budget (device-aware)."""
        return sum(e.dev_bytes for e in self._entries.values()
                   if i in e.devices)

    def held_bytes(self, i: int) -> int:
        """Bytes the sharded entries' engines hold at position ``i``
        (``Engine.position_bytes``; each is charged ``ceil(need /
        positions)`` there instead)."""
        return sum(e.held[i] for e in self._entries.values() if e.held)

    def _pinned_device_bytes(self, i: int) -> int:
        return sum(e.dev_bytes for v, e in self._entries.items()
                   if i in e.devices and self.pinned(v))

    def placement_of(self, version: str) -> Tuple[int, ...]:
        """Device indices a resident version occupies (``()`` when not
        resident or the pool is not device-aware)."""
        e = self._entries.get(version)
        return e.devices if e is not None else ()

    def __len__(self) -> int:
        return len(self._entries)

    def pin(self, version: str) -> None:
        self._pins[version] = self._pins.get(version, 0) + 1

    def unpin(self, version: str) -> None:
        n = self._pins.get(version, 0) - 1
        if n <= 0:
            self._pins.pop(version, None)
        else:
            self._pins[version] = n

    def pinned(self, version: str) -> bool:
        return self._pins.get(version, 0) > 0

    def discard(self, version: str, *, engine=None) -> bool:
        """Forcibly drop a resident entry (fault quarantine).  Unlike
        LRU eviction this removes the entry even when pinned — the pins
        belong to the submissions being quarantined off the faulty
        engine, and the scheduler clears them by discarding here — so
        the replacement admission has room.  ``engine`` (when given)
        guards against discarding an innocent rebuild that re-used the
        same version string after the fault."""
        e = self._entries.get(version)
        if e is None or (engine is not None and e.engine is not engine):
            return False
        del self._entries[version]
        self._pins.pop(version, None)
        self.stats.evictions += 1
        self.eviction_log.append(version)
        return True

    def resolve(self, qsig: str, probe: Iterable[str] = (), *,
                optimize: bool = True):
        """The query's model (optimizing on first sight), WITHOUT
        admitting an engine — callers that may need to retry admission
        (budget pinned full) resolve once and re-``admit`` the memoized
        model instead of re-running the optimization lookup per try."""
        return (self.session._optimize(qsig, list(probe)) if optimize
                else _BaseModel(self.session.params, self.session.cfg))

    def admit(self, model) -> Engine:
        """Resident engine for ``model``, building one on miss.  Raises
        PoolBudgetError instead of exceeding the budget; a *retryable*
        refusal (pinned residents block the room) evicts nothing — warm
        engines are only sacrificed for admissions that will succeed."""
        entry = self._entries.get(model.version)
        if entry is not None:
            self._entries.move_to_end(model.version)
            entry.hits += 1
            self.stats.hits += 1
            return entry.engine
        need = int(self._entry_bytes(model))
        if self.device_aware:
            entry = self._admit_placed(model, need)
        else:
            entry = self._admit_legacy(model, need)
        self._entries[model.version] = entry
        self.stats.misses += 1
        self.stats.peak_resident_models = max(self.stats.peak_resident_models,
                                              len(self._entries))
        self.stats.peak_resident_bytes = max(self.stats.peak_resident_bytes,
                                             self.resident_bytes)
        return entry.engine

    def _admit_legacy(self, model, need: int) -> PoolEntry:
        """Single-implicit-device admission (the historical behavior)."""
        if need > self.byte_budget:
            raise PoolBudgetError(
                f"model {model.version!r} needs {need} bytes but the pool "
                f"budget is {self.byte_budget}", retryable=False)
        pinned_bytes = sum(e.nbytes for v, e in self._entries.items()
                           if self.pinned(v))
        if pinned_bytes + need > self.byte_budget:
            raise PoolBudgetError(
                f"cannot admit {model.version!r} ({need} bytes): "
                f"{pinned_bytes} bytes pinned by live submissions",
                retryable=True)
        self._evict_until(self.byte_budget - need)
        return PoolEntry(engine=self._engine_factory(model), nbytes=need)

    # -- device-aware admission ----------------------------------------
    def _pick_device(self, version: str, need: int) -> Optional[int]:
        """Placement policy: the device this admission should land on,
        or None when every device is blocked by pins (retryable).
        Deterministic: least-loaded by resident bytes with lowest index
        winning ties; ``affinity`` first tries the version's previous
        home so re-admissions reuse same-placement state."""
        cand = [i for i in range(len(self.devices))
                if self._pinned_device_bytes(i) + need <= self.byte_budget]
        if not cand:
            return None
        if self.placement == "affinity":
            home = self._homes.get(version)
            if home in cand:
                return home
        return min(cand, key=lambda i: (self.device_bytes(i), i))

    def _admit_placed(self, model, need: int) -> PoolEntry:
        """Per-device-budget admission: place on one device, or shard
        over the whole mesh when the model cannot fit any single one."""
        ndev = len(self.devices)
        if need <= self.byte_budget:
            dev = self._pick_device(model.version, need)
            if dev is None:
                raise PoolBudgetError(
                    f"cannot admit {model.version!r} ({need} bytes): every "
                    f"device's budget is pinned by live submissions",
                    retryable=True)
            self._evict_device_until(dev, self.byte_budget - need)
            engine = self._engine_factory(model, device=self.devices[dev])
            self._homes[model.version] = dev
            return PoolEntry(engine=engine, nbytes=need,
                             devices=(dev,), dev_bytes=need)
        per = -(-need // ndev)          # ceil: bytes charged per device
        if self.mesh is not None and per <= self.byte_budget:
            if any(self._pinned_device_bytes(i) + per > self.byte_budget
                   for i in range(ndev)):
                raise PoolBudgetError(
                    f"cannot admit sharded {model.version!r} ({per} "
                    f"bytes/device): pinned residents block the room",
                    retryable=True)
            for i in range(ndev):
                self._evict_device_until(i, self.byte_budget - per)
            engine = self._engine_factory(model, mesh=self.mesh)
            self.stats.sharded_admissions += 1
            held = (tuple(engine.position_bytes(i) for i in range(ndev))
                    if hasattr(engine, "position_bytes") else ())
            return PoolEntry(engine=engine, nbytes=need,
                             devices=tuple(range(ndev)), dev_bytes=per, held=held)
        raise PoolBudgetError(
            f"model {model.version!r} needs {need} bytes but the "
            f"per-device budget is {self.byte_budget}"
            + ("" if self.mesh is not None
               else " (no mesh: sharded admission unavailable)"),
            retryable=False)

    def engine_for(self, qsig: str, probe: Iterable[str] = (), *,
                   optimize: bool = True) -> Engine:
        """``resolve`` + ``admit`` in one call (the no-retry path)."""
        return self.admit(self.resolve(qsig, probe, optimize=optimize))

    def _evict_lru(self, over_budget: Callable[[], bool],
                   occupies: Callable[[PoolEntry], bool]) -> None:
        """The one eviction loop both pools share: pop the least-
        recently-used unpinned entry satisfying ``occupies`` until
        ``over_budget()`` clears (or only pinned residents remain);
        deterministic (global LRU order)."""
        while over_budget():
            victim = next((v for v, e in self._entries.items()
                           if occupies(e) and not self.pinned(v)), None)
            if victim is None:
                return
            del self._entries[victim]
            self.stats.evictions += 1
            self.eviction_log.append(victim)

    def _evict_until(self, budget: int) -> None:
        """Legacy pool: evict until total resident bytes fit."""
        self._evict_lru(lambda: self.resident_bytes > budget,
                        lambda e: True)

    def _evict_device_until(self, dev: int, budget: int) -> None:
        """Device-aware pool: evict entries occupying device ``dev``
        until its charged bytes fit (a sharded entry is evictable from
        any of its devices and frees its charge on all of them)."""
        self._evict_lru(lambda: self.device_bytes(dev) > budget,
                        lambda e: dev in e.devices)


# ---------------------------------------------------------------------------
# fair-share scheduling
# ---------------------------------------------------------------------------

_EXHAUSTED = object()
_WHOLE_STEP = object()      # engine lacks the step_begin/step_finish split


@dataclass
class Submission:
    """One tenant's prompt stream bound for one model."""
    tenant: str
    prompts: Iterator[str]
    qsig: str
    probe: List[str]
    max_new: int
    prefix: Optional[str]
    optimize: bool
    engine: Optional[Engine] = None
    model: Any = None            # resolved once; re-admitted on retries
    error: Optional[BaseException] = None   # terminal admission failure
    reqs: List = field(default_factory=list)
    inflight: Set[int] = field(default_factory=set)
    exhausted: bool = False
    peak_inflight: int = 0
    first_done_tick: Optional[int] = None
    last_done_tick: Optional[int] = None
    # per-submission in-flight cap (a tenant SLO): effective share is
    # min(scheduler share, this) when set
    share: Optional[int] = None
    # fault quarantine: how many engines this submission has been
    # evacuated from (bounded by Scheduler.max_retries)
    retries: int = 0
    # latency instrumentation (metrics.py reservoirs)
    submit_t: float = 0.0
    activated_t: Optional[float] = None

    @property
    def active(self) -> bool:
        return self.engine is not None

    @property
    def done(self) -> bool:
        if self.error is not None:
            return True
        return self.active and self.exhausted and not self.inflight

    def results(self) -> List[str]:
        """Decoded rows in prompt order; re-raises this submission's
        terminal error (e.g. its model can never fit the pool budget)
        at the consumer instead of aborting unrelated tenants' work."""
        if self.error is not None:
            raise self.error
        return [r.text for r in self.reqs]


@dataclass
class SchedulerStats:
    ticks: int = 0
    rows: int = 0
    wall_s: float = 0.0
    # device fan-out: how many distinct devices had an in-flight decode
    # step dispatched in the same tick (1 on a single-device pool)
    peak_concurrent_devices: int = 1
    # graceful degradation: submissions quarantined off a faulted
    # engine (each retried on the pooled base engine until
    # ``max_retries`` is spent), with one event record apiece
    degradations: int = 0
    events: List[Dict[str, Any]] = field(default_factory=list)
    # per-tenant streaming histograms (serving/metrics.py): queue-wait
    # and per-row latency reservoirs + row/degradation counters
    tenants: Dict[str, TenantStats] = field(default_factory=dict)

    @property
    def rows_per_s(self) -> float:
        return self.rows / self.wall_s if self.wall_s else 0.0

    def tenant(self, name: str) -> TenantStats:
        ts = self.tenants.get(name)
        if ts is None:
            ts = self.tenants[name] = TenantStats()
        return ts

    def as_dict(self) -> Dict[str, Any]:
        """JSON-ready snapshot (the ``/stats`` endpoint's scheduler
        section; p50/p95/p99 come from the per-tenant reservoirs)."""
        return {"ticks": self.ticks, "rows": self.rows,
                "wall_s": self.wall_s, "rows_per_s": self.rows_per_s,
                "peak_concurrent_devices": self.peak_concurrent_devices,
                "degradations": self.degradations,
                "events": list(self.events),
                "tenants": {t: ts.as_dict()
                            for t, ts in self.tenants.items()}}


class Scheduler:
    """Interleaves ``Engine.step()`` across the pool's engines.

    ``share`` bounds each submission's un-finished rows: every tick
    tops every active submission up to ``share`` (round-robin rotation
    so admission order is fair), then runs one decode tick per engine
    with work.  Submissions whose model cannot become resident yet
    (budget full of pinned engines) wait in FIFO order and activate as
    pins release — head-of-line activation, so waiting is starvation-
    free too.
    """

    def __init__(self, pool: ModelPool, *, share: int = 8,
                 max_retries: int = 2):
        self.pool = pool
        self.share = max(1, share)
        # fault quarantine: how many engine evacuations one submission
        # may survive before its error turns terminal
        self.max_retries = max(0, max_retries)
        self.pending: "deque[Submission]" = deque()
        self.active: List[Submission] = []
        self.finished: List[Submission] = []
        self.stats = SchedulerStats()
        self.trace: List[Tuple[int, str]] = []   # (tick, tenant) per row
        self._owners: Dict[Tuple[int, int], Submission] = {}
        self._t0: Dict[Tuple[int, int], float] = {}   # row submit times
        self._rr = 0

    # -- submission -----------------------------------------------------
    def submit(self, tenant: str, prompts: Iterable[str], *, qsig: str,
               probe: Optional[Iterable[str]] = None, max_new: int = 16,
               prefix: Optional[str] = None,
               optimize: bool = True,
               share: Optional[int] = None) -> Submission:
        """Enqueue one tenant's prompt stream; prompts are consumed
        lazily as the scheduler admits them.  ``share`` (when set) caps
        THIS submission's in-flight rows below the scheduler-wide
        share — the per-tenant max-in-flight SLO knob."""
        sub = Submission(tenant=tenant, prompts=iter(prompts), qsig=qsig,
                         probe=list(probe or []), max_new=max_new,
                         prefix=prefix, optimize=optimize, share=share,
                         submit_t=time.time())
        self.pending.append(sub)
        self._activate()
        return sub

    def _activate(self) -> None:
        """FIFO head-of-line activation of pending submissions."""
        while self.pending:
            sub = self.pending[0]
            try:
                if sub.model is None:       # optimize exactly once
                    sub.model = self.pool.resolve(sub.qsig, sub.probe,
                                                  optimize=sub.optimize)
                engine = self.pool.admit(sub.model)
            except PoolBudgetError as e:
                if not e.retryable:
                    # this submission can NEVER fit: fail it alone (the
                    # error surfaces from its results()) and keep
                    # scheduling everyone else
                    self.pending.popleft()
                    sub.error = e
                    self.finished.append(sub)
                    continue
                return          # budget full of pinned engines: wait
            self.pool.pin(engine.version)
            sub.engine = engine
            self.active.append(sub)
            self.pending.popleft()
            if sub.activated_t is None:
                sub.activated_t = time.time()
                self.stats.tenant(sub.tenant).queue_wait.add(
                    sub.activated_t - sub.submit_t)
            # a quarantined submission re-activating on its replacement
            # engine re-submits its unfinished rows (finished rows keep
            # their outputs — only pending work is replayed)
            if any(not r.done for r in sub.reqs):
                self._resubmit_unfinished(sub)

    # -- the tick -------------------------------------------------------
    def _top_up(self, sub: Submission) -> None:
        cap = (self.share if sub.share is None
               else max(1, min(self.share, sub.share)))
        while len(sub.inflight) < cap and not sub.exhausted:
            p = next(sub.prompts, _EXHAUSTED)
            if p is _EXHAUSTED:
                sub.exhausted = True
                break
            try:
                r = sub.engine.submit(p, max_new=sub.max_new,
                                      prefix=sub.prefix)
            except Exception as e:
                # the consumed prompt must not be lost: park it as an
                # unfinished placeholder so the replacement engine
                # replays it with the rest of the quarantined rows
                ph = Request(rid=-1, prompt_ids=[], max_new=sub.max_new,
                             src=p)
                sub.reqs.append(ph)
                self._quarantine_engine(sub.engine, e)
                return
            if r.src is None:
                r.src = p
            sub.reqs.append(r)
            if r.done:          # result-cache hit: resolved instantly
                self._record_done(sub)
            else:
                sub.inflight.add(r.rid)
                self._owners[(id(sub.engine), r.rid)] = sub
                self._t0[(id(sub.engine), r.rid)] = time.time()
        sub.peak_inflight = max(sub.peak_inflight, len(sub.inflight))

    def _record_done(self, sub: Submission, latency: float = 0.0) -> None:
        self.stats.rows += 1
        self.trace.append((self.stats.ticks, sub.tenant))
        ts = self.stats.tenant(sub.tenant)
        ts.rows += 1
        ts.latency.add(latency)
        if sub.first_done_tick is None:
            sub.first_done_tick = self.stats.ticks
        sub.last_done_tick = self.stats.ticks

    # -- graceful degradation -------------------------------------------
    def _quarantine_engine(self, engine, exc: BaseException) -> None:
        """An engine raising mid-tick poisons ONLY the submissions bound
        to it: the entry is discarded from the pool (pins cleared), each
        affected submission's unfinished rows are kept for replay
        (``Request.src`` holds the prompt text) and the submission
        re-enters the pending queue with ``optimize=False`` — the retry
        runs on the pooled base engine, trading the compressed recipe
        for availability.  The event lands in ``stats.events`` instead
        of killing the tick; a submission that keeps faulting past
        ``max_retries`` gets a terminal error (surfaced from its
        ``results()``, like an unretryable admission failure).

        A :class:`KernelError` (a kernel that fails to build or launch,
        or whose wrapper refuses its inputs) is re-raised instead: serving
        the rows on another engine would hide the fault behind a path
        that runs other kernels, or none."""
        if isinstance(exc, KernelError):
            raise exc
        eid = id(engine)
        version = getattr(engine, "version", "?")
        self.pool.discard(version, engine=engine)
        victims = [s for s in self.active if s.engine is engine]
        for sub in victims:
            self.active.remove(sub)
            sub.retries += 1
            for rid in list(sub.inflight):
                self._owners.pop((eid, rid), None)
                self._t0.pop((eid, rid), None)
            sub.inflight.clear()
            sub.engine = None
            self.stats.degradations += 1
            self.stats.tenant(sub.tenant).degradations += 1
            terminal = sub.retries > self.max_retries
            self.stats.events.append({
                "tick": self.stats.ticks, "tenant": sub.tenant,
                "engine": version,
                "error": f"{type(exc).__name__}: {exc}",
                "action": "failed" if terminal else "retry_base"})
            if terminal:
                sub.error = exc
                self.finished.append(sub)
                continue
            sub.optimize = False
            sub.model = None
            self.pending.appendleft(sub)

    def _resubmit_unfinished(self, sub: Submission) -> None:
        """Replay a quarantined submission's unfinished rows on its
        replacement engine, splicing the new requests over the old ones
        so row order (and every already-finished output) is
        preserved."""
        eid = id(sub.engine)
        for i, r in enumerate(list(sub.reqs)):
            if r.done:
                continue
            try:
                nr = sub.engine.submit(r.src or "", max_new=sub.max_new,
                                       prefix=sub.prefix)
            except Exception as e:
                self._quarantine_engine(sub.engine, e)
                return
            if nr.src is None:
                nr.src = r.src
            sub.reqs[i] = nr
            if nr.done:
                self._record_done(sub)
            else:
                sub.inflight.add(nr.rid)
                self._owners[(eid, nr.rid)] = sub
                self._t0[(eid, nr.rid)] = time.time()
        sub.peak_inflight = max(sub.peak_inflight, len(sub.inflight))

    def _retire_done(self) -> None:
        still = []
        for sub in self.active:
            if sub.done:
                self.pool.unpin(sub.engine.version)
                self.finished.append(sub)
            else:
                still.append(sub)
        self.active[:] = still

    def step(self) -> bool:
        """One fair-share tick; returns True while work remains."""
        self._activate()
        self.stats.ticks += 1
        order = list(self.active)   # snapshot: quarantine may mutate
        n = len(order)
        for i in range(n):          # rotating round-robin admission
            sub = order[(self._rr + i) % n]
            if sub.engine is not None:   # skip mid-tick quarantined
                self._top_up(sub)
        if n:
            self._rr = (self._rr + 1) % n
        # one decode tick per distinct engine with work, in activation
        # order (deterministic).  Fan-out: DISPATCH every engine's tick
        # (step_begin launches the decode asynchronously) before
        # COLLECTING any of them — engines placed on distinct devices
        # overlap their decode steps instead of serializing.  Ordering
        # and per-engine sequencing are unchanged, so outputs stay
        # byte-identical to stepping each engine to completion in turn.
        engines: "OrderedDict[int, Engine]" = OrderedDict()
        for sub in self.active:
            engines.setdefault(id(sub.engine), sub.engine)
        pending: List[Tuple[int, Engine, Any]] = []
        devs: Set[Any] = set()
        for eid, eng in engines.items():
            if not eng.has_work():
                continue
            if hasattr(eng, "step_begin"):
                try:
                    handle = eng.step_begin()
                except Exception as e:
                    self._quarantine_engine(eng, e)
                    continue
                pending.append((eid, eng, handle))
                # count only devices with a decode genuinely in
                # flight: a tick whose rows all retired at admission
                # (handle.nxt is None) overlapped nothing, and split-
                # less fallback engines run serially at collect time.
                # Engines placed on one physical device count once.  A
                # mesh-sharded engine's decode occupies EVERY position's
                # device, so each one counts (on one card, once).
                if handle.nxt is not None:
                    mesh = getattr(eng, "mesh", None)
                    if mesh is not None:
                        devs.update(mesh.devices.flat)
                    else:
                        devs.add(getattr(eng, "device", None))
            else:            # fakes / remote backends without the split
                pending.append((eid, eng, _WHOLE_STEP))
        self.stats.peak_concurrent_devices = max(
            self.stats.peak_concurrent_devices, len(devs))
        for eid, eng, handle in pending:
            try:
                reqs = (eng.step() if handle is _WHOLE_STEP
                        else eng.step_finish(handle))
            except Exception as e:
                self._quarantine_engine(eng, e)
                continue
            now = time.time()
            for req in reqs:
                owner = self._owners.pop((eid, req.rid), None)
                if owner is not None:
                    owner.inflight.discard(req.rid)
                    t0 = self._t0.pop((eid, req.rid), None)
                    self._record_done(owner,
                                      now - t0 if t0 is not None else 0.0)
        self._retire_done()
        self._activate()            # released pins may admit waiters
        return bool(self.active or self.pending)

    def run(self) -> List[Submission]:
        """Tick until every submission completes; returns them all."""
        t0 = time.time()
        while self.step():
            pass
        self.stats.wall_s += time.time() - t0
        return self.finished

    # -- whole-query concurrency ---------------------------------------
    def run_queries(self, queries: Dict[str, Any]) -> Dict[str, Any]:
        """Drive OLAP query *plans* concurrently: ``queries`` maps
        tenant -> ``Query``; each plan's LLM operators run in order,
        but operators of different tenants interleave tick-by-tick.
        Each plan is wrapped in a ``QueryDriver`` (the re-entrant
        per-query state machine below, shared with the long-running
        service); a tenant's plan failure is captured per driver and
        re-raised here after the fleet drains, so one bad plan never
        aborts the other tenants' queries mid-flight.  Returns
        tenant -> result Table."""
        drivers = {t: QueryDriver(self, t, q) for t, q in queries.items()}
        t0 = time.time()
        for d in drivers.values():
            d.start()
        while any(d.sub is not None for d in drivers.values()):
            self.step()
            for d in drivers.values():
                d.poll()
        self.stats.wall_s += time.time() - t0
        for d in drivers.values():
            if d.error is not None:
                raise d.error
        return {t: d.result for t, d in drivers.items()}


class QueryDriver:
    """Drives ONE OLAP query plan through a ``Scheduler``, operator by
    operator — the re-entrant core of ``Scheduler.run_queries``, reused
    by the reference's always-on service, where query jobs arrive
    dynamically instead of as one batch (ROADMAP queue 1 item 8).

    Each ``Query._ops()`` generator yields optimizer-lowered
    ``ExecutableOp``s (olap/physical.py) carrying the per-op engine
    choice (base vs instance-optimized recipe vs cascade), probe
    sample, prefix template, and the dedup-wrapped prompt stream.  A
    cascade op runs as TWO submissions: every row through the pooled
    proxy engine first, then the rows whose confidence fell below the
    fitted threshold re-enter the scheduler as a base-engine
    submission (proxy and base coexist under the one pool budget);
    accepted and escalated outputs splice back in row order before the
    plan advances.

    Lifecycle: ``start()`` submits the plan's first LLM op; the owner
    ticks the scheduler and calls ``poll()`` until ``finished`` — each
    poll collects a completed submission, advances the plan coroutine
    and submits the next op.  Failures (a plan error or a submission's
    terminal error) land in ``error`` instead of raising, so one
    tenant's failure never unwinds another tenant's scheduling loop.
    ``share`` forwards a per-tenant in-flight-row cap to every
    submission; ``on_op_done(driver, op, outs)`` fires as each operator
    completes (the service streams operator progress from it).
    """

    def __init__(self, sched: Scheduler, tenant: str, query, *,
                 share: Optional[int] = None,
                 on_op_done: Optional[Callable] = None):
        self.sched = sched
        self.tenant = tenant
        self.query = query
        self.share = share
        self.on_op_done = on_op_done
        self.gen = query._ops()
        self.sub: Optional[Submission] = None
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.ops_done = 0
        self._op = None                      # ExecutableOp in flight
        self._cascade: Optional[Dict[str, Any]] = None

    @property
    def finished(self) -> bool:
        return self.result is not None or self.error is not None

    def start(self) -> None:
        self._advance(None)

    def poll(self) -> bool:
        """Collect a finished submission and advance the plan; returns
        ``finished``.  Cheap while the current submission is still in
        flight."""
        if self.finished or self.sub is None or not self.sub.done:
            return self.finished
        sub, self.sub = self.sub, None
        try:
            outs = self._collect(sub)
        except Exception as e:
            self.error = e
            return True
        if outs is not None:
            op, self._op = self._op, None
            self.ops_done += 1
            if self.on_op_done is not None:
                self.on_op_done(self, op, outs)
            self._advance(outs)
        return self.finished

    # -- plan coroutine plumbing ---------------------------------------
    def _submit(self, prompts, op, *, optimize: bool) -> Submission:
        return self.sched.submit(
            self.tenant, prompts, qsig=op.qsig, probe=op.probe,
            max_new=op.spec.max_new, prefix=op.spec.prefix,
            optimize=optimize, share=self.share)

    def _advance(self, send_val) -> None:
        try:
            op = self.gen.send(send_val)
        except StopIteration as stop:
            self.result = stop.value
            return
        except Exception as e:       # plan/table failure: capture
            self.error = e
            return
        self._op = op
        if op.op.engine == "cascade":
            budget = op.op.accuracy_budget or 0.0
            cal = self.sched.pool.session._cascade(
                op.qsig, op.probe, budget, max_new=op.spec.max_new)
            prompts = list(op.spec.prompts)
            if not math.isfinite(cal.threshold):
                # unsatisfiable budget: base-only, no proxy pass —
                # the exactness contract for accuracy_budget=0
                self.sub = self._submit(iter(prompts), op, optimize=False)
                return
            self._cascade = {"cal": cal, "prompts": prompts}
            self.sub = self._submit(iter(prompts), op, optimize=True)
            return
        self.sub = self._submit(op.spec.prompts, op, optimize=op.optimize)

    def _collect(self, sub: Submission):
        """Finished-submission hand-off: the op's output rows, or None
        when a cascade just queued its escalation phase."""
        state = self._cascade
        if state is None:
            return sub.results()
        if "rejects" not in state:      # proxy phase finished
            outs = sub.results()
            thr = state["cal"].threshold
            rejects = [i for i, r in enumerate(sub.reqs)
                       if r.confidence < thr]
            if not rejects:
                self._cascade = None
                return outs
            state["outs"] = outs
            state["rejects"] = rejects
            self.sub = self._submit(
                iter([state["prompts"][i] for i in rejects]), self._op,
                optimize=False)
            return None
        outs, rejects = state["outs"], state["rejects"]
        for i, o in zip(rejects, sub.results()):
            outs[i] = o
        self._cascade = None
        return outs
