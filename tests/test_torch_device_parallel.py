"""Sharded (tensor-parallel) admission of the port's pool, against the reference's.

- The reference's fake-engine mesh cases (``tests/test_device_parallel.py``
  ``TestShardedAdmission``), driven by the same call sequence through the
  reference's ``ModelPool(mesh=)`` and the port's: equal placements,
  per-device charges, ``PoolStats``, eviction logs and refusals.
- On ``tiny_dense`` in f32, a sharded "big" tenant beside two small ones
  on a (1, 4) mesh of CPU positions: each tenant's rows equal a private
  engine with the same placement run serially (the contract of the
  reference's ``test_tp_engine_coexists_and_matches_serial_mesh_run``).
- ``IOLMSession(mesh=, pool_budget=)`` whose budget admits the query's
  picked instance only sharded answers with the rows of a pool-less
  session.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serving import scheduler as RS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.core.pipeline import Recipe  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.olap import query as Q  # noqa: E402
from repro_torch.olap.table import Table  # noqa: E402
from repro_torch.serving import scheduler as PS  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.training.data import ByteTokenizer  # noqa: E402

from test_scheduler import FakeEngine, FakeSession  # noqa: E402


class PlacedFakeEngine(FakeEngine):
    def __init__(self, version, slots=2, device=None, mesh=None):
        super().__init__(version, slots=slots)
        self.device = device
        self.mesh = mesh


def fake_mesh(n):
    """Duck-typed mesh: the pools read only ``.devices.flat``."""
    return SimpleNamespace(devices=np.array([f"dev{i}" for i in range(n)], dtype=object))


def placed_pool(mod, sizes, budget, *, ndev=3, mesh=False):
    kw = dict(engine_factory=lambda m, device=None, mesh=None: PlacedFakeEngine(
        m.version, device=device, mesh=mesh), entry_bytes=lambda m: sizes[m.version])
    if mesh:
        return mod.ModelPool(FakeSession(sizes), budget, mesh=fake_mesh(ndev), **kw)
    return mod.ModelPool(FakeSession(sizes), budget, devices=[f"dev{i}" for i in range(ndev)],
                         **kw)


def _record(pool, versions, events):
    return {"placements": {v: pool.placement_of(v) for v in versions},
            "device_bytes": [pool.device_bytes(i) for i in range(len(pool.devices))],
            "stats": vars(pool.stats), "evictions": list(pool.eviction_log),
            "resident": pool.resident_versions, "events": events}


def _admit(pool, version):
    """(kind, detail) of one admission: where its engine sits, or the
    refusal and whether it may be retried."""
    try:
        eng = pool.engine_for(version)
    except Exception as e:  # PoolBudgetError of either package
        return ("refused", bool(getattr(e, "retryable", None)))
    return ("sharded" if eng.mesh is not None else "placed", eng.device is None)


CASES = {
    "oversize_without_mesh": (dict(sizes={"big": 250}, budget=100, ndev=3), ["big"]),
    "oversize_with_mesh": (dict(sizes={"big": 250, "small": 10}, budget=100, ndev=3,
                                mesh=True), ["big", "small"]),
    "sharded_beyond_mesh": (dict(sizes={"huge": 1000}, budget=100, ndev=3, mesh=True),
                            ["huge"]),
    "sharded_eviction": (dict(sizes={"big": 250, "a": 90, "b": 90, "c": 90}, budget=100,
                              ndev=3, mesh=True), ["big", "a", "b", "c"]),
    "pinned_blocks_sharded": (dict(sizes={"a": 90, "big": 250}, budget=100, ndev=3,
                                   mesh=True), ["a", "pin:a", "big", "unpin:a", "big"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fake_mesh_cases_equal_reference(case):
    kw, calls = CASES[case]
    out = []
    for mod in (RS, PS):
        pool = placed_pool(mod, **kw)
        events = []
        for c in calls:
            if c.startswith("pin:"):
                pool.pin(c[4:])
            elif c.startswith("unpin:"):
                pool.unpin(c[6:])
            else:
                events.append(_admit(pool, c))
        out.append(_record(pool, kw["sizes"], events))
    assert out[1] == out[0]
    if case == "oversize_with_mesh":      # the reference test's expectations
        assert out[1]["placements"]["big"] == (0, 1, 2) and out[1]["device_bytes"][2] == 84
        assert out[1]["stats"]["sharded_admissions"] == 1


def test_fake_fan_out_counts_every_mesh_position():
    """The tick's fan-out counts each position's device of a sharded
    engine's decode as busy, as the reference's does (distinct devices
    here; on one card every position is the same device and counts once)."""
    class Split(PlacedFakeEngine):
        def step_begin(self):
            return SimpleNamespace(nxt=object(), done=self.step())

        def step_finish(self, handle):
            return handle.done

    sizes = {"big": 250}
    pool = PS.ModelPool(FakeSession(sizes), 100, mesh=fake_mesh(3),
                        engine_factory=lambda m, device=None, mesh=None: Split(
                            m.version, device=device, mesh=mesh),
                        entry_bytes=lambda m: sizes[m.version])
    sched = PS.Scheduler(pool, share=2)
    sub = sched.submit("t", ["x", "yy"], qsig="big")
    sched.run()
    assert sub.results() == ["out(x)", "out(yy)"]
    assert sched.stats.peak_concurrent_devices == 3


# ---------------------------------------------------------------------------
# real engines on a mesh of CPU positions
# ---------------------------------------------------------------------------

ENGINE_KW = dict(slots=2, max_len=64, buckets=(24,))


class _SameParamsSession:
    def __init__(self, params, cfg, tok):
        self.params, self.cfg, self.tok = params, cfg, tok

    def _optimize(self, qsig, probe):
        return SimpleNamespace(params=self.params, cfg=self.cfg, version=qsig)


@pytest.fixture(scope="module")
def tiny_f32(tiny_dense):
    rcfg, rparams = tiny_dense
    rcfg = rcfg.replace(param_dtype="float32")
    rparams = jax.tree.map(lambda a: a.astype(jnp.float32), rparams)
    return from_reference(rcfg), bridge.from_reference(rparams, device="cpu")


def test_tp_engine_coexists_and_matches_serial_mesh_run(tiny_f32):
    cfg, params = tiny_f32
    tok = ByteTokenizer(max(cfg.vocab_size, 260))
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    sizes = {"big": 300, "small0": 20, "small1": 20}
    pool = PS.ModelPool(_SameParamsSession(params, cfg, tok), 100,
                        engine_kw={**ENGINE_KW, "device": "cpu"}, mesh=mesh,
                        entry_bytes=lambda m: sizes[m.version])
    sched = PS.Scheduler(pool, share=2)
    prompts = {"big": ["alpha row", "beta row"], "small0": ["gamma row"],
               "small1": ["delta row"]}
    subs = [sched.submit(v, ps, qsig=v, max_new=8) for v, ps in prompts.items()]
    sched.run()
    assert pool.stats.sharded_admissions == 1
    assert pool.placement_of("big") == (0, 1, 2, 3)
    assert [pool.device_bytes(i) for i in range(4)] == [95, 95, 75, 75]
    for sub in subs:
        kw = dict(ENGINE_KW)
        if sub.qsig == "big":
            kw["mesh"] = make_mesh((1, 4), ("data", "model"), device="cpu")
        else:
            kw["device"] = pool.devices[pool.placement_of(sub.qsig)[0]]
        ref = Engine(params, cfg, tokenizer=tok, version=sub.qsig,
                     **kw).generate(prompts[sub.tenant], max_new=8)
        assert sub.results() == ref
    # the sharded entry is one engine over the mesh; the smalls are placed
    big = pool.engine_for("big")
    assert big.mesh is mesh and not big._paged


def test_session_mesh_answers_with_single_device_rows(tiny_f32):
    cfg, params = tiny_f32
    recipes = [Recipe(name="w8-absmax", wbits=8, quant_method="absmax")]
    kw = dict(device="cpu", recipes=recipes, calib_rows=4, eval_rows=2,
              engine_kw=dict(ENGINE_KW))
    single = Q.IOLMSession(params, cfg, **kw)
    want = Q.Query(Table({"lang": ["pyton", "jva", "rsut"]}), single) \
        .llm_correct("lang").run()
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    roomy = Q.IOLMSession(params, cfg, pool_budget=1 << 40, mesh=mesh, **kw)
    assert Q.Query(Table({"lang": ["pyton", "jva", "rsut"]}), roomy) \
        .llm_correct("lang").run().rows() == want.rows()
    assert roomy.pool.stats.sharded_admissions == 0
    entry = roomy.pool.stats.peak_resident_bytes      # the picked instance's charge
    sess = Q.IOLMSession(params, cfg, pool_budget=entry // 2, mesh=mesh, **kw)
    got = Q.Query(Table({"lang": ["pyton", "jva", "rsut"]}), sess).llm_correct("lang").run()
    assert sess.pool.stats.sharded_admissions == 1
    assert got.rows() == want.rows()
