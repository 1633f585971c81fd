"""The port's hot-path auditor (``repro_torch.analysis.jit_audit``).

A clean engine audits to zero diagnostics on both KV layouts, and every
code fires when its regression is planted: a host sync in ``_decode``, a
decode step that copies the slot state, a call site that does not rebind
a donated buffer, a host argument, a one-element f32 tensor promoting
bf16, a kernel library loaded inside the loop, a prefill inside the
step, a collective on one device.  ``audit_donation_sites`` and
``default_workload`` equal the reference's on the same inputs.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(4)

from repro_torch.analysis import jit_audit as JA  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

# the reference's tiny engine config (tools/analyze.py)
CFG = ModelConfig(name="audit", family="dense", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab_size=260, max_seq=256)
BUCKETS = (32, 64)          # the default workload's short and long rows
TARGETS = ("_insert", "_decode", "_seed", "_prefill", "_prefill_from")


@pytest.fixture(scope="module")
def params():
    return api.init_params(torch.Generator().manual_seed(0), CFG)


def engine(params, layout="paged", cfg=CFG, **kw):
    return Engine(params, cfg, device="cpu", kv_layout=layout, buckets=BUCKETS, **kw)


@pytest.fixture(scope="module", params=["paged", "contiguous"])
def audited(request, params):
    """One audit of a clean engine per layout, shared by the assertions."""
    eng = engine(params, request.param)
    return eng, JA.audit_engine(eng)


def codes(report):
    return [d.code for d in report.diagnostics]


class TestCleanEngine:
    def test_zero_diagnostics(self, audited):
        _, report = audited
        assert report.diagnostics == [], [d.to_dict() for d in report.diagnostics]

    def test_workload_covers_every_target(self, audited):
        eng, report = audited
        stats = report.cache_stats
        assert {f"_prefill[{b}]" for b in eng.buckets} <= set(stats)
        assert any(n.startswith("_prefill_from[") for n in stats)
        assert {"_decode", "_insert"} <= set(stats)
        assert ("_seed" in stats) == eng._paged
        for s in stats.values():
            assert s["calls"] >= s["signatures"] >= 1 and s["compiles"] == 0

    def test_budget_within_factors(self, audited):
        _, report = audited
        b = report.budget
        assert b["steps"] == report.cache_stats["_decode"]["calls"]
        assert 0 < b["flops"] <= 4 * b["expected_flops"]
        assert 0 < b["bytes"] <= 16 * b["expected_bytes"]
        assert b["coll_bytes"] == 0

    def test_audit_restores_engine_targets(self, audited):
        eng, _ = audited
        assert not set(TARGETS) & set(eng.__dict__)
        for name, fn in eng.jit_targets().items():
            assert not isinstance(fn, (JA.JitCallRecorder, JA._Ladder)), name
            assert fn.__self__ is eng, name
        assert build.load.__name__ == "load"

    def test_confidence_reaches_requests(self, audited):
        eng, report = audited
        reqs = eng.generate_stream(["confidence probe"], max_new=4, return_requests=True)
        assert 0.0 < reqs[0].confidence <= 1.0


def test_names_cover_the_hot_path(params):
    for layout in ("paged", "contiguous"):
        eng = engine(params, layout)
        names = set(eng.jit_targets())
        assert {"_insert", "_decode"} <= names
        assert ("_seed" in names) == (layout == "paged")
        assert {n for n in names if n.startswith("_prefill[")} == {
            f"_prefill[{b}]" for b in eng.buckets}
        assert {n for n in names if n.startswith("_prefill_from[")} == {
            f"_prefill_from[{b}]" for b in eng.buckets}
    no_prefix = engine(params, use_prefix_cache=False)
    assert not any(n.startswith("_prefill_from[") for n in no_prefix.jit_targets())


@pytest.mark.parametrize("arch,layout", [("zamba2-7b", "paged"), ("zamba2-7b", "contiguous"),
                                         ("rwkv6-3b", "contiguous")])
def test_recurrent_state_is_written_in_place(arch, layout):
    """JIT002 on the families with recurrent slot state: the decode step
    and the admission write the SSD, conv and WKV states in place."""
    cfg = registry.get_reduced(arch)
    p = api.init_params(torch.Generator().manual_seed(1), cfg)
    eng = engine(p, layout, cfg=cfg)
    report = JA.audit_engine(eng, prompts=JA.default_workload(eng)[:6])
    assert eng._paged == (layout == "paged")
    assert {"_decode", "_insert"} <= set(report.cache_stats)
    assert "JIT002" not in codes(report), [d.to_dict() for d in report.diagnostics]


class TestInjectedRegressions:
    def test_host_sync_in_decode_fires_JIT001(self, params):
        eng = engine(params)
        orig = eng._decode

        def synced(tables, toks, pos):
            int(pos[0].item())                    # the injected host sync
            return orig(tables, toks, pos)

        eng._decode = synced
        report = JA.audit_engine(eng, prompts=["a", "b", "c"])
        hits = [d for d in report.diagnostics if d.code == "JIT001"]
        assert hits and hits[0].location == "engine._decode"
        assert "_local_scalar_dense" in hits[0].message
        assert eng._decode is synced              # the planted target is restored

    def test_state_copy_in_decode_fires_JIT002(self, params):
        eng = engine(params)
        orig = eng._decode

        def copying(tables, toks, pos):
            nxt, conf, state = orig(tables, toks, pos)
            return nxt, conf, tree_map(lambda t: t.clone(), state)

        eng._decode = copying
        report = JA.audit_engine(eng, prompts=["a", "b", "c"])
        assert [d.location for d in report.diagnostics if d.code == "JIT002"] == [
            "engine._decode"]

    def test_donated_arg_not_rebound_fires_JIT003(self):
        src = ("leaked = self._decode(self.params, self._slot_state,"
               " toks, pos, ctr)\n"
               "self._slot_state = leaked[1]\n")
        diags = JA.audit_donation_sites(src, {"_decode": (1,)}, "x.py")
        assert [d.code for d in diags] == ["JIT003"]
        assert "self._slot_state" in diags[0].message

    def test_port_engine_call_sites_pass(self):
        import inspect

        from repro_torch.serving import engine as engine_module
        src = inspect.getsource(engine_module)
        assert JA.audit_donation_sites(src, JA.ENGINE_DONATIONS, "serving/engine.py") == []
        rebound = {"_insert": (0,), "_decode": (1,)}
        ok = ("self._slot_state = self._insert(self._slot_state, rows, idxs)\n"
              "nxt, self._slot_state = self._decode(self.params, self._slot_state, t)\n")
        assert JA.audit_donation_sites(ok, rebound, "x.py") == []

    def test_numpy_argument_fires_JIT004(self, params):
        """The engine once handed ``_insert`` its slot indices as a numpy
        array, copied to the device inside the target."""
        eng = engine(params)
        rec = JA.JitCallRecorder("_prefill", eng._prefill, eng)
        toks = torch.zeros((2, 32), dtype=torch.long)
        rec(toks, np.array([3, 4]))
        rec(toks, [3, 4])
        rec(toks, torch.tensor([3, 4]))
        diags = JA.audit_host_args(rec)
        assert [d.code for d in diags] == ["JIT004", "JIT004"]
        assert "numpy array" in diags[0].message and "list" in diags[1].message

    def test_one_element_f32_promotion_fires_JIT005(self, params):
        eng = engine(params)
        orig = eng._decode

        def promoted(tables, toks, pos):
            (torch.ones(4, dtype=torch.bfloat16) * torch.ones(1)).sum()
            (torch.ones(4, dtype=torch.bfloat16) * torch.tensor(2.0)).sum()   # 0-dim: no
            return orig(tables, toks, pos)

        eng._decode = promoted
        report = JA.audit_engine(eng, prompts=["a", "b"])
        hits = [d for d in report.diagnostics if d.code == "JIT005"]
        assert len(hits) == 1 and "aten::mul" in hits[0].message

    def test_library_load_in_the_loop_fires_JIT006(self, params, monkeypatch):
        monkeypatch.setattr(build, "_start", lambda name: None)
        monkeypatch.setattr(build, "_finish", lambda name, started: "")
        monkeypatch.setattr(build, "_target", lambda name: f"{name}.so")
        monkeypatch.setattr(build.ctypes, "CDLL", lambda path: types.SimpleNamespace())
        eng = engine(params)
        orig = eng._decode

        def building(tables, toks, pos):
            build._LIBS.pop("planted", None)
            build.load("planted")                  # nvcc inside the step
            return orig(tables, toks, pos)

        eng._decode = building
        try:
            report = JA.audit_engine(eng, prompts=["a", "b"], max_new=4)
        finally:
            build._LIBS.pop("planted", None)
        hits = [d for d in report.diagnostics if d.code == "JIT006"]
        assert hits and hits[0].location == "engine._decode" and "planted" in hits[0].message
        assert report.cache_stats["_decode"]["compiles"] == report.cache_stats["_decode"]["calls"]

    def test_prefill_inside_decode_fires_JIT007_and_JIT008(self, params):
        eng = engine(params)
        orig = eng._decode

        def prefilling(tables, toks, pos):
            full = torch.zeros((eng.slots, eng.max_len - 1), dtype=torch.long)
            api.prefill(eng.params, CFG, {"tokens": full}, max_len=eng.max_len,
                        compact_local=False)
            return orig(tables, toks, pos)

        eng._decode = prefilling
        report = JA.audit_engine(eng, prompts=["a", "b"], max_new=2)
        assert {"JIT007", "JIT008"} <= set(codes(report)), report.budget
        assert report.budget["flops"] > 100 * report.budget["expected_flops"]

    def test_collective_on_one_device_fires_JIT009(self, params, tmp_path):
        import torch.distributed as dist
        dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                                world_size=1, rank=0)
        try:
            eng = engine(params)
            orig = eng._decode

            def reducing(tables, toks, pos):
                dist.all_reduce(torch.zeros(16))
                return orig(tables, toks, pos)

            eng._decode = reducing
            report = JA.audit_engine(eng, prompts=["a", "b"], max_new=2)
        finally:
            dist.destroy_process_group()
        assert "JIT009" in codes(report)
        assert report.budget["coll_bytes"] == 64 * report.budget["steps"]


def test_default_workload_and_donation_sites_equal_the_reference():
    from repro.analysis import jit_audit as RJA
    for slots, buckets in ((8, (32, 64, 128)), (4, (48,)), (2, (16, 96))):
        eng = types.SimpleNamespace(slots=slots, buckets=buckets)
        assert JA.default_workload(eng) == RJA.default_workload(eng)
    srcs = ["leaked = self._decode(self.params, self._slot_state, toks, pos, ctr)\n"
            "self._slot_state = leaked[1]\n",
            "self._slot_state = self._insert(self._slot_state, rows, idxs)\n"
            "nxt, self._slot_state = self._decode(self.params, self._slot_state, t, p, c)\n",
            "self._seed(self._slot_state, entry, w)\nx = self._insert(y, z)\n"]
    for src in srcs:
        for table in (RJA.ENGINE_DONATIONS, JA.ENGINE_DONATIONS):
            got = [d.to_dict() for d in JA.audit_donation_sites(src, table, "e.py")]
            want = [d.to_dict() for d in RJA.audit_donation_sites(src, table, "e.py")]
            assert got == want
