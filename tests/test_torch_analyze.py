"""``tools/torch_analyze.py``: the port's static-analysis command.

Its plan layer gives the reference's codes and rule firings on the
reference's workload suite (built here from ``repro.olap``: importing
``tools/analyze.py`` would set ``XLA_FLAGS``), and ``main`` gates on the
committed baseline: 0 on the tree, 1 on a finding absent from it.
"""
import importlib.util
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(4)

ROOT = Path(__file__).resolve().parents[1]
BASELINE = ROOT / "tools" / "torch_analysis_baseline.json"


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("torch_analyze",
                                                  ROOT / "tools" / "torch_analyze.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_workloads():
    from repro.olap import plan as P
    from repro.olap.table import Table

    t = Table({"category": ["a", "b", "a", "a", "c", "b", "a", "c"],
               "status": ["ok", "bad", "ok", "bad", "ok", "ok", "bad", "ok"]})
    right = Table({"name": ["alpha", "beta"]})
    scan = P.Scan(t)

    def m(inp, col="category", prompt="label: ", out="label", new=8):
        return P.LLMMap(input=inp, col=col, prompt=prompt, out_col=out, max_new=new)

    return {
        "pushdown": P.Filter(input=m(scan), pred=lambda r: r["status"] == "ok",
                             columns=("status",)),
        "fusion": m(m(scan), out="label2"),
        "dedup": m(scan),
        "filter_chain": P.Filter(
            input=P.LLMFilter(input=m(scan), col="status", prompt="keep? ", max_new=2),
            pred=lambda r: r["status"] == "ok", columns=("status",)),
        "correct_select": P.Select(
            input=P.LLMCorrect(input=scan, col="status", prompt="fix: ",
                               out_col="status_fixed", max_new=8),
            cols=("category", "status_fixed")),
        "join": P.LLMJoin(input=scan, right=right, on=("category", "name"),
                          prompt="match? ", max_new=2),
    }


def reference_plan_layer(plans):
    """The plan layer of the reference's ``tools/analyze.py``."""
    from repro.olap import analysis as ANA
    from repro.olap import optimizer as OPT

    diags, detail = [], {}
    for name, plan in plans.items():
        diags.extend(ANA.verify_plan(plan))
        optimized, firings = OPT.optimize(plan, verify=True)
        diags.extend(ANA.verify_plan(optimized))
        detail[name] = {"rules": [f.rule for f in firings],
                        "verified": all(f.verified for f in firings)}
    return diags, detail


def test_plan_layer_equals_the_reference(tool):
    diags, extra = tool.run_plan_layer()
    ref_diags, ref_detail = reference_plan_layer(reference_workloads())
    assert [d.code for d in diags] == [d.code for d in ref_diags] == []
    assert extra["plan_workloads"] == ref_detail
    assert any(d["rules"] for d in ref_detail.values())


def test_planted_plan_finding_is_reported(tool):
    """A workload the verifier must refuse: a filter on a column its
    input does not have (PLAN004), in both packages."""
    from repro.olap import plan as RP
    from repro.olap.table import Table as RTable
    from repro_torch.olap import plan as P
    from repro_torch.olap.table import Table

    cols = {"category": ["a", "b"]}
    bad = P.Filter(input=P.Scan(Table(cols)), pred=lambda r: True, columns=("missing",))
    rbad = RP.Filter(input=RP.Scan(RTable(cols)), pred=lambda r: True, columns=("missing",))
    diags, _ = tool.run_plan_layer({"bad": bad})
    want, _ = reference_plan_layer({"bad": rbad})
    assert [d.code for d in diags] == [d.code for d in want]
    assert [d.message for d in diags] == [d.message for d in want]
    assert "PLAN004" in [d.code for d in want]


def test_committed_baseline_names_every_reason():
    doc = json.loads(BASELINE.read_text())
    for key in list(doc["fingerprints"]) + doc["suppress_codes"]:
        assert doc["suppress_reasons"].get(key), key


def test_main_gates_on_the_baseline(tool, monkeypatch, tmp_path, capsys):
    assert tool.main(["--all", "--device", "cpu", "--format=json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["diagnostics"] == [] and report["plan_workloads"]
    assert "_decode" in report["jit_cache_stats"]

    from repro_torch.serving.engine import Engine
    clean = Engine._decode

    def synced(self, tables, toks, pos):
        int(pos.sum())                           # an injected host sync
        return clean(self, tables, toks, pos)

    monkeypatch.setattr(Engine, "_decode", synced)
    assert tool.main(["--jit", "--device", "cpu", "--format=json"]) == 1
    assert "JIT001" in capsys.readouterr().err
    # accepted into a baseline of its own, the same finding no longer fails
    base = tmp_path / "baseline.json"
    assert tool.main(["--jit", "--device", "cpu", "--baseline", str(base),
                      "--update-baseline"]) == 0
    assert tool.main(["--jit", "--device", "cpu", "--baseline", str(base)]) == 0
    capsys.readouterr()


def test_cuda_without_a_card_raises(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main(["--jit"])
