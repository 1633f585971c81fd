"""The port's examples (``examples/torch_*.py``) on the CPU.

Each script's ``main([... "--device", "cpu"])`` runs to its end on a
``tiny-olap`` checkpoint that a module fixture trains for a few steps
into a tmp directory (``torch_common.CKPT_DIR`` pointed there and
``load_model``'s ``min_steps`` lowered to it, so no example trains 300
steps).  The serving examples' recipe search runs a two-recipe grid
(``default_recipe_space`` monkeypatched to ``w8-absmax`` and
``w8-ffn75``) to keep the file under a minute; the card runs the full
grid (``chip_smoke.py``'s ``examples`` phase).  The quickstart is held to
the reference on the same f32 params (bytes equal, token agreement
equal), and ``torch_common``'s constants and helpers to
``benchmarks/common.py`` and ``benchmarks/table1.py``.
"""
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "examples"))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_common as common  # noqa: E402
import torch_multi_tenant  # noqa: E402
import torch_olap_queries  # noqa: E402
import torch_quickstart  # noqa: E402
import torch_serve_compressed  # noqa: E402
import torch_train_lm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.core import policy as POL  # noqa: E402
from repro_torch.training import optimizer as OPT  # noqa: E402
from repro_torch.training import train_loop as TL  # noqa: E402

FEW = 8                     # the fixture checkpoint's steps


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """``tiny-olap`` trained ``FEW`` steps into a tmp directory, which
    ``load_model`` then restores; the grid narrowed to two recipes."""
    d = str(tmp_path_factory.mktemp("torch_tiny_olap_ckpt"))
    TL.train(common.MODEL_CFG,
             TL.TrainConfig(steps=FEW, batch=4, seq_len=48, ckpt_dir=d, ckpt_every=FEW,
                            log_every=FEW),
             OPT.adamw(lr=2e-3, warmup=2, total_steps=FEW), device="cpu", log=lambda s: None)
    grid = POL.default_recipe_space
    mp = pytest.MonkeyPatch()
    mp.setattr(common, "CKPT_DIR", d)
    mp.setattr(common, "load_model", functools.partial(common.load_model, min_steps=FEW))
    mp.setattr(POL, "default_recipe_space",
               lambda cfg, **kw: [r for r in grid(cfg, **kw)
                                  if r.name in ("w8-absmax", "w8-ffn75")])
    yield d
    mp.undo()


def test_load_model_restores_the_port_checkpoint(tiny_ckpt):
    cfg, params, tok = common.load_model(device="cpu")
    assert cfg == common.MODEL_CFG and tok.vocab_size == cfg.vocab_size
    assert params["embed"].shape == (cfg.vocab_size, cfg.d_model)
    assert params["embed"].device.type == "cpu"


def test_train_lm_trains_then_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ckpt")
    argv = ["--device", "cpu", "--ckpt", ck, "--batch", "4", "--seq", "48"]
    first = torch_train_lm.main(["--steps", "6", *argv])
    assert first["losses"][-1][1] < first["losses"][0][1]
    second = torch_train_lm.main(["--steps", "10", *argv])
    out = capsys.readouterr().out
    assert "[train] resumed from step 6" in out
    # log_every 20: the resumed run logs only its last step
    assert [s for s, _ in second["losses"]] == [9] and out.count("done; final loss") == 2


def test_quickstart_runs(capsys):
    results = torch_quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("base model: ")
    assert [rep.recipe.name for rep, _ in results] == ["w8-gptq", "w8+2:4", "w4+ffn75"]
    assert out.count("token-agreement=") == 3
    assert all(0.0 <= res.token_agreement <= 1.0 for _, res in results)


def _reference_quickstart(rparams, rcfg):
    """``examples/quickstart.py``'s loop on the reference: [(bytes after,
    token agreement)] of each recipe."""
    from repro.core import policy as RPOL
    from repro.core.pipeline import InstanceOptimizer, Recipe
    from repro.training.data import PROMPTS, ByteTokenizer, workload_rows
    tok = ByteTokenizer(rcfg.vocab_size)
    prompts = [PROMPTS["correct"] + r.text for r in workload_rows("correct", 16)]
    toks, lens = tok.pad_batch([tok.encode(p, bos=True) for p in prompts], seq_len=64)
    opt = InstanceOptimizer(rparams, rcfg)
    opt.run_calibration({"tokens": jnp.asarray(toks)})
    out = []
    for recipe in (Recipe(name="w8-gptq", wbits=8),
                   Recipe(name="w8+2:4", wbits=8, nm=(2, 4)),
                   Recipe(name="w4+ffn75", wbits=4, group=32, ffn_keep_frac=0.75)):
        p2, c2, rep = opt.apply(recipe)
        eval_fn = RPOL.make_agreement_eval(rparams, rcfg, jnp.asarray(toks), max_new=8,
                                           lengths=jnp.asarray(lens))
        out.append((rep.bytes_after, eval_fn(p2, c2).token_agreement))
    return out


def test_quickstart_matches_the_reference_on_bridged_f32_params():
    """The quickstart's model built by the reference's
    ``api.init_params(PRNGKey(0))`` in f32 and carried across: each
    recipe's bytes equal the reference's exactly, and so does its token
    agreement."""
    from repro.configs.base import ModelConfig as RModelConfig
    from repro.models import api as rapi
    rcfg = RModelConfig(**{f.name: getattr(torch_quickstart.CFG, f.name)
                           for f in dataclasses.fields(RModelConfig)
                           if hasattr(torch_quickstart.CFG, f.name)}
                        ).replace(param_dtype="float32")
    assert from_reference(rcfg) == torch_quickstart.CFG.replace(param_dtype="float32")
    rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
    want = _reference_quickstart(rparams, rcfg)
    lines = []
    got = torch_quickstart.compress_and_score(bridge.from_reference(rparams, device="cpu"),
                                              from_reference(rcfg), "cpu", out=lines.append)
    assert len(lines) == 4 and lines[0].startswith("calibrated on 16 rows")
    assert [(rep.bytes_after, res.token_agreement) for rep, res in got] == want


def test_multi_tenant(tiny_ckpt, capsys):
    session, sched, results = torch_multi_tenant.main(["--device", "cpu", "--rows", "4"])
    out = capsys.readouterr().out
    assert "3 tenants in" in out and "tenant-c matches:" in out
    assert set(results) == {"tenant-a", "tenant-b", "tenant-c"}
    assert len(results["tenant-b"]) == 4 and len(results["tenant-a"]["summary"]) == 4
    assert len(session.pool) == 3 and session.pool.stats.evictions == 0
    assert all(v.endswith(":w8") for v in session.pool.resident_versions)
    assert sched.stats.rows > 0


def test_serve_compressed(tiny_ckpt, capsys):
    outcome, engines = torch_serve_compressed.main(
        ["--device", "cpu", "--rows", "4", "--task", "join"])
    out = capsys.readouterr().out
    assert [c.recipe.name for c in outcome.candidates] == ["w8-absmax", "w8-ffn75"]
    assert "serving 4 rows of 'join':" in out and "Baseline" in out
    for eng in engines.values():
        assert eng.stats.backend == "reference" and eng._paged and eng.stats.rows == 4


def _surviving_values(commits4):
    return {lang for lang, status in zip(commits4["lang"], commits4["status"])
            if status == "ok"}


def test_olap_queries(tiny_ckpt, capsys):
    got = torch_olap_queries.main(["--device", "cpu", "--rows", "4"])
    out = capsys.readouterr().out
    for q in ("Q1 summarize", "Q2 correct", "Q3 fuzzy join", "Q4 EXPLAIN:", "Q4 correct+filter"):
        assert q in out, q
    assert "optimized plan:" in out and "backend=reference" in out
    assert got["invocations"] == len(_surviving_values(got["commits4"]))
    assert len(got["out4"]) == 2
    assert any(line.startswith("[iolm]") for line in got["session"].log)


def test_olap_queries_plan_rules_do_not_change_rows(tiny_ckpt, capsys):
    """For a fixed model (``--no-optimize``) the outputs are the same with
    and without the plan optimizer; with it, Q4 runs once per distinct
    surviving value."""
    on = torch_olap_queries.main(["--device", "cpu", "--rows", "4", "--no-optimize"])
    off = torch_olap_queries.main(["--device", "cpu", "--rows", "4", "--no-optimize",
                                   "--no-plan-rules"])
    capsys.readouterr()
    assert on["out4"].rows() == off["out4"].rows()
    assert on["invocations"] == len(_surviving_values(on["commits4"]))
    assert off["invocations"] >= on["invocations"]
    assert not any(line.startswith("[iolm]") for line in on["session"].log)


def test_helpers_equal_the_benchmarks():
    """``MODEL_CFG``, ``MAX_NEW``, ``make_engine``'s defaults and
    ``task_accuracy`` equal ``benchmarks/common.py``'s and
    ``benchmarks/table1.py``'s."""
    from benchmarks import common as bcommon
    from benchmarks import table1
    from repro.training import data as RD
    assert from_reference(bcommon.MODEL_CFG) == common.MODEL_CFG
    assert common.MAX_NEW == table1.MAX_NEW
    cfg = common.MODEL_CFG.replace(n_layers=1, param_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models import api
    eng = common.make_engine(api.init_params(gen, cfg), cfg, None, device="cpu")
    rcfg = bcommon.MODEL_CFG.replace(n_layers=1, param_dtype="float32")
    from repro.models import api as rapi
    reng = bcommon.make_engine(rapi.init_params(jax.random.PRNGKey(0), rcfg), rcfg, None)
    assert (eng.slots, eng.max_len, eng.buckets) == (reng.slots, reng.max_len, reng.buckets)
    rows = RD.eval_rows("correct", 6)
    rng = np.random.default_rng(0)
    outs = [r.target + " x" if rng.random() < 0.5 else " " + r.target[::-1] for r in rows]
    assert common.task_accuracy(outs, rows) == bcommon.task_accuracy(outs, rows)
