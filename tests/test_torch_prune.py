"""Port structural pruning and pipeline stage 1 vs the reference's
``core/prune.py`` and ``core/pipeline.py``.

Both sides calibrate the same f32 model (the tiny dense model of
tests/conftest.py, and reduced gemma2 with its window and post-norms),
its weights bridged from the reference's init, on the same numpy tokens.
``prune_kv_groups``, ``prune_ffn`` and ``drop_layers`` must keep the same
members: pruned leaves within 1e-6 (the same values selected), an equal
config, and the re-sliced statistics within the calibration tolerance
(1e-5).  ``InstanceOptimizer.apply`` of the grid's ``w8-ffn75`` and
``w8-kv50`` (GPTQ) and of ``drop_units=1`` must give the reference's
codes (on at least 99.9% of entries) and scales (1e-6), as
tests/test_torch_pipeline.py holds GPTQ; ``experts_keep`` on a dense
model is a no-op on both sides.  ``quant_embed`` gives the reference's
int8 table and report.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rregistry  # noqa: E402
from repro.configs.base import ModelConfig as RConfig  # noqa: E402
from repro.core import prune as RP  # noqa: E402
from repro.core.pipeline import InstanceOptimizer as RInstanceOptimizer  # noqa: E402
from repro.core.pipeline import Recipe as RRecipe  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.core import prune as P  # noqa: E402
from repro_torch.core.compressed import QEmbed, QTensor  # noqa: E402
from repro_torch.core.pipeline import InstanceOptimizer, Recipe  # noqa: E402

MODELS = ["tiny", "gemma2"]


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = got.double().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}.{i}")
    else:
        yield path, tree


_MODELS = {}


def _model(name):
    """(rcfg, rparams, ropt, cfg, params, opt): each side's optimizer
    calibrated on the same tokens."""
    if name not in _MODELS:
        if name == "tiny":
            rcfg = RConfig(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                           n_kv_heads=2, d_ff=128, vocab_size=260, max_seq=256)
        else:
            rcfg = rregistry.get_reduced("gemma2-2b").replace(window_size=8)
        rcfg = rcfg.replace(param_dtype="float32")
        rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
        cfg, params = from_reference(rcfg), bridge.from_reference(rparams, device="cpu")
        toks = np.random.default_rng(0).integers(4, rcfg.vocab_size, (4, 32)).astype(np.int32)
        toks[:, 26:] = 0
        ropt = RInstanceOptimizer(rparams, rcfg)
        ropt.run_calibration({"tokens": jnp.asarray(toks)})
        opt = InstanceOptimizer(params, cfg)
        opt.run_calibration({"tokens": torch.from_numpy(toks)})
        _MODELS[name] = (rcfg, rparams, ropt, cfg, params, opt)
    return _MODELS[name]


def _assert_same(got_params, got_cfg, got_stats, want_params, want_cfg, want_stats):
    assert got_cfg == from_reference(want_cfg)
    want = dict(_leaves(bridge.from_reference(want_params, device="cpu")))
    got = dict(_leaves(got_params))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        assert _rel(got[path], w) < 1e-6, path
    assert sorted(got_stats.weights) == sorted(want_stats.weights)
    for key, w in want_stats.weights.items():
        g = got_stats.weights[key]
        assert g.shape == w.shape and g.count == w.count, key
        for field in ("H", "sqnorm", "amax"):
            assert _rel(getattr(g, field), getattr(w, field)) < 1e-5, (key, field)
    assert got_stats.block_sim.keys() == want_stats.block_sim.keys()


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("keep", [1, 2])
def test_prune_kv_groups_matches_reference(model, keep):
    rcfg, rparams, ropt, cfg, params, opt = _model(model)
    want = RP.prune_kv_groups(rparams, rcfg, ropt.stats, keep)
    got = P.prune_kv_groups(params, cfg, opt.stats, keep)
    _assert_same(*got, *want)
    assert got[1].n_kv_heads == keep and got[1].resolved_head_dim == cfg.resolved_head_dim


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("frac", [0.75, 0.5])
def test_prune_ffn_matches_reference(model, frac):
    rcfg, rparams, ropt, cfg, params, opt = _model(model)
    want = RP.prune_ffn(rparams, rcfg, ropt.stats, frac)
    got = P.prune_ffn(params, cfg, opt.stats, frac)
    _assert_same(*got, *want)
    assert got[1].d_ff == int(round(frac * cfg.d_ff)) // 8 * 8


@pytest.mark.parametrize("model", MODELS)
def test_drop_layers_matches_reference(model):
    rcfg, rparams, ropt, cfg, params, opt = _model(model)
    want = RP.drop_layers(rparams, rcfg, ropt.stats, 1)
    got = P.drop_layers(params, cfg, opt.stats, 1)
    _assert_same(*got, *want)
    assert got[1].n_layers < cfg.n_layers


def test_stage1_is_identity_at_full_keep():
    _, _, _, cfg, params, opt = _model("tiny")
    for fn, arg in ((P.prune_kv_groups, cfg.n_kv_heads), (P.prune_ffn, 1.0),
                    (P.drop_layers, 0)):
        p2, cfg2, st2 = fn(params, cfg, opt.stats, arg)
        assert p2 is params and cfg2 is cfg and st2 is opt.stats
    with pytest.raises(ValueError):
        P.prune_kv_groups(params, cfg, opt.stats, cfg.n_kv_heads + 1)
    # expert pruning leaves a dense model as it is (as the reference's);
    # a family neither package knows raises
    p2, cfg2, st2 = P.prune_experts(params, cfg, opt.stats, 1)
    assert p2 is params and cfg2 is cfg and st2 is opt.stats
    with pytest.raises(ValueError, match="nonesuch"):
        P.prune_kv_groups(params, cfg.replace(family="nonesuch"), opt.stats, 1)


STAGE1 = {
    "w8-ffn75": dict(wbits=8, ffn_keep_frac=0.75),
    "w8-kv50": dict(wbits=8, kv_keep_frac=0.5),
    "w8-drop1": dict(wbits=8, drop_units=1),
}


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("name", list(STAGE1))
def test_apply_structural_recipe_matches_reference(model, name):
    rcfg, rparams, ropt, cfg, params, opt = _model(model)
    rq, rcfg2, rrep = ropt.apply(RRecipe(name=name, **STAGE1[name]))
    pq, cfg2, prep = opt.apply(Recipe(name=name, **STAGE1[name]))
    assert cfg2 == from_reference(rcfg2) and prep.cfg_after == cfg2
    assert cfg2 != cfg
    want = dict(_leaves(bridge.from_reference(rq, device="cpu")))
    got = dict(_leaves(pq))
    assert sorted(got) == sorted(want)
    n_q = 0
    for path, w in want.items():
        g = got[path]
        assert type(g) is type(w), path
        if isinstance(w, QTensor):
            n_q += 1
            assert (g.bits, g.group, g.shape) == (w.bits, w.group, w.shape), path
            assert g.q.shape == w.q.shape, path
            assert torch.mean((g.q == w.q).float()) >= 0.999, path
            assert _rel(g.scale, w.scale) < 1e-6, path
        else:
            assert g.shape == w.shape and _rel(g, w) < 1e-6, path
    assert n_q >= 7
    assert prep.bytes_after == rrep.bytes_after
    assert prep.params_after == rrep.params_after
    assert [e["kind"] for e in prep.per_weight] == [e["kind"] for e in rrep.per_weight]


def test_experts_keep_is_a_noop_on_dense():
    rcfg, rparams, ropt, cfg, params, opt = _model("tiny")
    kw = dict(wbits=8, quant_method="absmax")
    rq, rcfg2, _ = ropt.apply(RRecipe(name="e", experts_keep=1, **kw))
    rq0, _, _ = ropt.apply(RRecipe(name="w8", **kw))
    pq, cfg2, _ = opt.apply(Recipe(name="e", experts_keep=1, **kw))
    pq0, _, _ = opt.apply(Recipe(name="w8", **kw))
    assert rcfg2 == rcfg and cfg2 == cfg
    base = dict(_leaves(pq0))
    want = dict(_leaves(bridge.from_reference(rq, device="cpu")))
    want0 = dict(_leaves(bridge.from_reference(rq0, device="cpu")))
    for path, g in _leaves(pq):
        for other in (base[path], want[path], want0[path]):
            assert type(g) is type(other), path
            if isinstance(g, QTensor):
                assert torch.equal(g.q, other.q) and torch.equal(g.scale, other.scale), path
            else:
                assert torch.equal(g, other), path


def test_quant_embed_gives_reference_table_and_report():
    """``quant_embed`` after the prunes: the reference's int8 table (codes
    equal, scales within 1e-6) and its report's bytes and param counts."""
    _, _, ropt, _, _, opt = _model("tiny")
    kw = dict(name="qe", wbits=8, quant_method="absmax", ffn_keep_frac=0.5, quant_embed=True)
    rq, _, rrep = ropt.apply(RRecipe(**kw))
    pq, _, rep = opt.apply(Recipe(**kw))
    assert isinstance(pq["embed"], QEmbed)
    assert torch.equal(pq["embed"].q, torch.from_numpy(np.array(rq["embed"].q)))
    assert _rel(pq["embed"].scale, rq["embed"].scale) < 1e-6
    assert (rep.bytes_before, rep.bytes_after, rep.params_before, rep.params_after) == \
        (rrep.bytes_before, rrep.bytes_after, rrep.params_before, rrep.params_after)


def test_calibrate_without_head_matches_reference():
    from repro.core import calibrate as RC
    from repro_torch.core import calibrate as C
    rcfg, rparams, _, cfg, params, _ = _model("tiny")
    toks = np.random.default_rng(1).integers(4, 260, (2, 16)).astype(np.int32)
    want = RC.calibrate(rparams, rcfg, {"tokens": jnp.asarray(toks)}, include_head=False)
    got = C.calibrate(params, cfg, {"tokens": torch.from_numpy(toks)}, include_head=False)
    assert sorted(got.weights) == sorted(want.weights)
    assert "unembed" not in got.weights and len(got.weights) == 2 * 7
    assert "unembed" in C.calibrate(params, cfg, {"tokens": torch.from_numpy(toks)}).weights
    for key, w in want.weights.items():
        assert _rel(got.weights[key].H, w.H) < 1e-5, key
