"""Port recipe search (``core/policy.py``) and the contiguous decode step
vs the reference's.

The tiny dense model (tests/conftest.py's shape) in f32, its weights
bridged from the reference's init: the contiguous ``decode_step`` at
per-row positions within 1e-5 of the reference's and equal to the port's
own paged decode on the same KV; ``greedy_decode`` tokens identical on
ragged prompt lengths (base and ``w8-absmax``); the agreement eval's
accuracy and token agreement equal; the default recipe grid's names
equal; ``search`` with the Acc objective picking the same recipe; and
the narrowed catch: a recipe that does not apply is skipped, any other
error propagates.  ``w8-smooth`` stays out of the cross-framework
comparisons (the reference's jnp path applies ``in_scale`` twice,
ROADMAP reference caveats).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rregistry  # noqa: E402
from repro.configs.base import ModelConfig as RConfig  # noqa: E402
from repro.core import policy as RPOL  # noqa: E402
from repro.core.pipeline import InstanceOptimizer as RInstanceOptimizer  # noqa: E402
from repro.core.pipeline import Recipe as RRecipe  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.configs import gemma2_2b  # noqa: E402
from repro_torch.core import policy as POL  # noqa: E402
from repro_torch.core.pipeline import InstanceOptimizer, Recipe  # noqa: E402
from repro_torch.models import api  # noqa: E402

W8 = dict(name="w8-absmax", wbits=8, quant_method="absmax")
W4 = dict(name="w4-g32", wbits=4, group=32, quant_method="absmax")


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.fixture(scope="module")
def tiny():
    rcfg = RConfig(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, d_ff=128, vocab_size=260, max_seq=256,
                   param_dtype="float32")
    rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, rparams, from_reference(rcfg), bridge.from_reference(rparams, device="cpu")


@pytest.fixture(scope="module")
def prompts():
    """Right-padded prompts of ragged lengths, and the lengths."""
    rng = np.random.default_rng(3)
    lens = np.array([12, 7, 16, 3], np.int32)
    toks = np.zeros((4, 16), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(4, 260, n)
    return toks, lens


@pytest.fixture(scope="module")
def w8(tiny):
    """Both sides' w8-absmax instances of the tiny model."""
    rcfg, rparams, cfg, params = tiny
    rq, _, _ = RInstanceOptimizer(rparams, rcfg).apply(RRecipe(**W8))
    pq, _, _ = InstanceOptimizer(params, cfg).apply(Recipe(**W8))
    return rq, pq


def test_contiguous_decode_step_matches_reference_and_paged(tiny, prompts):
    rcfg, rparams, cfg, params = tiny
    toks, lens = prompts
    max_len = 32
    _, rcache = rapi.prefill(rparams, rcfg, {"tokens": jnp.asarray(toks)},
                             max_len=max_len, compact_local=False)
    with torch.no_grad():
        _, cache = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                               max_len=max_len, compact_local=False)
    nxt = np.array([[5], [77], [130], [259]], np.int32)
    pos = lens.copy()
    for step in range(3):
        want, rcache = rapi.decode_step(rparams, rcfg, rcache, jnp.asarray(nxt),
                                        jnp.asarray(pos + step), max_len=max_len)
        with torch.no_grad():
            got, cache = api.decode_step(params, cfg, cache, torch.from_numpy(nxt),
                                         torch.from_numpy(pos + step), max_len=max_len)
        assert got.shape == (4, 1, cfg.vocab_size)
        assert _rel(got.numpy(), want) < 1e-5
        for g, w in zip(cache["blocks"], rcache["blocks"]):
            assert _rel(g["k"].numpy(), w["k"]) < 1e-5
    # the port's paged decode on the same KV gives the same logits
    with torch.no_grad():
        _, rows = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                              max_len=max_len, compact_local=False)
        _, contig = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                                max_len=max_len, compact_local=False)
        bs, nblk = 8, max_len // 8
        state = api.init_paged_cache(cfg, 4, 4 * nblk + 1, bs, device="cpu")
        tables = torch.arange(4 * nblk, dtype=torch.int32).reshape(4, nblk).flip(0)
        state = api.paged_insert(cfg, state, rows, np.arange(4), tables.numpy(),
                                 block_size=bs)
        p_log, _ = api.paged_decode_step(params, cfg, state, tables, torch.from_numpy(nxt),
                                         torch.from_numpy(pos).long(), block_size=bs,
                                         max_len=max_len)
        c_log, _ = api.decode_step(params, cfg, contig, torch.from_numpy(nxt),
                                   torch.from_numpy(pos), max_len=max_len)
    assert torch.equal(p_log, c_log)


def test_init_cache_matches_prefill_layout(tiny):
    """The serving layout's absolute slots; the tiny model has no local
    layer, so its compact cache (the default) is the same tree, as the
    reference's."""
    rcfg, _, cfg, _ = tiny
    cache = api.init_cache(cfg, 3, 24, compact_local=False, device="cpu")
    assert cache["blocks"][0]["k"].shape == (2, 3, 24, cfg.n_kv_heads, cfg.resolved_head_dim)
    compact = api.init_cache(cfg, 3, 24, device="cpu")
    want = jax.eval_shape(lambda: rapi.init_cache(rcfg, 3, 24))
    assert [tuple(t.shape) for t in jax.tree_util.tree_leaves(want)] == \
        [tuple(c[n].shape) for c in compact["blocks"] for n in ("k", "v")] == \
        [tuple(c[n].shape) for c in cache["blocks"] for n in ("k", "v")]


@pytest.mark.parametrize("which", ["base", "w8"])
def test_greedy_decode_identical_on_ragged_lengths(tiny, prompts, w8, which):
    rcfg, rparams, cfg, params = tiny
    if which == "w8":
        rparams, params = w8
    toks, lens = prompts
    want = RPOL.greedy_decode(rparams, rcfg, jnp.asarray(toks), 10, lengths=jnp.asarray(lens))
    got = POL.greedy_decode(params, cfg, torch.from_numpy(toks), 10,
                            lengths=torch.from_numpy(lens))
    assert got.shape == (4, 10) and got.dtype == np.int32
    assert np.array_equal(got, want)


def test_agreement_eval_matches_reference(tiny, prompts, w8):
    rcfg, rparams, cfg, params = tiny
    toks, lens = prompts
    rq, pq = w8
    want = RPOL.make_agreement_eval(rparams, rcfg, jnp.asarray(toks), max_new=8,
                                    lengths=jnp.asarray(lens))(rq, rcfg)
    got = POL.make_agreement_eval(params, cfg, torch.from_numpy(toks), max_new=8,
                                  lengths=torch.from_numpy(lens))(pq, cfg)
    assert (got.accuracy, got.token_agreement) == (want.accuracy, want.token_agreement)
    assert got.bytes == want.bytes and got.cost_proxy == want.cost_proxy
    assert got.rows_per_s > 0


@pytest.mark.parametrize("model", ["tiny", "gemma2"])
def test_default_recipe_space_names_match(tiny, model):
    rcfg = tiny[0] if model == "tiny" else rregistry.get_reduced("gemma2-2b")
    want = [r.name for r in RPOL.default_recipe_space(rcfg)]
    got = [r.name for r in POL.default_recipe_space(from_reference(rcfg))]
    assert got == want
    assert "w8-ffn75" in got and "w8-kv50" in got
    full = POL.default_recipe_space(gemma2_2b.CONFIG)
    assert [r.name for r in full] == want
    assert [r.describe() for r in POL.default_recipe_space(from_reference(rcfg))] \
        == [r.describe() for r in RPOL.default_recipe_space(rcfg)]


def test_search_acc_objective_picks_same_recipe(tiny, prompts):
    rcfg, rparams, cfg, params = tiny
    toks, lens = prompts
    sample = np.random.default_rng(5).integers(4, 260, (4, 24)).astype(np.int32)
    ropt = RInstanceOptimizer(rparams, rcfg)
    ropt.run_calibration({"tokens": jnp.asarray(sample)})
    want = RPOL.search(ropt, RPOL.make_agreement_eval(rparams, rcfg, jnp.asarray(toks),
                                                      max_new=8, lengths=jnp.asarray(lens)),
                       [RRecipe(**W8), RRecipe(**W4)])
    opt = InstanceOptimizer(params, cfg)
    opt.run_calibration({"tokens": torch.from_numpy(sample)})
    got = POL.search(opt, POL.make_agreement_eval(params, cfg, torch.from_numpy(toks),
                                                  max_new=8, lengths=torch.from_numpy(lens)),
                     [Recipe(**W8), Recipe(**W4)], keep_params=True)
    assert [c.recipe.name for c in got.candidates] == [c.recipe.name for c in want.candidates]
    assert got.acc.recipe.name == want.acc.recipe.name
    for g, w in zip(got.candidates, want.candidates):
        assert (g.result.accuracy, g.result.token_agreement) \
            == (w.result.accuracy, w.result.token_agreement)
        assert g.params is not None and g.cfg == cfg
    assert got.baseline.accuracy == 1.0
    assert "<- Acc" in got.table() and len(got.table().splitlines()) == 4


class _FakeOptimizer:
    params, cfg = "base", "cfg"

    def __init__(self, fail):
        self.fail = fail

    def apply(self, recipe):
        if recipe.name in self.fail:
            raise self.fail[recipe.name]
        return f"p-{recipe.name}", self.cfg, None


def _fake_eval(params, cfg):
    return POL.EvalResult(accuracy=1.0, token_agreement=1.0, rows_per_s=1.0,
                          bytes=len(params), cost_proxy=0.0)


def test_search_skips_inapplicable_recipes_only():
    recipes = [Recipe(name=n) for n in ("a", "b", "c")]
    opt = _FakeOptimizer({"a": NotImplementedError("moe only"), "b": ValueError("keep")})
    out = POL.search(opt, _fake_eval, recipes)
    assert [c.recipe.name for c in out.candidates] == ["c"]
    assert out.perf.recipe.name == out.acc.recipe.name == "c"
    opt = _FakeOptimizer({"b": RuntimeError("kernel failed to launch")})
    with pytest.raises(RuntimeError, match="kernel failed"):
        POL.search(opt, _fake_eval, recipes)

    def broken_eval(params, cfg):
        if params == "p-c":
            raise ValueError("a wrapper refused a shape")
        return _fake_eval(params, cfg)
    with pytest.raises(ValueError, match="wrapper"):
        POL.search(_FakeOptimizer({}), broken_eval, recipes)
