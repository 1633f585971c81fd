"""Port granite-20b (dense, MQA: many query heads on one KV head, an
ungated GELU MLP, an untied vocab) vs the reference's.

``granite-20b-smoke`` (2 layers, d_model 64, 4 query heads on 1 KV head of
16, d_ff 128) with the byte tokenizer's vocab of 260, and a wide-G variant
of it (48 query heads on the one KV head, the full model's G).  The
reference's params (``jax.random`` init, f32) are bridged into the port and
the same numpy inputs go through both.  Tolerances, relative to the
largest reference value unless said otherwise:

- ``kernels/ref.paged_attention`` at granite's decode shape (8 slots, one
  KV head, G 48, D 128, blocks of 32, ragged lengths 1 to 1024, a prefix
  aliased across slots and the trash block past each length) against the
  reference's plain path, the pool gathered per slot and the model's
  ``_masked_decode``: within 1e-6 in f32 (the same products, summed in
  another order);
- the wide-G variant's paged decode (admission scatter and 8 steps, the
  port's greedy tokens fed to both): logits within 1e-5 of the
  reference's ``paged_decode_step`` and of the port's contiguous
  ``decode_step``, greedy tokens identical;
- the ``Engine`` (paged, f32, base and ``w8-absmax``) serves the
  reference engine's rows;
- ``w8-absmax`` and the grid's ``w8-ffn75`` (GPTQ) after calibrating on
  the same rows: calibration statistics within 1e-5 (``wi`` with no
  ``wg``), ``w8-absmax`` codes equal, ``w8-ffn75`` codes equal on 99.9% of
  entries, scales within 1e-6, the same pruned ``d_ff``, the untied
  unembed quantized, logits within 1e-4 (the other families' bound);
- ``default_recipe_space`` names equal in both packages, with no
  ``w8-kv50`` (one KV head); ``slot_state_bytes`` equal to the
  reference's (26,624 B a position at full width);
- ``Query(...).llm_map(...).run()`` on an f32 session gives the reference
  session's pick and table.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rregistry  # noqa: E402
from repro.core import policy as RPOL  # noqa: E402
from repro.core.pipeline import InstanceOptimizer as RInstanceOptimizer  # noqa: E402
from repro.core.pipeline import Recipe as RRecipe  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models.transformer import _masked_decode  # noqa: E402
from repro.olap import query as RQ  # noqa: E402
from repro.olap.table import Table as RTable  # noqa: E402
from repro.serving.engine import Engine as REngine  # noqa: E402
from repro.serving.scheduler import slot_state_bytes as ref_slot_bytes  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference, registry  # noqa: E402
from repro_torch.core import policy as POL  # noqa: E402
from repro_torch.core.compressed import QTensor  # noqa: E402
from repro_torch.core.pipeline import InstanceOptimizer, Recipe  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.olap import query as Q  # noqa: E402
from repro_torch.olap.table import Table  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.scheduler import slot_state_bytes  # noqa: E402
from repro_torch.training.data import PROMPTS, workload_rows  # noqa: E402

ARCH = "granite-20b"
ROWS = ["Classify: great battery life", "Classify: arrived broken",
        "Classify: ok for the price", "Classify: meh", "Classify: great battery life"]


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _np(t):
    return t.detach().float().numpy()


_MODELS = {}


def _model(heads=4):
    """(reference cfg, reference params, port cfg, port params) of the smoke
    config (f32, vocab 260) with ``heads`` query heads on its one KV head."""
    if heads not in _MODELS:
        rcfg = rregistry.get_reduced(ARCH).replace(param_dtype="float32", vocab_size=260,
                                                   n_heads=heads)
        rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
        _MODELS[heads] = (rcfg, rparams, from_reference(rcfg),
                          bridge.from_reference(rparams, device="cpu"))
    return _MODELS[heads]


def _tokens(B, S, seed, vocab=256):
    return np.random.default_rng(seed).integers(4, vocab, (B, S)).astype(np.int32)


def test_config_matches_reference_and_is_mqa():
    mine, want = registry.get_config(ARCH), rregistry.get_config(ARCH)
    assert dataclasses.asdict(mine) == dataclasses.asdict(from_reference(want))
    assert mine.param_count() == want.param_count() == 20_315_111_424
    assert (mine.n_heads, mine.n_kv_heads, mine.head_dim) == (48, 1, 128)
    assert not mine.mlp_gated and not mine.tie_embeddings
    assert dataclasses.asdict(registry.get_reduced(ARCH)) == dataclasses.asdict(
        from_reference(rregistry.get_reduced(ARCH)))
    # K1 serves granite's decode (G 48) on the tensor cores in bf16
    assert ops.paged_attention_variant(torch.bfloat16, 48) == "mma"
    assert ops.paged_attention_variant(torch.float32, 48) == "chunked"
    # the MQA KV: 52 layers x K and V x one head of 128 in bf16, a position
    assert slot_state_bytes(mine, 1024) == ref_slot_bytes(want, 1024) == 26_624 * 1024


# ---------------------------------------------------------------------------
# K1's plain version at granite's decode shape
# ---------------------------------------------------------------------------

def test_paged_attention_plain_at_g48_matches_reference_plain_path():
    rng = np.random.default_rng(48)
    S, Kh, G, D, bs, nblk = 8, 1, 48, 128, 32, 32
    T = nblk * bs
    lengths = np.array([1, 31, 32, 33, 1024, 95, 96, 700], np.int32)
    trash = S * nblk
    q = rng.normal(size=(S, 1, Kh * G, D)).astype(np.float32)
    kp = rng.normal(size=(trash + 1, bs, Kh, D)).astype(np.float32)
    vp = rng.normal(size=(trash + 1, bs, Kh, D)).astype(np.float32)
    tables = rng.permutation(trash).astype(np.int32).reshape(S, nblk)
    tables[:, :2] = tables[0, :2]                  # one prefix aliased across slots
    used = -(-lengths // bs)
    tables[np.arange(nblk)[None, :] >= used[:, None]] = trash
    got = ref.paged_attention(torch.from_numpy(q[:, 0].reshape(S, Kh, G, D)),
                              torch.from_numpy(kp), torch.from_numpy(vp),
                              torch.from_numpy(tables), torch.from_numpy(lengths))
    k = kp[tables].reshape(S, T, Kh, D)            # the pool gathered per slot
    v = vp[tables].reshape(S, T, Kh, D)
    valid = np.arange(T)[None, :] < lengths[:, None]
    want = _masked_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(valid), 0.0)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert _rel(_np(got).reshape(S, 1, Kh * G, D), np.asarray(want)) < 1e-6


# ---------------------------------------------------------------------------
# the model: paged decode at G 48, the engine
# ---------------------------------------------------------------------------

_BS, _B, _MAX_LEN = 16, 2, 64


def _rows_vmapped(cache):
    """Batched-prefill cache [R, n, T, ...] -> the reference engine's
    vmapped per-row layout [n, R, 1, T, ...]."""
    return {"blocks": [jax.tree.map(lambda a: jnp.moveaxis(a, 1, 0)[:, :, None], e)
                       for e in cache["blocks"]],
            "tail": [jax.tree.map(lambda a: a[:, None], e) for e in cache["tail"]]}


def test_wide_g_paged_decode_matches_reference_and_contiguous():
    """48 query heads on one KV head: admission scatter and 8 paged decode
    steps against the reference's ``paged_insert``/``paged_decode_step``
    and the port's contiguous ``decode_step``, the port's greedy tokens fed
    to all three."""
    rcfg, rparams, cfg, params = _model(48)
    assert cfg.n_heads // cfg.n_kv_heads == 48
    nblk = _MAX_LEN // _BS
    toks = _tokens(_B, 16, 5)
    lens = np.array([5, 9])
    tables = np.random.default_rng(6).permutation(_B * nblk + 2)[:_B * nblk]
    tables = tables.astype(np.int32).reshape(_B, nblk)
    _, rrows = rapi.prefill(rparams, rcfg, {"tokens": jnp.asarray(toks)}, max_len=_MAX_LEN,
                            compact_local=False)
    rstate = rapi.paged_insert(rcfg, rapi.init_paged_cache(rcfg, _B, _B * nblk + 3, _BS),
                               _rows_vmapped(rrows), None, jnp.asarray(tables), block_size=_BS)
    _, rows = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)}, max_len=_MAX_LEN,
                          compact_local=False)
    state = api.init_paged_cache(cfg, _B, tables.size + 3, _BS, device="cpu")
    api.paged_insert(cfg, state, rows, None, tables, block_size=_BS)
    _, contig = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)}, max_len=_MAX_LEN,
                          compact_local=False)
    tok, pos = toks[np.arange(_B), lens - 1], lens.copy()
    step = jax.jit(lambda st, t, p: rapi.paged_decode_step(
        rparams, rcfg, st, jnp.asarray(tables), t, p, block_size=_BS, max_len=_MAX_LEN))
    for _ in range(8):
        with torch.no_grad():
            got, state = api.paged_decode_step(params, cfg, state, torch.from_numpy(tables),
                                               torch.from_numpy(tok[:, None]),
                                               torch.from_numpy(pos), block_size=_BS,
                                               max_len=_MAX_LEN)
            flat, contig = api.decode_step(params, cfg, contig, torch.from_numpy(tok[:, None]),
                                           torch.from_numpy(pos), max_len=_MAX_LEN)
        want, rstate = step(rstate, jnp.asarray(tok[:, None]), jnp.asarray(pos, jnp.int32))
        want = np.asarray(want, np.float32)
        assert _rel(_np(got), want) < 1e-5
        assert _rel(_np(got), _np(flat)) < 1e-5
        assert np.array_equal(_np(got).argmax(-1), want.argmax(-1))
        assert np.array_equal(_np(got).argmax(-1), _np(flat).argmax(-1))
        tok = _np(got)[:, -1].argmax(-1).astype(np.int32)
        pos = pos + 1


@pytest.mark.parametrize("recipe", ["base", "w8-absmax"])
def test_engine_rows_match_reference(recipe):
    rcfg, rparams, cfg, params = _model()
    if recipe != "base":
        rparams, rcfg, _ = RInstanceOptimizer(rparams, rcfg).apply(
            RRecipe(name=recipe, wbits=8, quant_method="absmax"))
        params, cfg, _ = InstanceOptimizer(params, cfg).apply(
            Recipe(name=recipe, wbits=8, quant_method="absmax"))
        assert isinstance(params["unembed"], QTensor)
    kw = dict(slots=4, max_len=128, buckets=(16, 32, 64))
    want = REngine(rparams, rcfg, backend="reference", **kw).generate(ROWS, max_new=8)
    eng = Engine(params, cfg, device="cpu", **kw)
    assert eng._paged
    assert eng.generate(ROWS, max_new=8) == want


# ---------------------------------------------------------------------------
# calibration, recipes, the grid, the session
# ---------------------------------------------------------------------------

def _calibrated():
    rcfg, rparams, cfg, params = _model()
    toks = _tokens(4, 19, seed=1)
    toks[:, 15:] = 0
    ro, po = RInstanceOptimizer(rparams, rcfg), InstanceOptimizer(params, cfg)
    rst = ro.run_calibration({"tokens": jnp.asarray(toks)})
    st = po.run_calibration({"tokens": torch.from_numpy(toks)})
    return rcfg, cfg, ro, po, rst, st


def _walk(a, b, exact, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _walk(a[k], b[k], exact, f"{path}.{k}")
    elif isinstance(b, list):
        for i, (x, y) in enumerate(zip(a, b)):
            _walk(x, y, exact, f"{path}.{i}")
    elif isinstance(b, QTensor):
        assert isinstance(a, QTensor) and a.q.shape == b.q.shape, path
        assert (a.group, a.bits) == (b.group, b.bits), path
        if exact:
            assert torch.equal(a.q, b.q), path
        else:
            assert torch.mean((a.q == b.q).float()) >= 0.999, path
        assert _rel(a.scale, b.scale) < 1e-6, path
    else:
        assert not isinstance(a, QTensor), path
        assert a.dtype == b.dtype and torch.allclose(a, b, rtol=0, atol=1e-6), path


def test_calibration_of_the_ungated_mlp_matches_reference():
    _, _, _, _, rst, st = _calibrated()
    assert set(st.weights) == set(rst.weights)
    assert not any(k.endswith(".wg") for k in st.weights)
    assert any(k.endswith(".wi") for k in st.weights)
    for k, w in rst.weights.items():
        v = st.weights[k]
        assert w.count == v.count and tuple(w.shape) == tuple(v.shape), k
        for f in ("H", "sqnorm", "amax"):
            if getattr(w, f) is None:
                assert getattr(v, f) is None, (k, f)
                continue
            assert _rel(_np(getattr(v, f)), np.asarray(getattr(w, f))) < 1e-5, (k, f)


@pytest.mark.parametrize("name", ["w8-absmax", "w8-ffn75"])
def test_recipe_codes_and_configs_match_reference(name):
    """The grid's ``w8-absmax`` and ``w8-ffn75`` (GPTQ): the untied unembed
    is quantized (a K2 launch on the card), the ungated MLP pruned through
    ``wi`` and ``wo`` alone."""
    rcfg, cfg, ro, po, _, _ = _calibrated()
    grid = {r.name: r for r in POL.default_recipe_space(cfg)}
    rgrid = {r.name: r for r in RPOL.default_recipe_space(rcfg)}
    rq, rcfg2, rrep = ro.apply(rgrid[name])
    q, cfg2, rep = po.apply(grid[name])
    assert dataclasses.asdict(cfg2) == dataclasses.asdict(from_reference(rcfg2))
    assert cfg2.d_ff == (96 if name == "w8-ffn75" else 128)
    _walk(q, bridge.from_reference(rq, device="cpu"), name == "w8-absmax")
    assert isinstance(q["unembed"], QTensor) and "wg" not in q["blocks"][0]["mlp"]
    assert rep.bytes_after == rrep.bytes_after and rep.params_after == rrep.params_after
    toks = _tokens(2, 8, seed=2)
    with torch.no_grad():
        got = _np(api.forward(q, cfg2, {"tokens": torch.from_numpy(toks)})[0])
    want = rapi.forward(rq, rcfg2, {"tokens": jnp.asarray(toks)}, remat=False)[0]
    assert _rel(got, np.asarray(want)) < 1e-4


def test_recipe_space_has_no_kv50_for_one_kv_head():
    for cfg, rcfg in ((registry.get_config(ARCH), rregistry.get_config(ARCH)),
                      (registry.get_reduced(ARCH), rregistry.get_reduced(ARCH))):
        names = [r.name for r in POL.default_recipe_space(cfg)]
        assert names == [r.name for r in RPOL.default_recipe_space(rcfg)]
        assert "w8-kv50" not in names and "w8-ffn75" in names


SESSION_KW = dict(calib_rows=4, eval_rows=2, engine_kw=dict(slots=4, max_len=64,
                                                             buckets=(32, 48)))
SESSION_RECIPES = [dict(name="w8-absmax", wbits=8, quant_method="absmax"),
                   dict(name="w8a-ffn75", ffn_keep_frac=0.75, wbits=8, quant_method="absmax")]


def test_session_llm_map_table_matches_reference():
    """Q1 (``llm_map``) through ``Query.run`` on an f32 session in both
    packages: the same pick and the same table."""
    rcfg, rparams, cfg, params = _model()
    runs = []
    for mod, table_cls, sess in (
            (RQ, RTable, RQ.IOLMSession(rparams, rcfg, objective="acc",
                                        recipes=[RRecipe(**r) for r in SESSION_RECIPES],
                                        **SESSION_KW)),
            (Q, Table, Q.IOLMSession(params, cfg, objective="acc", device="cpu",
                                     recipes=[Recipe(**r) for r in SESSION_RECIPES],
                                     **SESSION_KW))):
        reviews = table_cls({"review": [r.text for r in workload_rows("summarize", 6)]})
        q = mod.Query(reviews, sess).llm_map("review", prompt=PROMPTS["summarize"],
                                             out_col="summary", max_new=6)
        runs.append((q.run(), sess))
    (wt, rsess), (gt, sess) = runs
    (m,), (rm,) = sess.model_cache._d.values(), rsess.model_cache._d.values()
    assert m.recipe.name == rm.recipe.name and m.cfg.d_ff == rm.cfg.d_ff
    assert list(gt.columns) == ["review", "summary"]
    assert gt.columns == wt.columns
