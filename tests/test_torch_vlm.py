"""Port vlm family (paligemma: a dense decoder after image embeddings) vs
the reference's.

``paligemma-3b-smoke`` (2 layers, d_model 64, 4 query heads on 1 KV head
of 16, d_ff 128, 8 image tokens) with the byte tokenizer's vocab of 260.
The reference's params (``jax.random`` init, f32 unless said otherwise)
are bridged into the port and the same numpy inputs (``img_embs`` drawn
as ``tests/conftest.py`` draws them, N(0, 0.1^2)) go through both.
Tolerances, relative to the largest reference value:

- ``forward``, ``prefill`` + three ``decode_step``s with ``img_embs``
  (f32): logits within 1e-4, greedy tokens identical; bf16 ``forward``
  within 2e-2 of the reference's bf16 logits (RMS of the difference over
  their RMS) and no further from the f32 logits than twice the
  reference's own bf16, its argmax agreement with f32 printed;
- ``loss_fn`` with and without ``xent_chunk`` (the loss on the text
  positions only): within 1e-5;
- the ``Engine`` with ``extra_inputs={"img_embs": ...}`` serves rows equal
  to ``forward``'s greedy tokens on the image-prefixed sequence, at two
  buckets with slot reuse; the reference engine does not (it reads the
  first token at an image position and decodes inside the image's KV):
  on ROADMAP's input its first tokens are 105 and 61, the port's 190 and
  3;
- ``calibrate`` with ``img_embs``: statistics within 1e-5, block
  similarities within 1e-6, ``n_tokens`` counting the image positions;
  ``prune_kv_groups`` (one KV head: nothing to prune), ``prune_ffn`` and
  ``drop_layers``: the same kept channels and layers, shapes and re-keyed
  statistics; ``w8-absmax`` codes equal and ``w8-ffn75`` (the grid's
  GPTQ) codes equal on 99.9% of entries, scales within 1e-6, the same
  configs;
- Q2 (``llm_correct``) on an f32 session, text only as in the reference,
  gives the reference session's table; ``slot_state_bytes`` equals the
  reference's (18,874,368 B a slot for full-width paligemma-3b at
  ``max_len`` 1024).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rregistry  # noqa: E402
from repro.core import calibrate as RC  # noqa: E402
from repro.core import policy as RPOL  # noqa: E402
from repro.core import prune as RP  # noqa: E402
from repro.core.pipeline import InstanceOptimizer as RInstanceOptimizer  # noqa: E402
from repro.core.pipeline import Recipe as RRecipe  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.olap import query as RQ  # noqa: E402
from repro.olap.table import Table as RTable  # noqa: E402
from repro.serving.engine import Engine as REngine  # noqa: E402
from repro.serving.scheduler import slot_state_bytes as ref_slot_bytes  # noqa: E402
from repro.training import data as RD  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference, registry  # noqa: E402
from repro_torch.core import policy as POL  # noqa: E402
from repro_torch.core import prune as P  # noqa: E402
from repro_torch.core.compressed import QTensor  # noqa: E402
from repro_torch.core.pipeline import InstanceOptimizer, Recipe  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.olap import query as Q  # noqa: E402
from repro_torch.olap.table import Table  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.scheduler import slot_state_bytes  # noqa: E402
from repro_torch.training.data import ByteTokenizer  # noqa: E402

ARCH = "paligemma-3b"
ROWS = ["describe: a cat", "describe: the red car", "describe: two dogs on grass",
        "describe: a cat", "describe: a street at night", "describe: a blue cup",
        "describe: mountains"]


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _np(t):
    return t.detach().float().numpy()


_MODELS = {}


def _model(dtype="float32"):
    """(reference cfg, reference params, port cfg, port params) of the
    smoke config with vocab 260; a bf16 model is the f32 init cast."""
    if dtype not in _MODELS:
        rcfg = rregistry.get_reduced(ARCH).replace(param_dtype=dtype, vocab_size=260)
        rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg.replace(param_dtype="float32"))
        rparams = jax.tree.map(lambda a: a.astype(dtype), rparams)
        _MODELS[dtype] = (rcfg, rparams, from_reference(rcfg),
                          bridge.from_reference(rparams, device="cpu"))
    return _MODELS[dtype]


def _tokens(B, S, seed, vocab=256):
    return np.random.default_rng(seed).integers(4, vocab, (B, S)).astype(np.int32)


def _img(B, seed, n=8, d=64):
    return (np.random.default_rng(seed).standard_normal((B, n, d)) * 0.1).astype(np.float32)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}.{i}")
    else:
        yield path, tree


def test_config_dispatch_and_slot_bytes_match_reference():
    for mine, ref in ((registry.get_config(ARCH), rregistry.get_config(ARCH)),
                      (registry.get_reduced(ARCH), rregistry.get_reduced(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(from_reference(ref))
    full = registry.get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.d_ff, full.vocab_size, full.n_img_tokens) == (18, 2048, 8, 1, 256, 16384,
                                                               257216, 256)
    # published widths: the param count of the reference's init
    shapes = jax.eval_shape(lambda k: rapi.init_params(k, rregistry.get_config(ARCH)),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) == 2_508_662_784
    # the port's init gives the reference's tree: leaf paths, shapes, dtypes
    rcfg, rparams, cfg, params = _model()
    mine = api.init_params(torch.Generator().manual_seed(0), cfg)
    assert [(k, tuple(t.shape), t.dtype) for k, t in _leaves(mine)] == \
        [(k, tuple(t.shape), t.dtype) for k, t in _leaves(params)]
    assert api.family_module(full) is transformer
    assert not api.supports_prefix(full) and not api.supports_paged(full)
    assert api.supports_prefix(full) == rapi.supports_prefix(full)
    assert api.supports_paged(full) == rapi.supports_paged(full)
    assert slot_state_bytes(full, 1024) == ref_slot_bytes(rregistry.get_config(ARCH),
                                                          1024) == 18_874_368
    assert slot_state_bytes(cfg, 96) == ref_slot_bytes(rcfg, 96)
    # one KV head: the grid has no w8-kv50, in both packages
    assert sorted(r.name for r in POL.default_recipe_space(full)) == \
        sorted(r.name for r in RPOL.default_recipe_space(rregistry.get_config(ARCH)))
    assert "w8-kv50" not in {r.name for r in POL.default_recipe_space(full)}


def test_forward_prefill_and_decode_match_reference():
    rcfg, rparams, cfg, params = _model()
    toks, img = _tokens(3, 21, seed=1), _img(3, seed=2)
    lens = np.array([21, 12, 5])
    rb = {"tokens": jnp.asarray(toks), "img_embs": jnp.asarray(img)}
    pb = {"tokens": torch.from_numpy(toks), "img_embs": torch.from_numpy(img)}
    rl, _ = rapi.forward(rparams, rcfg, rb, remat=False)
    with torch.no_grad():
        pl, _ = api.forward(params, cfg, pb)
    assert pl.shape == (3, 8 + 21, 260)
    assert _rel(_np(pl), np.asarray(rl)) < 1e-4
    assert np.array_equal(_np(pl).argmax(-1), np.asarray(rl).argmax(-1))
    # the image embeddings change every text position's logits
    with torch.no_grad():
        plain, _ = api.forward(params, cfg, {"tokens": pb["tokens"]})
    assert _rel(_np(plain), _np(pl[:, 8:])) > 1e-3
    max_len = 48
    rlog, rcache = rapi.prefill(rparams, rcfg, rb, max_len=max_len, compact_local=False)
    with torch.no_grad():
        plog, cache = api.prefill(params, cfg, pb, max_len=max_len, compact_local=False)
    assert _rel(_np(plog), np.asarray(rlog)) < 1e-4
    # each row's first token at its last text position, after the image
    last = 8 + lens - 1
    tok = np.asarray(rlog)[np.arange(3), last].argmax(-1)[:, None].astype(np.int32)
    assert np.array_equal(_np(plog)[np.arange(3), last].argmax(-1)[:, None], tok)
    pos = 8 + lens
    for _ in range(3):
        rlog, rcache = rapi.decode_step(rparams, rcfg, rcache, jnp.asarray(tok),
                                        jnp.asarray(pos), max_len=max_len)
        with torch.no_grad():
            plog, cache = api.decode_step(params, cfg, cache, torch.from_numpy(tok).long(),
                                          torch.from_numpy(pos), max_len=max_len)
        assert _rel(_np(plog), np.asarray(rlog)) < 1e-4
        tok = np.asarray(rlog)[:, -1].argmax(-1)[:, None].astype(np.int32)
        assert np.array_equal(_np(plog)[:, -1].argmax(-1)[:, None], tok)
        pos = pos + 1


def test_bf16_forward_within_bound():
    rcfg32, rparams32, _, _ = _model()
    rcfg, rparams, cfg, params = _model("bfloat16")
    toks, img = _tokens(2, 24, seed=5), _img(2, seed=6)
    rb = {"tokens": jnp.asarray(toks), "img_embs": jnp.asarray(img)}
    want = np.asarray(rapi.forward(rparams32, rcfg32, rb, remat=False)[0])
    ref16 = np.asarray(rapi.forward(rparams, rcfg, rb, remat=False)[0], np.float32)
    with torch.no_grad():
        got = _np(api.forward(params, cfg, {"tokens": torch.from_numpy(toks),
                                             "img_embs": torch.from_numpy(img)})[0])
    err, ref_err = _rel(got, want), _rel(ref16, want)
    rms = float(np.sqrt(((got - ref16) ** 2).mean() / (ref16 ** 2).mean()))
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    ref_agree = float(np.mean(ref16.argmax(-1) == want.argmax(-1)))
    print(f"bf16 forward: RMS rel difference from the reference's bf16 {rms:.3e}; max rel "
          f"err from f32 {err:.3e} (reference's bf16 {ref_err:.3e}); argmax agreement with "
          f"f32 {agree:.3f} (reference's bf16 {ref_agree:.3f})")
    assert np.isfinite(got).all() and rms < 2e-2 and err <= 2 * ref_err


@pytest.mark.parametrize("xent_chunk", [0, 4])
def test_loss_on_text_positions_matches_reference(xent_chunk):
    rcfg, rparams, cfg, params = _model()
    toks, labels, img = _tokens(2, 16, seed=7), _tokens(2, 16, seed=8), _img(2, seed=9)
    want = float(rapi.loss_fn(rparams, rcfg, {"tokens": jnp.asarray(toks),
                                              "labels": jnp.asarray(labels),
                                              "img_embs": jnp.asarray(img)},
                              xent_chunk=xent_chunk))
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
             "img_embs": torch.from_numpy(img)}
    with torch.no_grad():
        got = float(api.loss_fn(params, cfg, batch, xent_chunk=xent_chunk))
    assert abs(got - want) < 1e-5 * abs(want)
    # the loss reads the text positions only: the image changes it through
    # attention, not by adding positions
    with torch.no_grad():
        text_only = float(api.loss_fn(params, cfg, {k: batch[k] for k in ("tokens", "labels")},
                                      xent_chunk=xent_chunk))
    assert abs(text_only - got) > 1e-4


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _greedy_forward(params, cfg, ids, img, max_new, tok):
    """``forward``'s greedy tokens on the image-prefixed sequence, the
    whole sequence recomputed every step, stopping at EOS."""
    out = []
    for _ in range(max_new):
        with torch.no_grad():
            lg, _ = api.forward(params, cfg, {"tokens": torch.tensor([ids + out]),
                                              "img_embs": img[None]})
        out.append(int(lg[0, -1].argmax()))
        if out[-1] == tok.EOS:
            break
    return out


def test_engine_rows_equal_forward_greedy_on_image_prefixed_sequence():
    """Two buckets (16 and 32) and two slots for seven rows (one
    duplicate): slots are reused, every row equals ``forward``'s greedy
    tokens with the image ahead of it."""
    _, _, cfg, params = _model()
    img = torch.from_numpy(_img(1, seed=3)[0])
    tok = ByteTokenizer(260)
    eng = Engine(params, cfg, slots=2, max_len=64, buckets=(16, 32), device="cpu",
                 extra_inputs={"img_embs": img})
    assert not eng._paged and eng.prefix_cache is None
    reqs = eng.generate(ROWS, max_new=6, return_requests=True)
    assert eng.stats.prefills >= 3 and eng.stats.truncated == 0 and eng.stats.cache_hits == 1
    for text, r in zip(ROWS, reqs):
        ids = tok.encode(text, bos=True) + [tok.SEP]
        assert r.out_ids == _greedy_forward(params, cfg, ids, img, 6, tok), text
    # an image with no room left to decode under max_len is refused
    with pytest.raises(ValueError, match="no room to decode"):
        Engine(params, cfg, slots=2, max_len=40, buckets=(32,), device="cpu",
               extra_inputs={"img_embs": img})


def test_reference_engine_reads_image_positions_port_does_not():
    """ROADMAP queue 3's input: the reference engine's first tokens are
    ``forward``'s argmax at positions 16 and 32 (image-prefixed), 105 and
    61; the last text positions give 190 and 3, the port's."""
    rcfg, rparams, cfg, params = _model()
    img = jax.random.normal(jax.random.PRNGKey(3), (8, 64))
    texts = ["describe: a cat", "describe: the red car on a road"]
    kw = dict(slots=2, max_len=96, buckets=(32,))
    ref = REngine(rparams, rcfg, extra_inputs={"img_embs": img}, backend="reference",
                  kv_layout="contiguous", **kw)
    rreqs = [ref.submit(t, max_new=2) for t in texts]
    ref.drain()
    eng = Engine(params, cfg, extra_inputs={"img_embs": np.asarray(img)}, device="cpu", **kw)
    reqs = eng.generate(texts, max_new=2, return_requests=True)
    assert [r.out_ids[0] for r in rreqs] == [105, 61]
    assert [r.out_ids[0] for r in reqs] == [190, 3]


# ---------------------------------------------------------------------------
# calibration, pruning, recipes
# ---------------------------------------------------------------------------

def _stats_equal(rst, st):
    assert set(rst.weights) == set(st.weights)
    for k, w in rst.weights.items():
        v = st.weights[k]
        assert w.count == v.count and tuple(w.shape) == tuple(v.shape), k
        for f in ("H", "sqnorm", "amax"):
            if getattr(w, f) is None:
                assert getattr(v, f) is None, (k, f)
                continue
            assert _rel(_np(getattr(v, f)), np.asarray(getattr(w, f))) < 1e-5, (k, f)
    assert set(rst.block_sim) == set(st.block_sim)
    assert max(abs(rst.block_sim[k] - st.block_sim[k]) for k in rst.block_sim) < 1e-6


def _calibrated():
    rcfg, rparams, cfg, params = _model()
    toks, img = _tokens(4, 19, seed=1), _img(4, seed=4)
    toks[:, 15:] = 0
    ro, po = RInstanceOptimizer(rparams, rcfg), InstanceOptimizer(params, cfg)
    rst = ro.run_calibration({"tokens": jnp.asarray(toks), "img_embs": jnp.asarray(img)})
    st = po.run_calibration({"tokens": torch.from_numpy(toks),
                             "img_embs": torch.from_numpy(img)})
    return rcfg, rparams, cfg, params, ro, po, rst, st, toks


def test_calibrate_and_prune_match_reference():
    rcfg, rparams, cfg, params, ro, po, rst, st, toks = _calibrated()
    _stats_equal(rst, st)
    assert st.n_tokens == rst.n_tokens == 4 * (8 + 19)
    assert st.weights["blocks.0.1.attn.wq"].count == 4 * (8 + 19)
    # one KV head: nothing to prune, in both packages
    p2, c2, s2 = P.prune_kv_groups(params, cfg, st, 1)
    assert p2 is params and c2 is cfg and s2 is st
    # FFN pruning: 128 -> 96 channels, each layer its own
    rq, rcfg2, rst2 = RP.prune_ffn(rparams, rcfg, RC.CalibStats(dict(rst.weights),
                                                                rst.block_sim, rst.n_tokens),
                                   0.75)
    q, cfg2, st2 = P.prune_ffn(params, cfg, st, 0.75)
    assert cfg2.d_ff == rcfg2.d_ff == 96
    want = bridge.from_reference(rq, device="cpu")["blocks"][0]["mlp"]
    for n in ("wi", "wg", "wo"):
        assert torch.equal(q["blocks"][0]["mlp"][n], want[n]), n
    _stats_equal(rst2, st2)
    # layer dropping: stats re-keyed
    rd, rcfg3, rst3 = RP.drop_layers(rparams, rcfg, rst, 1)
    d, cfg3, st3 = P.drop_layers(params, cfg, st, 1)
    assert cfg3.n_layers == rcfg3.n_layers == 1
    _stats_equal(rst3, st3)
    assert torch.equal(d["blocks"][0]["attn"]["wq"],
                       bridge.from_reference(rd, device="cpu")["blocks"][0]["attn"]["wq"])


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


@pytest.mark.parametrize("name", ["w8-absmax", "w8-ffn75"])
def test_recipe_codes_and_configs_match_reference(name):
    """The grid's ``w8-absmax`` and ``w8-ffn75`` (GPTQ); the tied embedding
    stays plain, so the unembed is no K2 launch."""
    rcfg, rparams, cfg, params, ro, po, rst, st, _ = _calibrated()
    grid = {r.name: r for r in POL.default_recipe_space(cfg)}
    rgrid = {r.name: r for r in RPOL.default_recipe_space(rcfg)}
    rq, rcfg2, rrep = ro.apply(rgrid[name])
    q, cfg2, rep = po.apply(grid[name])
    assert dataclasses.asdict(cfg2) == dataclasses.asdict(from_reference(rcfg2))
    _walk(q, bridge.from_reference(rq, device="cpu"), name == "w8-absmax")
    assert isinstance(q["blocks"][0]["mlp"]["wo"], QTensor) and "unembed" not in q
    assert rep.bytes_after == rrep.bytes_after and rep.params_after == rrep.params_after
    toks, img = _tokens(2, 8, seed=2), _img(2, seed=3)
    with torch.no_grad():
        got = _np(api.forward(q, cfg2, {"tokens": torch.from_numpy(toks),
                                        "img_embs": torch.from_numpy(img)})[0])
    want = rapi.forward(rq, rcfg2, {"tokens": jnp.asarray(toks), "img_embs": jnp.asarray(img)},
                        remat=False)[0]
    assert _rel(got, np.asarray(want)) < 1e-4


SESSION_KW = dict(calib_rows=4, eval_rows=2, engine_kw=dict(slots=4, max_len=64,
                                                             buckets=(32, 48)))
SESSION_RECIPES = [dict(name="w8-absmax", wbits=8, quant_method="absmax"),
                   dict(name="w8a-ffn75", ffn_keep_frac=0.75, wbits=8, quant_method="absmax")]


def test_session_text_only_query_matches_reference():
    """Q2 (``llm_correct``) through ``Query.run`` on an f32 session: the
    session passes no image (no ``extra_inputs`` in either package's
    OLAP layer), so the vlm answers from the text alone, and the table
    and run statistics are the reference session's."""
    rcfg, rparams, cfg, params = _model()
    tables = []
    for mod, table_cls, sess in (
            (RQ, RTable, RQ.IOLMSession(rparams, rcfg, objective="acc",
                                        recipes=[RRecipe(**r) for r in SESSION_RECIPES],
                                        **SESSION_KW)),
            (Q, Table, Q.IOLMSession(params, cfg, objective="acc", device="cpu",
                                     recipes=[Recipe(**r) for r in SESSION_RECIPES],
                                     **SESSION_KW))):
        commits = table_cls({"lang": [r.text for r in RD.workload_rows("correct", 6)]})
        q = mod.Query(commits, sess).llm_correct("lang", max_new=6)
        tables.append((q.run(), q.last_run_stats, sess))
    (wt, wstats, rsess), (gt, gstats, sess) = tables
    assert gt.columns == wt.columns
    assert [dataclasses.asdict(s) for s in gstats] == [dataclasses.asdict(s) for s in wstats]
    (m,), (rm,) = sess.model_cache._d.values(), rsess.model_cache._d.values()
    assert m.recipe.name == rm.recipe.name and m.cfg.d_ff == rm.cfg.d_ff
