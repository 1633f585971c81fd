"""Port encdec family (whisper: an encoder over precomputed frames and a
decoder that cross-attends to it) vs the reference's.

``whisper-base-smoke`` (2 + 2 layers, d_model 64, 4 heads of 16, d_ff
128, ``enc_ctx`` 32, LayerNorm, learned positions) with the byte
tokenizer's vocab of 260.  The reference's params (``jax.random`` init,
f32 unless said otherwise) are bridged into the port and the same numpy
inputs (``enc_inputs`` N(0, 1), as ``tests/conftest.py`` draws them) go
through both.  Tolerances, relative to the largest reference value:

- ``encode``, ``forward``, ``prefill`` + three ``decode_step``s (f32) at
  Te 20, 32 and 45 frames (below, at and above ``enc_ctx``: the cache
  pads or truncates the cross K/V, ``prefill``'s own cross-attention
  sees every frame): logits within 1e-4, caches within 1e-5, greedy
  tokens identical; bf16 ``forward`` within 2e-2 of the reference's bf16
  logits (RMS of the difference over their RMS) and no further from the
  f32 logits than twice the reference's own bf16, its argmax agreement
  with f32 printed;
- ``loss_fn`` with and without ``xent_chunk``: within 1e-5;
- the ``Engine`` with ``extra_inputs={"enc_inputs": ...}`` gives the
  reference engine's rows (base and ``w8``) at two buckets with slot
  reuse;
- ``calibrate``: statistics within 1e-5, block similarities within 1e-6;
  ``prune_kv_groups``, ``prune_ffn`` (the ungated MLP) and ``drop_layers``
  (across both lists, one block kept in each): the same kept heads,
  channels and blocks, shapes, configs and re-keyed statistics;
  ``w8-absmax`` and ``w8-kv50`` codes equal and ``w8-ffn75`` (the grid's
  GPTQ) codes equal on 99.9% of entries, scales within 1e-6;
- ``Query.run`` over an encdec session raises in both packages (the
  session passes no ``enc_inputs``), the port's before any build;
  ``slot_state_bytes`` equals the reference's (24,723,460 B a slot for
  full-width whisper-base at ``max_len`` 512).
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
from repro.models import encdec as RED  # noqa: E402
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
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.olap import query as Q  # noqa: E402
from repro_torch.olap.table import Table  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.scheduler import slot_state_bytes  # noqa: E402

ARCH = "whisper-base"
ROWS = ["transcribe: hello", "transcribe: the weather today", "transcribe: hi",
        "transcribe: hello", "transcribe: a longer line here", "transcribe: ok",
        "transcribe: numbers one two"]
W8 = dict(wbits=8, quant_method="absmax")


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


def _frames(B, Te, seed, d=64):
    return np.random.default_rng(seed).standard_normal((B, Te, d)).astype(np.float32)


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
    assert (full.n_enc_layers, full.n_dec_layers, full.d_model, full.n_heads, full.head_dim,
            full.d_ff, full.vocab_size, full.enc_ctx, full.norm_type, full.max_seq) == \
        (6, 6, 512, 8, 64, 2048, 51865, 1500, "layernorm", 65536)
    shapes = jax.eval_shape(lambda k: rapi.init_params(k, rregistry.get_config(ARCH)),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) == 164_291_584
    rcfg, rparams, cfg, params = _model()
    mine = api.init_params(torch.Generator().manual_seed(0), cfg)
    assert [(k, tuple(t.shape), t.dtype) for k, t in _leaves(mine)] == \
        [(k, tuple(t.shape), t.dtype) for k, t in _leaves(params)]
    assert ".dec_blocks.1.xattn.wq" in dict(_leaves(mine))
    assert api.family_module(full) is ED
    for arch in registry.ARCH_IDS:               # every family of the registry resolves
        api.family_module(registry.get_config(arch))
    assert not api.supports_prefix(full) and not api.supports_paged(full)
    assert api.supports_prefix(full) == rapi.supports_prefix(full)
    assert api.supports_paged(full) == rapi.supports_paged(full)
    assert slot_state_bytes(full, 512) == ref_slot_bytes(rregistry.get_config(ARCH),
                                                         512) == 24_723_460
    assert slot_state_bytes(cfg, 64) == ref_slot_bytes(rcfg, 64)
    assert sorted(r.name for r in POL.default_recipe_space(full)) == \
        sorted(r.name for r in RPOL.default_recipe_space(rregistry.get_config(ARCH)))


@pytest.mark.parametrize("Te", [20, 32, 45])
def test_encode_prefill_and_decode_match_reference(Te):
    rcfg, rparams, cfg, params = _model()
    toks, enc = _tokens(3, 13, seed=1), _frames(3, Te, seed=Te)
    lens = np.array([13, 8, 3])
    renc = np.asarray(RED.encode(rparams, rcfg, jnp.asarray(enc), remat=False))
    with torch.no_grad():
        penc = ED.encode(params, cfg, torch.from_numpy(enc), remat=False)
    assert _rel(_np(penc), renc) < 1e-5
    rb = {"tokens": jnp.asarray(toks), "enc_inputs": jnp.asarray(enc)}
    pb = {"tokens": torch.from_numpy(toks), "enc_inputs": torch.from_numpy(enc)}
    rl, _ = rapi.forward(rparams, rcfg, rb, remat=False)
    with torch.no_grad():
        pl, _ = api.forward(params, cfg, pb)
    assert _rel(_np(pl), np.asarray(rl)) < 1e-4
    assert np.array_equal(_np(pl).argmax(-1), np.asarray(rl).argmax(-1))
    max_len = 24
    rlog, rcache = rapi.prefill(rparams, rcfg, rb, max_len=max_len)
    with torch.no_grad():
        plog, cache = api.prefill(params, cfg, pb, max_len=max_len)
    assert _rel(_np(plog), np.asarray(rlog)) < 1e-4
    assert cache["cross"][0]["k"].shape == (3, cfg.enc_ctx, 4, 16)
    assert cache["enc_len"].tolist() == [min(Te, cfg.enc_ctx)] * 3
    for sec in ("self", "cross"):
        for i in range(2):
            for n in ("k", "v"):
                assert _rel(_np(cache[sec][i][n]), np.asarray(rcache[sec][i][n])) < 1e-5
    # the contiguous slot state: rows written at their slots
    slots = api.init_cache(cfg, 4, max_len, device="cpu")
    api.insert_rows(cfg, slots, cache, [3, 0, 2])
    cache = {"self": [{n: t[[3, 0, 2]].clone() for n, t in e.items()} for e in slots["self"]],
             "cross": [{n: t[[3, 0, 2]].clone() for n, t in e.items()}
                       for e in slots["cross"]],
             "enc_len": slots["enc_len"][[3, 0, 2]].clone()}
    tok = np.asarray(rlog)[np.arange(3), lens - 1].argmax(-1)[:, None].astype(np.int32)
    assert np.array_equal(_np(plog)[np.arange(3), lens - 1].argmax(-1)[:, None], tok)
    pos = lens.copy()
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
    toks, enc = _tokens(2, 16, seed=5), _frames(2, 30, seed=6)
    want = np.asarray(rapi.forward(rparams32, rcfg32, {"tokens": jnp.asarray(toks),
                                                       "enc_inputs": jnp.asarray(enc)},
                                   remat=False)[0])
    enc16 = jnp.asarray(enc).astype(jnp.bfloat16)
    ref16 = np.asarray(rapi.forward(rparams, rcfg, {"tokens": jnp.asarray(toks),
                                                    "enc_inputs": enc16}, remat=False)[0],
                       np.float32)
    with torch.no_grad():
        got = _np(api.forward(params, cfg, {"tokens": torch.from_numpy(toks),
                                             "enc_inputs": bridge.to_tensor(enc16, "cpu")})[0])
    err, ref_err = _rel(got, want), _rel(ref16, want)
    rms = float(np.sqrt(((got - ref16) ** 2).mean() / (ref16 ** 2).mean()))
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    ref_agree = float(np.mean(ref16.argmax(-1) == want.argmax(-1)))
    print(f"bf16 forward: RMS rel difference from the reference's bf16 {rms:.3e}; max rel "
          f"err from f32 {err:.3e} (reference's bf16 {ref_err:.3e}); argmax agreement with "
          f"f32 {agree:.3f} (reference's bf16 {ref_agree:.3f})")
    assert np.isfinite(got).all() and rms < 2e-2 and err <= 2 * ref_err


@pytest.mark.parametrize("xent_chunk", [0, 4])
def test_loss_matches_reference(xent_chunk):
    rcfg, rparams, cfg, params = _model()
    toks, labels, enc = _tokens(2, 16, seed=7), _tokens(2, 16, seed=8), _frames(2, 24, seed=9)
    want = float(rapi.loss_fn(rparams, rcfg, {"tokens": jnp.asarray(toks),
                                              "labels": jnp.asarray(labels),
                                              "enc_inputs": jnp.asarray(enc)},
                              xent_chunk=xent_chunk))
    with torch.no_grad():
        got = float(api.loss_fn(params, cfg, {"tokens": torch.from_numpy(toks),
                                              "labels": torch.from_numpy(labels),
                                              "enc_inputs": torch.from_numpy(enc)},
                                xent_chunk=xent_chunk))
    assert abs(got - want) < 1e-5 * abs(want)


@pytest.mark.parametrize("recipe", ["base", "w8"])
def test_engine_rows_match_reference(recipe):
    """Two buckets (16 and 32) and two slots for seven rows (one
    duplicate), every row given the same encoder frames: the reference
    engine's rows, prefills and cache hits."""
    rcfg, rparams, cfg, params = _model()
    if recipe == "w8":
        rparams, _, _ = RInstanceOptimizer(rparams, rcfg).apply(RRecipe(name="w8", **W8))
        params, _, _ = InstanceOptimizer(params, cfg).apply(Recipe(name="w8", **W8))
        assert isinstance(params["unembed"], QTensor)
        assert isinstance(params["dec_blocks"][1]["xattn"]["wk"], QTensor)
    enc = _frames(1, 40, seed=3)[0]
    kw = dict(slots=2, max_len=64, buckets=(16, 32))
    ref = REngine(rparams, rcfg, extra_inputs={"enc_inputs": jnp.asarray(enc)},
                  backend="reference", kv_layout="contiguous", **kw)
    rreqs = [ref.submit(t, max_new=6) for t in ROWS]
    ref.drain()
    eng = Engine(params, cfg, extra_inputs={"enc_inputs": torch.from_numpy(enc)},
                 device="cpu", **kw)
    assert not eng._paged and eng.prefix_cache is None
    reqs = eng.generate(ROWS, max_new=6, return_requests=True)
    assert [r.out_ids for r in reqs] == [r.out_ids for r in rreqs]
    st, rst = eng.stats, ref.stats
    assert (st.rows, st.cache_hits, st.prefills, st.truncated) == \
        (rst.rows, rst.cache_hits, rst.prefills, rst.truncated)
    assert st.prefills >= 3 and st.truncated == 0


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
    toks, enc = _tokens(4, 19, seed=1), _frames(4, 36, seed=4)
    toks[:, 15:] = 0
    ro, po = RInstanceOptimizer(rparams, rcfg), InstanceOptimizer(params, cfg)
    rst = ro.run_calibration({"tokens": jnp.asarray(toks), "enc_inputs": jnp.asarray(enc)})
    st = po.run_calibration({"tokens": torch.from_numpy(toks),
                             "enc_inputs": torch.from_numpy(enc)})
    return rcfg, rparams, cfg, params, ro, po, rst, st, toks


def _copy(st):
    return RC.CalibStats(dict(st.weights), dict(st.block_sim), st.n_tokens)


def test_calibrate_and_prune_match_reference():
    rcfg, rparams, cfg, params, ro, po, rst, st, toks = _calibrated()
    _stats_equal(rst, st)
    assert st.n_tokens == rst.n_tokens == toks.size
    assert set(st.block_sim) == {"enc_blocks.0", "enc_blocks.1", "dec_blocks.0",
                                 "dec_blocks.1"}
    assert st.weights["enc_blocks.1.attn.wq"].count == 4 * 36
    assert st.weights["dec_blocks.0.xattn.wk"].count == 4 * 36
    assert st.weights["dec_blocks.0.xattn.wq"].count == toks.size
    assert st.weights["unembed"].count == toks.size
    # KV groups: 4 -> 2 in every self- and cross-attention
    rq, rcfg1, rst1 = RP.prune_kv_groups(rparams, rcfg, _copy(rst), 2)
    q, cfg1, st1 = P.prune_kv_groups(params, cfg, st, 2)
    assert dataclasses.asdict(cfg1) == dataclasses.asdict(from_reference(rcfg1))
    assert (cfg1.n_heads, cfg1.n_kv_heads, cfg1.head_dim) == (2, 2, 16)
    want = bridge.from_reference(rq, device="cpu")
    for lst, nm in (("enc_blocks", "attn"), ("dec_blocks", "attn"), ("dec_blocks", "xattn")):
        for i in range(2):
            for n in ("wq", "wk", "wv", "wo"):
                assert torch.equal(q[lst][i][nm][n], want[lst][i][nm][n]), (lst, i, nm, n)
    _stats_equal(rst1, st1)
    # FFN pruning: the ungated MLP, 128 -> 96 channels in every block
    rq, rcfg2, rst2 = RP.prune_ffn(rparams, rcfg, _copy(rst), 0.75)
    q, cfg2, st2 = P.prune_ffn(params, cfg, st, 0.75)
    assert cfg2.d_ff == rcfg2.d_ff == 96
    want = bridge.from_reference(rq, device="cpu")
    for lst in ("enc_blocks", "dec_blocks"):
        for i in range(2):
            assert set(q[lst][i]["mlp"]) == {"wi", "wo"}
            for n in ("wi", "wo"):
                assert torch.equal(q[lst][i]["mlp"][n], want[lst][i]["mlp"][n])
    _stats_equal(rst2, st2)
    # layer dropping across both lists, one block kept in each
    for n_drop in (1, 3):
        rd, rcfg3, rst3 = RP.drop_layers(rparams, rcfg, _copy(rst), n_drop)
        d, cfg3, st3 = P.drop_layers(params, cfg, st, n_drop)
        assert (cfg3.n_enc_layers, cfg3.n_dec_layers) == (rcfg3.n_enc_layers,
                                                           rcfg3.n_dec_layers)
        assert cfg3.n_enc_layers >= 1 and cfg3.n_dec_layers >= 1
        assert cfg3.n_enc_layers + cfg3.n_dec_layers == 4 - min(n_drop, 2)
        _stats_equal(rst3, st3)
        wd = bridge.from_reference(rd, device="cpu")
        for lst in ("enc_blocks", "dec_blocks"):
            assert len(d[lst]) == len(wd[lst])
            for a, b in zip(d[lst], wd[lst]):
                assert torch.equal(a["attn"]["wq"], b["attn"]["wq"])


def _walk(a, b, exact, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _walk(a[k], b[k], exact, f"{path}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), path
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


@pytest.mark.parametrize("name", ["w8-absmax", "w8-ffn75", "w8-kv50"])
def test_recipe_codes_and_configs_match_reference(name):
    """The grid's ``w8-absmax``, ``w8-ffn75`` (GPTQ) and ``w8-kv50``: every
    linear of both lists and the untied unembed quantized, no stacked
    axis; the position tables stay plain."""
    rcfg, rparams, cfg, params, ro, po, rst, st, _ = _calibrated()
    grid = {r.name: r for r in POL.default_recipe_space(cfg)}
    rgrid = {r.name: r for r in RPOL.default_recipe_space(rcfg)}
    rq, rcfg2, rrep = ro.apply(rgrid[name])
    q, cfg2, rep = po.apply(grid[name])
    assert dataclasses.asdict(cfg2) == dataclasses.asdict(from_reference(rcfg2))
    _walk(q, bridge.from_reference(rq, device="cpu"), name != "w8-ffn75")
    assert isinstance(q["unembed"], QTensor) and q["unembed"].q.shape == (64, 260)
    assert q["dec_blocks"][0]["xattn"]["wq"].q.dim() == 2
    assert not isinstance(q["pos_dec"], QTensor)
    assert rep.bytes_after == rrep.bytes_after and rep.params_after == rrep.params_after
    toks, enc = _tokens(2, 8, seed=2), _frames(2, 30, seed=3)
    with torch.no_grad():
        got = _np(api.forward(q, cfg2, {"tokens": torch.from_numpy(toks),
                                        "enc_inputs": torch.from_numpy(enc)})[0])
    want = rapi.forward(rq, rcfg2, {"tokens": jnp.asarray(toks),
                                    "enc_inputs": jnp.asarray(enc)}, remat=False)[0]
    assert _rel(got, np.asarray(want)) < 1e-4


def test_session_query_raises_in_both_packages():
    """The OLAP session passes tokens only: the reference's ``Query.run``
    fails in calibration (no ``enc_inputs``), the port's refuses before
    building anything, naming ``enc_inputs``."""
    rcfg, rparams, cfg, params = _model()
    rows = [r.text for r in RD.workload_rows("correct", 6)]
    kw = dict(calib_rows=4, eval_rows=2, recipes=None,
              engine_kw=dict(slots=2, max_len=64, buckets=(32,)))
    rsess = RQ.IOLMSession(rparams, rcfg, **kw)
    with pytest.raises(KeyError, match="enc_inputs"):
        RQ.Query(RTable({"lang": rows}), rsess).llm_correct("lang").run()
    sess = Q.IOLMSession(params, cfg, device="cpu", **kw)
    with pytest.raises(ValueError, match="enc_inputs"):
        Q.Query(Table({"lang": rows}), sess).llm_correct("lang").run()
    assert sess.recalibrations == 0 and len(sess.model_cache) == 0
    with pytest.raises(ValueError, match="enc_inputs"):
        sess.base_engine()
