"""Port hybrid family (Mamba2 + one shared attention block) vs the reference's.

The reduced ``zamba2-7b`` (9 layers: 3 groups of 2 Mamba layers and 3
sites of the shared block, no tail) and a variant with a Mamba tail
(``n_layers=10``: 3 groups of 2, 1 tail layer, 3 sites), in f32 unless
said otherwise; the reference's params (``jax.random`` init) are bridged
into the port and the same numpy inputs go through both.  Tolerances,
relative to the largest reference value:

- ``ssd_sequential`` and ``ssd_chunked`` (nonzero ``h0``, a prime T, so
  chunks of one position) against the reference's and each other: 1e-5;
- ``block_apply`` with ``lengths``: right-padded rows give the unpadded
  rows' outputs and states (1e-5), as the reference does;
- ``forward``, ``prefill`` + ``decode_step``, ``paged_decode_step`` and a
  prefix-seeded ``prefill_from``: logits and states within 1e-5 (1e-4 for
  logits through the whole stack), greedy tokens identical; bf16
  ``forward`` within 2e-2 of the f32 logits and no noisier than twice the
  reference's own bf16, its token agreement with the f32 argmax
  reported;
- the port's ``Engine`` (contiguous and paged) gives the reference
  ``Engine``'s rows (contiguous, ``backend="reference"``: the reference's
  Pallas paged kernel does not trace off the TPU), base and ``w8``, with
  and without a shared template prefix;
- ``InstanceOptimizer`` (``w8`` absmax, ``kv_keep_frac=0.5``,
  ``ffn_keep_frac=0.75``, ``drop_units=1``): calibration statistics
  (the shared block's accumulated over its sites) within 1e-5, block
  similarities within 1e-6, the same configs, equal codes and scales;
- an f32 ``Query.run`` over a hybrid session gives the reference
  session's table;
- ``greedy_decode`` prefills without ``lengths`` in both packages
  (``core/policy.py``), so a short row's recurrent state absorbs its
  padding: both packages give the same tokens, and both show the
  difference from a prefill with ``lengths``.
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
from repro.models import hybrid as RH  # noqa: E402
from repro.models import mamba as RM  # noqa: E402
from repro.olap import query as RQ  # noqa: E402
from repro.olap.table import Table as RTable  # noqa: E402
from repro.serving.engine import Engine as REngine  # noqa: E402
from repro.training import data as RD  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference, registry  # noqa: E402
from repro_torch.core import policy as POL  # noqa: E402
from repro_torch.core.compressed import QTensor  # noqa: E402
from repro_torch.core.pipeline import InstanceOptimizer, Recipe  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import hybrid as H  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.models.transformer import layer_slice  # noqa: E402
from repro_torch.olap import query as Q  # noqa: E402
from repro_torch.olap.table import Table  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

LAYERS = [9, 10]                 # no tail; one tail layer
TEMPLATE = "Sentiment (pos or neg) of review: "
ROWS = [TEMPLATE + r for r in (
    "great battery life", "arrived broken, no refund", "ok for the price",
    "great battery life", "the strap snapped after two days", "meh")]
KW = dict(slots=4, max_len=128, buckets=(16, 32, 64))
W8 = dict(wbits=8, quant_method="absmax")


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _np(t):
    return t.detach().float().numpy()


_MODELS = {}


def _model(n_layers=9, dtype="float32"):
    """(reference cfg, reference params, port cfg, port params), vocab 260
    (the byte tokenizer's).  One reference init, at 10 layers in f32,
    serves every variant: the 9-layer model (the same 3 groups of 2 and 3
    sites) is its params without the tail, and a bf16 model its leaves
    cast to the dtypes a bf16 init gives them."""
    key = (n_layers, dtype)
    if key not in _MODELS:
        rcfg = rregistry.get_reduced("zamba2-7b").replace(
            param_dtype=dtype, n_layers=n_layers, vocab_size=260)
        if key == (10, "float32"):
            rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
        else:
            rparams = {**_model(10)[1], **({"mamba_tail": None} if n_layers == 9 else {})}
            like = jax.eval_shape(lambda k: rapi.init_params(k, rcfg), jax.random.PRNGKey(0))
            rparams = jax.tree.map(lambda a, s: a.astype(s.dtype), rparams, like)
        _MODELS[key] = (rcfg, rparams, from_reference(rcfg),
                        bridge.from_reference(rparams, device="cpu"))
    return _MODELS[key]


def _tokens(B, S, seed, vocab=256):
    return np.random.default_rng(seed).integers(4, vocab, (B, S)).astype(np.int32)


def test_config_and_layouts_match_reference():
    for mine, ref in ((registry.get_config("zamba2-7b"), rregistry.get_config("zamba2-7b")),
                      (registry.get_reduced("zamba2-7b"), rregistry.get_reduced("zamba2-7b"))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(from_reference(ref))
    full = registry.get_config("zamba2-7b")
    assert full.param_count() == 5_892_074_496
    assert H.layout(full) == RH.layout(full) == (11, 6, 4, 11)
    for n in LAYERS:
        rcfg, _, cfg, params = _model(n)
        assert H.layout(cfg) == RH.layout(rcfg)
        assert (params["mamba_tail"] is None) == (H.layout(cfg)[2] == 0)
    # the pool sizes a slot's state from shapes alone, recurrent state included
    from repro.serving.scheduler import slot_state_bytes as ref_bytes
    from repro_torch.serving.scheduler import slot_state_bytes
    for cfg in (rregistry.get_config("zamba2-7b"), _model(10)[0]):
        assert slot_state_bytes(from_reference(cfg), 1024) == ref_bytes(cfg, 1024)


# ---------------------------------------------------------------------------
# the SSD scan and the Mamba block
# ---------------------------------------------------------------------------

def _ssd_inputs(B, T, H, P, N, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, T, H, P)).astype(np.float32)
    dt = r.uniform(0.01, 0.5, (B, T, H)).astype(np.float32)
    a = np.exp(-dt * r.uniform(1.0, 4.0, (H,))).astype(np.float32)
    Bm = r.standard_normal((B, T, N)).astype(np.float32)
    Cm = r.standard_normal((B, T, N)).astype(np.float32)
    D = r.uniform(0.5, 1.5, (H,)).astype(np.float32)
    h0 = r.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, a, Bm, Cm, D, h0


@pytest.mark.parametrize("T,chunk", [(13, 64), (13, 4), (12, 4)])
def test_ssd_sequential_equals_chunked(T, chunk):
    """T 13 with chunk 4 shrinks the chunk to 1 (a prime length)."""
    args = _ssd_inputs(2, T, 3, 4, 5, seed=T + chunk)
    ry, rh = RM.ssd_sequential(*map(jnp.asarray, args))
    rcy, rch = RM.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    targs = [torch.from_numpy(a) for a in args]
    sy, sh = M.ssd_sequential(*targs)
    cy, ch = M.ssd_chunked(*targs, chunk=chunk)
    for got in (sy, cy):
        assert _rel(_np(got), np.asarray(ry)) < 1e-5
    for got in (sh, ch):
        assert _rel(_np(got), np.asarray(rh)) < 1e-5
    assert _rel(_np(cy), np.asarray(rcy)) < 1e-5 and _rel(_np(ch), np.asarray(rch)) < 1e-5


def test_block_apply_with_lengths_freezes_state_across_padding():
    rcfg, rparams, cfg, params = _model()
    rp = jax.tree.map(lambda a: a[0, 0], rparams["mamba_groups"])
    p = layer_slice(layer_slice(params["mamba_groups"], 0), 0)
    d_inner, Hh, P, N = M.dims(cfg)
    r = np.random.default_rng(3)
    lens = np.array([11, 6, 2])
    x = r.standard_normal((3, 11, cfg.d_model)).astype(np.float32)
    state = {"h": r.standard_normal((3, Hh, P, N)).astype(np.float32),
             "conv": r.standard_normal((3, cfg.conv_kernel - 1, d_inner + 2 * N))
             .astype(np.float32)}
    with torch.no_grad():
        y, st = M.block_apply(p, torch.from_numpy(x), cfg,
                              state={n: torch.from_numpy(v) for n, v in state.items()},
                              lengths=torch.from_numpy(lens))
    ry, rst = RM.block_apply(rp, jnp.asarray(x), rcfg,
                             state=jax.tree.map(jnp.asarray, state), lengths=jnp.asarray(lens))
    assert _rel(_np(y), np.asarray(ry)) < 1e-5
    for n in ("h", "conv"):
        assert _rel(_np(st[n]), np.asarray(rst[n])) < 1e-5
    for i, n in enumerate(lens):                 # each row alone, unpadded
        with torch.no_grad():
            yi, sti = M.block_apply(p, torch.from_numpy(x[i:i + 1, :n]), cfg,
                                    state={k: torch.from_numpy(v[i:i + 1])
                                           for k, v in state.items()})
        assert _rel(_np(y[i:i + 1, :n]), _np(yi)) < 1e-5
        for k in ("h", "conv"):
            assert _rel(_np(st[k][i:i + 1]), _np(sti[k])) < 1e-5


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", LAYERS)
def test_forward_prefill_and_decode_match_reference(n_layers):
    rcfg, rparams, cfg, params = _model(n_layers)
    toks = _tokens(3, 13, seed=n_layers)
    lens = np.array([13, 9, 4])
    rl, _ = rapi.forward(rparams, rcfg, {"tokens": jnp.asarray(toks)}, remat=False)
    with torch.no_grad():
        pl, aux = api.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert _rel(_np(pl), np.asarray(rl)) < 1e-4
    assert np.array_equal(_np(pl).argmax(-1), np.asarray(rl).argmax(-1))
    max_len = 32
    rlog, rcache = rapi.prefill(rparams, rcfg, {"tokens": jnp.asarray(toks)}, max_len=max_len,
                                lengths=jnp.asarray(lens))
    with torch.no_grad():
        plog, cache = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                                  max_len=max_len, lengths=torch.from_numpy(lens))
    assert _rel(_np(plog), np.asarray(rlog)) < 1e-4
    tok = np.asarray(rlog)[np.arange(3), lens - 1].argmax(-1)[:, None].astype(np.int32)
    assert np.array_equal(_np(plog)[np.arange(3), lens - 1].argmax(-1)[:, None], tok)
    pos = lens.copy()
    for _ in range(3):                          # per-row positions
        rlog, rcache = rapi.decode_step(rparams, rcfg, rcache, jnp.asarray(tok),
                                        jnp.asarray(pos), max_len=max_len)
        with torch.no_grad():
            plog, cache = api.decode_step(params, cfg, cache, torch.from_numpy(tok),
                                          torch.from_numpy(pos), max_len=max_len)
        assert _rel(_np(plog), np.asarray(rlog)) < 1e-4
        tok = np.asarray(rlog)[:, -1].argmax(-1)[:, None].astype(np.int32)
        assert np.array_equal(_np(plog)[:, -1].argmax(-1)[:, None], tok)
        pos = pos + 1
    for sec in ("mamba_groups", "shared_kv", "mamba_tail"):
        if rcache[sec] is None:
            assert cache[sec] is None
            continue
        for n in rcache[sec]:
            assert _rel(_np(cache[sec][n]), np.asarray(rcache[sec][n])) < 1e-5, (sec, n)


def test_bf16_forward_within_bound():
    _, _, _, params32 = _model()
    rcfg, rparams, cfg, params = _model(dtype="bfloat16")
    toks = _tokens(2, 16, seed=5)
    rcfg32, rparams32 = _model()[:2]
    want = np.asarray(rapi.forward(rparams32, rcfg32, {"tokens": jnp.asarray(toks)},
                                   remat=False)[0])
    ref16 = np.asarray(rapi.forward(rparams, rcfg, {"tokens": jnp.asarray(toks)},
                                    remat=False)[0], np.float32)
    with torch.no_grad():
        got = _np(api.forward(params, cfg, {"tokens": torch.from_numpy(toks)})[0])
    err, ref_err = _rel(got, want), _rel(ref16, want)
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    print(f"bf16 forward: rel err {err:.3e} (reference's bf16 {ref_err:.3e}), "
          f"argmax agreement with f32 {agree:.3f}")
    assert np.isfinite(got).all() and err <= 2 * ref_err


@pytest.mark.parametrize("n_layers", LAYERS)
def test_paged_decode_step_equals_contiguous(n_layers):
    _, _, cfg, params = _model(n_layers)
    S, max_len, bs = 3, 32, 8
    toks = _tokens(S, 10, seed=7)
    lens = torch.tensor([10, 7, 3])
    with torch.no_grad():
        logits, rows = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                                   max_len=max_len, lengths=lens)
        nblk = max_len // bs
        state = api.init_paged_cache(cfg, S, S * nblk + 1, bs, device="cpu")
        tables = torch.arange(S * nblk, dtype=torch.int32).reshape(S, nblk)
        api.paged_insert(cfg, state, rows, [0, 1, 2], tables.numpy(), block_size=bs)
        contig = api.init_cache(cfg, S, max_len, device="cpu")
        api.insert_rows(cfg, contig, rows, [0, 1, 2])
        tok = logits[torch.arange(S), lens - 1].argmax(-1)[:, None]
        pos = lens.clone()
        for _ in range(3):
            pl, _ = api.paged_decode_step(params, cfg, state, tables, tok, pos,
                                          block_size=bs, max_len=max_len)
            cl, _ = api.decode_step(params, cfg, contig, tok, pos, max_len=max_len)
            assert _rel(_np(pl), _np(cl)) < 1e-5
            tok, pos = cl[:, -1].argmax(-1)[:, None], pos + 1
    for n in ("h", "conv"):
        assert _rel(_np(state["mamba_groups"][n]), _np(contig["mamba_groups"][n])) < 1e-6


@pytest.mark.parametrize("n_layers", LAYERS)
def test_prefix_seeded_equals_full_prefill(n_layers):
    """prefill(prefix) then prefill_from(right-padded suffixes, lengths)
    gives prefill(prefix + suffix)'s logits and states."""
    rcfg, rparams, cfg, params = _model(n_layers)
    max_len, plen = 48, 11
    prefix = _tokens(1, plen, seed=11)
    suf = _tokens(2, 9, seed=12)
    lens = np.array([9, 5])
    with torch.no_grad():
        _, entry = api.prefill(params, cfg, {"tokens": torch.from_numpy(prefix)},
                               max_len=max_len)
        got, cache = api.prefill_from(params, cfg, entry, torch.from_numpy(suf), plen,
                                      max_len=max_len, lengths=torch.from_numpy(lens))
    _, rentry = rapi.prefill(rparams, rcfg, {"tokens": jnp.asarray(prefix)}, max_len=max_len)
    for i, n in enumerate(lens):                # the reference's engine: one row a call
        rgot, _ = rapi.prefill_from(rparams, rcfg, rentry, jnp.asarray(suf[i:i + 1]), plen,
                                    max_len=max_len, lengths=jnp.asarray(lens[i:i + 1]))
        assert _rel(_np(got[i]), np.asarray(rgot)[0]) < 1e-4
    for i, n in enumerate(lens):
        full = np.concatenate([prefix[0], suf[i, :n]])[None]
        with torch.no_grad():
            want, wcache = api.prefill(params, cfg, {"tokens": torch.from_numpy(full)},
                                       max_len=max_len)
        assert _rel(_np(got[i, :n]), _np(want[0, plen:])) < 1e-4
        for n_ in ("h", "conv"):
            assert _rel(_np(cache["mamba_groups"][n_][:, :, i]),
                        _np(wcache["mamba_groups"][n_][:, :, 0])) < 1e-5
        k = _np(cache["shared_kv"]["k"][:, i, :plen + n])
        assert _rel(k, _np(wcache["shared_kv"]["k"][:, 0, :plen + n])) < 1e-5
    # the entry itself is left as it was
    assert torch.equal(entry["shared_kv"]["k"][:, :, plen:], torch.zeros_like(
        entry["shared_kv"]["k"][:, :, plen:]))


# ---------------------------------------------------------------------------
# the engine, the pipeline and the session
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recipe,prefix", [("base", TEMPLATE), ("w8", None)])
def test_engine_rows_match_reference(recipe, prefix):
    rcfg, rparams, cfg, params = _model(10)
    if recipe == "w8":
        rparams, _, _ = RInstanceOptimizer(rparams, rcfg).apply(RRecipe(name="w8", **W8))
        params, _, _ = InstanceOptimizer(params, cfg).apply(Recipe(name="w8", **W8))
        assert isinstance(params["mamba_groups"]["in_proj"], QTensor)
        assert params["mamba_groups"]["in_proj"].q.shape[:2] == (3, 2)
    ref = REngine(rparams, rcfg, backend="reference", kv_layout="contiguous", **KW)
    want = ref.generate(ROWS, max_new=8, prefix=prefix)
    for layout in ("contiguous", "paged"):
        eng = Engine(params, cfg, device="cpu", kv_layout=layout, **KW)
        assert eng.generate(ROWS, max_new=8, prefix=prefix) == want, layout
        assert eng._paged == (layout == "paged")
        st, rst = eng.stats, ref.stats
        assert (st.rows, st.cache_hits, st.prefix_hits, st.prefills) == \
            (rst.rows, rst.cache_hits, rst.prefix_hits, rst.prefills)
        assert (st.prefix_hits > 0) == (prefix is not None)


def _stats_equal(rst, st):
    assert set(rst.weights) == set(st.weights)
    for k, w in rst.weights.items():
        v = st.weights[k]
        assert w.count == v.count, k
        for f in ("H", "sqnorm", "amax"):
            assert _rel(_np(getattr(v, f)), np.asarray(getattr(w, f))) < 1e-5, (k, f)
    assert set(rst.block_sim) == set(st.block_sim)
    assert max(abs(rst.block_sim[k] - st.block_sim[k]) for k in rst.block_sim) < 1e-6


@pytest.mark.parametrize("n_layers", LAYERS)
def test_instance_optimizer_matches_reference(n_layers):
    rcfg, rparams, cfg, params = _model(n_layers)
    toks = _tokens(4, 24, seed=1)
    ro, po = RInstanceOptimizer(rparams, rcfg), InstanceOptimizer(params, cfg)
    rst = ro.run_calibration({"tokens": jnp.asarray(toks)})
    st = po.run_calibration({"tokens": torch.from_numpy(toks)})
    _stats_equal(rst, st)
    G = H.layout(cfg)[0]
    # the shared block: one entry per weight, its rows summed over the G sites
    assert st.weights["shared.attn.wq"].count == G * toks.size
    assert {k.split(".")[0] for k in st.weights} == (
        {"mamba_groups", "shared", "unembed"} | ({"mamba_tail"} if n_layers == 10 else set()))
    rec = dict(name="x", kv_keep_frac=0.5, ffn_keep_frac=0.75, drop_units=1, **W8)
    rq, rcfg2, _ = ro.apply(RRecipe(**rec))
    q, cfg2, report = po.apply(Recipe(**rec))
    assert (cfg2.n_layers, cfg2.n_kv_heads, cfg2.n_heads, cfg2.d_ff) == \
        (rcfg2.n_layers, rcfg2.n_kv_heads, rcfg2.n_heads, rcfg2.d_ff)
    assert H.layout(cfg2)[0] == G - 1 and report.compression > 1.0
    want = bridge.from_reference(rq, device="cpu")

    def walk(a, b, path=""):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k], f"{path}.{k}")
        elif b is None:
            assert a is None
        elif isinstance(b, QTensor):
            assert isinstance(a, QTensor) and a.q.shape == b.q.shape, path
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale), path
        else:
            assert a.shape == b.shape and torch.allclose(a, b, rtol=0, atol=1e-6), path

    walk(q, want)
    # the pruned, compressed model runs, as the reference's does
    toks2 = _tokens(2, 8, seed=2)
    with torch.no_grad():
        got = _np(api.forward(q, cfg2, {"tokens": torch.from_numpy(toks2)})[0])
    assert _rel(got, np.asarray(rapi.forward(rq, rcfg2, {"tokens": jnp.asarray(toks2)},
                                             remat=False)[0])) < 1e-4


SESSION_KW = dict(calib_rows=4, eval_rows=2, engine_kw=dict(slots=4, max_len=64,
                                                             buckets=(32, 48)))
SESSION_RECIPES = [dict(name="w8-absmax", **W8),
                   dict(name="w8a-kv50", kv_keep_frac=0.5, **W8)]


def test_session_query_matches_reference():
    rcfg, rparams, cfg, params = _model(10)
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
        tables.append((q.run(), q.last_run_stats))
    (wt, wstats), (gt, gstats) = tables
    assert gt.columns == wt.columns
    assert [dataclasses.asdict(s) for s in gstats] == [dataclasses.asdict(s) for s in wstats]


def test_greedy_decode_without_lengths_absorbs_padding_in_both_packages():
    """``greedy_decode`` prefills without ``lengths`` (the reference's
    ``core/policy.py``), so a right-padded row's recurrent state takes in
    its padding: the port computes what the reference computes, and a
    prefill with ``lengths`` gives other logits for the short row only."""
    rcfg, rparams, cfg, params = _model(10)
    toks = _tokens(2, 12, seed=4)
    lens = np.array([12, 7])
    toks[1, 7:] = 0
    want = RPOL.greedy_decode(rparams, rcfg, jnp.asarray(toks), 6, lengths=jnp.asarray(lens))
    got = POL.greedy_decode(params, cfg, torch.from_numpy(toks), 6,
                            lengths=torch.from_numpy(lens))
    assert np.array_equal(got, np.asarray(want))
    first = want[:, :1].astype(np.int32)
    gaps = []
    for with_lengths in (False, True):
        ln = lens if with_lengths else None
        _, rc = rapi.prefill(rparams, rcfg, {"tokens": jnp.asarray(toks)}, max_len=18,
                             lengths=None if ln is None else jnp.asarray(ln))
        rl, _ = rapi.decode_step(rparams, rcfg, rc, jnp.asarray(first), jnp.asarray(lens),
                                 max_len=18)
        with torch.no_grad():
            _, c = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)}, max_len=18,
                               lengths=None if ln is None else torch.from_numpy(ln))
            pl, _ = api.decode_step(params, cfg, c, torch.from_numpy(first).long(),
                                    torch.from_numpy(lens), max_len=18)
        assert _rel(_np(pl), np.asarray(rl)) < 1e-4
        gaps.append(np.asarray(rl)[:, -1])
    full_row = _rel(gaps[0][0], gaps[1][0])
    short_row = _rel(gaps[0][1], gaps[1][1])
    print(f"full row {full_row:.2e}, short row {short_row:.2e}")
    assert full_row < 1e-6 and short_row > 1e-3, (full_row, short_row)
