"""Port rwkv family (RWKV6 "Finch", attention-free) vs the reference's.

``rwkv6-3b-smoke`` (2 layers, d_model 64, 4 heads of 16, d_ff 128) with
the byte tokenizer's vocab of 260, and a variant with d_ff 160, whose
``w8-ffn75`` keeps 120 channel-mix channels: the pruned ``cm.wv`` then
quantizes in groups of 120, the group that sends full-width rwkv6-3b's
pruned ``cm.wv`` (6720 -> 2560) to K2's ``fma`` design on the card.  The
reference's params (``jax.random`` init, f32 unless said otherwise) are
bridged into the port and the same numpy inputs go through both.
Tolerances, relative to the largest reference value:

- ``wkv6_sequential`` and ``wkv6_chunked`` (nonzero ``S0``; a strong
  decay down to e^-40 a token; T 21, which shrinks a chunk of 8 to 7, and
  a prime T, which shrinks it to 1) against the reference's and each
  other: 1e-5;
- ``block_apply`` with ``lengths``: right-padded rows give the unpadded
  rows' outputs and states (1e-5), as the reference does;
- ``forward``, ``prefill`` + three ``decode_step``s (f32): logits within
  1e-4, states within 1e-5, greedy tokens identical; bf16 ``forward``
  within 2e-2 of the reference's bf16 logits (RMS of the difference over
  their RMS) and no further from the f32 logits than twice the
  reference's own bf16, its argmax agreement with f32 printed;
  ``prefill_from`` (prefix-seeded, right-padded suffixes) equal to the
  reference's and to ``prefill`` on the concatenation within 1e-4;
- the ``Engine`` (``auto`` lands on the contiguous layout) gives the
  reference ``Engine``'s rows, base with a shared template prefix and
  ``w8``, with the same prefix hits;
- ``calibrate``: statistics within 1e-5, block similarities within 1e-6;
  ``prune_ffn`` and ``drop_layers``: the same kept channels and layers,
  shapes and re-keyed statistics; ``w8-absmax`` codes equal and
  ``w8-ffn75`` (the grid's GPTQ) codes equal on 99.9% of entries, scales
  within 1e-6, the same configs;
- ``greedy_decode`` prefills without ``lengths`` in both packages, so a
  short row's state absorbs its padding: the same tokens;
- Q2 (``llm_correct``) on an f32 session gives the reference session's
  table; ``slot_state_bytes`` equals the reference's (21,626,880 B a slot
  for full-width rwkv6-3b).
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
from repro.kernels import ops as rops  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import rwkv as RW  # noqa: E402
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
from repro_torch.core.quantize import choose_group  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import rwkv as W  # noqa: E402
from repro_torch.models.transformer import layer_slice  # noqa: E402
from repro_torch.olap import query as Q  # noqa: E402
from repro_torch.olap.table import Table  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.scheduler import slot_state_bytes  # noqa: E402

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


def _model(d_ff=128, dtype="float32"):
    """(reference cfg, reference params, port cfg, port params) of the
    smoke config with vocab 260 and ``d_ff``.  A bf16 model is the f32
    init's leaves cast to the dtypes a bf16 init gives them (``w0`` and
    ``u`` stay f32)."""
    key = (d_ff, dtype)
    if key not in _MODELS:
        rcfg = rregistry.get_reduced("rwkv6-3b").replace(param_dtype=dtype, vocab_size=260,
                                                        d_ff=d_ff)
        if dtype == "float32":
            rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
        else:
            like = jax.eval_shape(lambda k: rapi.init_params(k, rcfg), jax.random.PRNGKey(0))
            rparams = jax.tree.map(lambda a, s: a.astype(s.dtype), _model(d_ff)[1], like)
        _MODELS[key] = (rcfg, rparams, from_reference(rcfg),
                        bridge.from_reference(rparams, device="cpu"))
    return _MODELS[key]


def _tokens(B, S, seed, vocab=256):
    return np.random.default_rng(seed).integers(4, vocab, (B, S)).astype(np.int32)


def test_config_dispatch_slot_bytes_and_loss_match_reference():
    for mine, ref in ((registry.get_config("rwkv6-3b"), rregistry.get_config("rwkv6-3b")),
                      (registry.get_reduced("rwkv6-3b"), rregistry.get_reduced("rwkv6-3b"))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(from_reference(ref))
    full = registry.get_config("rwkv6-3b")
    # published widths: the param count of the reference's init
    shapes = jax.eval_shape(lambda k: rapi.init_params(k, rregistry.get_config("rwkv6-3b")),
                            jax.random.PRNGKey(0))
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert n == 3_073_395_200
    # the port's init gives the reference's tree: leaf paths, shapes, dtypes
    rcfg, rparams, cfg, _ = _model()
    mine = api.init_params(torch.Generator().manual_seed(0), cfg)
    want = bridge.from_reference(rparams, device="cpu")
    assert [(k, tuple(t.shape), t.dtype) for k, t in _leaves(mine)] == \
        [(k, tuple(t.shape), t.dtype) for k, t in _leaves(want)]
    # attention-free: prefix seeding yes, paged KV no
    assert api.supports_prefix(full) and not api.supports_paged(full)
    assert api.supports_prefix(full) == rapi.supports_prefix(full)
    assert api.supports_paged(full) == rapi.supports_paged(full)
    # the pool sizes a slot's O(1) state from shapes alone
    assert slot_state_bytes(full, 1024) == ref_slot_bytes(rregistry.get_config("rwkv6-3b"),
                                                          1024) == 21_626_880
    assert slot_state_bytes(cfg, 64) == ref_slot_bytes(rcfg, 64)
    # training: the causal LM loss equals the reference's (1e-5 relative)
    toks, labels = _tokens(2, 16, 11), _tokens(2, 16, 12)
    got = api.loss_fn(_model()[3], cfg, {"tokens": torch.from_numpy(toks).long(),
                                         "labels": torch.from_numpy(labels).long()})
    want = float(rapi.loss_fn(rparams, rcfg, {"tokens": jnp.asarray(toks),
                                              "labels": jnp.asarray(labels)}))
    assert abs(float(got) - want) <= 1e-5 * abs(want)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}.{i}")
    else:
        yield path, tree


def test_pruned_channel_mix_group_is_120_and_runs_fma():
    """rwkv6-3b's ``w8-ffn75`` keeps 6720 of 8960 channels: the pruned
    ``cm.wv`` quantizes in groups of 120, not a multiple of K2's 64-row
    stage, so bf16 runs K2's ``fma`` design at decode and at prefill; the
    unpruned linears' groups of 128 run ``decode``/``mma``.  K2's plain
    version at group 120 agrees with the reference's kernel (interpret
    mode) and its plain version."""
    keep = max(8, int(round(0.75 * 8960)) // 8 * 8)
    assert keep == 6720 and choose_group(keep, 128) == 120 and choose_group(8960, 128) == 128
    for M in (8, 512):
        assert ops.quant_matmul_variant(torch.bfloat16, M, 2560, 120) == "fma"
        assert ops.quant_matmul_variant(torch.bfloat16, M, 2560, 128) == \
            ("decode" if M <= ops.DECODE_M else "mma")
    from repro.core.quantize import absmax_quantize as rabsmax
    from repro.kernels import ref as rref
    from repro_torch.core.quantize import absmax_quantize
    rng = np.random.default_rng(120)
    w = rng.normal(size=(240, 64)).astype(np.float32)
    rq, pq = rabsmax(jnp.asarray(w), bits=8, group=120), absmax_quantize(
        torch.from_numpy(w), bits=8, group=120)
    assert pq.group == rq.group == 120 and np.array_equal(pq.q.numpy(), np.asarray(rq.q))
    xj = jnp.asarray(rng.normal(size=(8, 240)), jnp.float32).astype(jnp.bfloat16)
    got = ops.quant_matmul(bridge.to_tensor(xj, "cpu"), pq.q, pq.scale, group=pq.group)
    assert _rel(_np(got), rops.quant_matmul(xj, rq.q, rq.scale, group=120,
                                            interpret=True)) < 2e-2
    assert _rel(_np(got), rref.quant_matmul(xj, rq.q, rq.scale, group=120)) < 2e-2


# ---------------------------------------------------------------------------
# the WKV6 recurrence and the block
# ---------------------------------------------------------------------------

def _wkv_inputs(B, T, H, N, seed, strong=False):
    r = np.random.default_rng(seed)
    rk = [r.standard_normal((B, T, H, N)).astype(np.float32) for _ in range(3)]
    lo, hi = (1e-3, 40.0) if strong else (0.01, 2.0)
    w = np.exp(-r.uniform(lo, hi, (B, T, H, N))).astype(np.float32)
    u = (r.standard_normal((H, N)) * 0.3).astype(np.float32)
    S0 = r.standard_normal((B, H, N, N)).astype(np.float32)
    return (*rk, w, u, S0)


@pytest.mark.parametrize("T,chunk,strong", [(21, 8, False), (21, 8, True), (13, 4, False),
                                            (16, 32, True), (1, 32, False)])
def test_wkv6_sequential_equals_chunked(T, chunk, strong):
    """T 21 with chunk 8 runs chunks of 7; T 13 with chunk 4 chunks of 1."""
    args = _wkv_inputs(2, T, 3, 4, seed=T + chunk, strong=strong)
    ro, rS = RW.wkv6_sequential(*map(jnp.asarray, args))
    rco, rcS = RW.wkv6_chunked(*map(jnp.asarray, args), chunk=chunk)
    targs = [torch.from_numpy(a) for a in args]
    so, sS = W.wkv6_sequential(*targs)
    co, cS = W.wkv6_chunked(*targs, chunk=chunk)
    for got in (so, co):
        assert _rel(_np(got), np.asarray(ro)) < 1e-5
    for got in (sS, cS):
        assert _rel(_np(got), np.asarray(rS)) < 1e-5
    assert _rel(_np(co), np.asarray(rco)) < 1e-5 and _rel(_np(cS), np.asarray(rcS)) < 1e-5
    assert np.isfinite(_np(co)).all() and np.isfinite(_np(cS)).all()


def test_block_apply_with_lengths_keeps_padding_out_of_state():
    rcfg, rparams, cfg, params = _model()
    rp = jax.tree.map(lambda a: a[1], rparams["blocks"][0])
    p = layer_slice(params["blocks"][0], 1)
    H, N, d = cfg.n_heads, cfg.rwkv_head_dim, cfg.d_model
    r = np.random.default_rng(3)
    lens = np.array([11, 6, 2])
    x = r.standard_normal((3, 11, d)).astype(np.float32)
    state = {"S": r.standard_normal((3, H, N, N)).astype(np.float32),
             "tm_x": r.standard_normal((3, d)).astype(np.float32),
             "cm_x": r.standard_normal((3, d)).astype(np.float32)}
    with torch.no_grad():
        y, st = W.block_apply(p, torch.from_numpy(x), cfg,
                              state={n: torch.from_numpy(v) for n, v in state.items()},
                              lengths=torch.from_numpy(lens))
    ry, rst = RW.block_apply(rp, jnp.asarray(x), rcfg, state=jax.tree.map(jnp.asarray, state),
                             lengths=jnp.asarray(lens))
    assert _rel(_np(y), np.asarray(ry)) < 1e-5
    for n in state:
        assert _rel(_np(st[n]), np.asarray(rst[n])) < 1e-5, n
    for i, n in enumerate(lens):                 # each row alone, unpadded
        with torch.no_grad():
            yi, sti = W.block_apply(p, torch.from_numpy(x[i:i + 1, :n]), cfg,
                                    state={k: torch.from_numpy(v[i:i + 1])
                                           for k, v in state.items()})
        assert _rel(_np(y[i:i + 1, :n]), _np(yi)) < 1e-5
        for k in state:
            assert _rel(_np(st[k][i:i + 1]), _np(sti[k])) < 1e-5, k


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_prefill_and_decode_match_reference():
    rcfg, rparams, cfg, params = _model()
    toks = _tokens(3, 37, seed=1)                # 37 is prime: chunks of one position
    lens = np.array([37, 20, 5])
    rl, _ = rapi.forward(rparams, rcfg, {"tokens": jnp.asarray(toks)}, remat=False)
    with torch.no_grad():
        pl, aux = api.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert _rel(_np(pl), np.asarray(rl)) < 1e-4
    assert np.array_equal(_np(pl).argmax(-1), np.asarray(rl).argmax(-1))
    max_len = 64
    rlog, rcache = rapi.prefill(rparams, rcfg, {"tokens": jnp.asarray(toks)}, max_len=max_len,
                                lengths=jnp.asarray(lens))
    with torch.no_grad():
        plog, cache = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                                  max_len=max_len, lengths=torch.from_numpy(lens))
    assert _rel(_np(plog), np.asarray(rlog)) < 1e-4
    tok = np.asarray(rlog)[np.arange(3), lens - 1].argmax(-1)[:, None].astype(np.int32)
    assert np.array_equal(_np(plog)[np.arange(3), lens - 1].argmax(-1)[:, None], tok)
    # the serving layout: the slot cache keeps the token-shift carries in
    # f32, prefill returns them in the model's dtype; insert_rows casts
    slots = api.init_cache(cfg, 3, max_len, device="cpu")
    assert {n: t.dtype for n, t in slots["blocks"][0].items()} == {
        "S": torch.float32, "tm_x": torch.float32, "cm_x": torch.float32}
    api.insert_rows(cfg, slots, cache, [2, 0, 1])
    cache = {"blocks": [{n: t[:, [2, 0, 1]].clone() for n, t in slots["blocks"][0].items()}],
             "tail": []}
    pos = lens.copy()
    for _ in range(3):
        rlog, rcache = rapi.decode_step(rparams, rcfg, rcache, jnp.asarray(tok),
                                        jnp.asarray(pos), max_len=max_len)
        with torch.no_grad():
            plog, cache = api.decode_step(params, cfg, cache, torch.from_numpy(tok),
                                          torch.from_numpy(pos), max_len=max_len)
        assert _rel(_np(plog), np.asarray(rlog)) < 1e-4
        tok = np.asarray(rlog)[:, -1].argmax(-1)[:, None].astype(np.int32)
        assert np.array_equal(_np(plog)[:, -1].argmax(-1)[:, None], tok)
        pos = pos + 1
    for n in ("S", "tm_x", "cm_x"):
        assert _rel(_np(cache["blocks"][0][n]), np.asarray(rcache["blocks"][0][n])) < 1e-5, n


def test_bf16_forward_within_bound():
    rcfg32, rparams32, _, _ = _model()
    rcfg, rparams, cfg, params = _model(dtype="bfloat16")
    assert params["blocks"][0]["tm"]["w0"].dtype == torch.float32
    assert params["blocks"][0]["tm"]["wr"].dtype == torch.bfloat16
    toks = _tokens(2, 40, seed=5)
    want = np.asarray(rapi.forward(rparams32, rcfg32, {"tokens": jnp.asarray(toks)},
                                   remat=False)[0])
    ref16 = np.asarray(rapi.forward(rparams, rcfg, {"tokens": jnp.asarray(toks)},
                                    remat=False)[0], np.float32)
    with torch.no_grad():
        got = _np(api.forward(params, cfg, {"tokens": torch.from_numpy(toks)})[0])
    err, ref_err = _rel(got, want), _rel(ref16, want)
    rms = float(np.sqrt(((got - ref16) ** 2).mean() / (ref16 ** 2).mean()))
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    ref_agree = float(np.mean(ref16.argmax(-1) == want.argmax(-1)))
    print(f"bf16 forward: RMS rel difference from the reference's bf16 {rms:.3e}; max rel "
          f"err from f32 {err:.3e} (reference's bf16 {ref_err:.3e}); argmax agreement with "
          f"f32 {agree:.3f} (reference's bf16 {ref_agree:.3f})")
    assert np.isfinite(got).all() and rms < 2e-2 and err <= 2 * ref_err


def test_prefix_seeded_equals_full_prefill():
    """prefill(prefix) then prefill_from(right-padded suffixes, lengths)
    gives prefill(prefix + suffix)'s logits and states, and the
    reference's prefill_from (one row a call, as its engine runs it)."""
    rcfg, rparams, cfg, params = _model()
    plen = 11
    prefix = _tokens(1, plen, seed=11)
    suf = _tokens(2, 9, seed=12)
    lens = np.array([9, 5])
    with torch.no_grad():
        _, entry = api.prefill(params, cfg, {"tokens": torch.from_numpy(prefix)}, max_len=48,
                               lengths=torch.tensor([plen]))
        before = {n: t.clone() for n, t in entry["blocks"][0].items()}
        got, cache = api.prefill_from(params, cfg, entry, torch.from_numpy(suf), plen,
                                      max_len=48, lengths=torch.from_numpy(lens))
    _, rentry = rapi.prefill(rparams, rcfg, {"tokens": jnp.asarray(prefix)}, max_len=48,
                             lengths=jnp.asarray([plen]))
    for i, n in enumerate(lens):
        rgot, rc = rapi.prefill_from(rparams, rcfg, rentry, jnp.asarray(suf[i:i + 1]), plen,
                                     max_len=48, lengths=jnp.asarray(lens[i:i + 1]))
        assert _rel(_np(got[i]), np.asarray(rgot)[0]) < 1e-4
        for k in ("S", "tm_x", "cm_x"):
            assert _rel(_np(cache["blocks"][0][k][:, i]), np.asarray(rc["blocks"][0][k])[:, 0]) \
                < 1e-5
        full = np.concatenate([prefix[0], suf[i, :n]])[None]
        with torch.no_grad():
            want, wcache = api.prefill(params, cfg, {"tokens": torch.from_numpy(full)},
                                       max_len=48)
        assert _rel(_np(got[i, :n]), _np(want[0, plen:])) < 1e-4
        for k in ("S", "tm_x", "cm_x"):
            assert _rel(_np(cache["blocks"][0][k][:, i]), _np(wcache["blocks"][0][k][:, 0])) \
                < 1e-5, k
    for k, t in entry["blocks"][0].items():       # the entry is left as it was
        assert torch.equal(t, before[k])


# ---------------------------------------------------------------------------
# the engine, the pipeline and the session
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recipe,prefix", [("base", TEMPLATE), ("w8", None)])
def test_engine_rows_match_reference(recipe, prefix):
    rcfg, rparams, cfg, params = _model()
    if recipe == "w8":
        rparams, _, _ = RInstanceOptimizer(rparams, rcfg).apply(RRecipe(name="w8", **W8))
        params, _, _ = InstanceOptimizer(params, cfg).apply(Recipe(name="w8", **W8))
        assert isinstance(params["blocks"][0]["cm"]["wv"], QTensor)
        assert not isinstance(params["blocks"][0]["tm"]["wa1"], QTensor)
    ref = REngine(rparams, rcfg, backend="reference", kv_layout="contiguous", **KW)
    want = ref.generate(ROWS, max_new=8, prefix=prefix)
    eng = Engine(params, cfg, device="cpu", **KW)
    assert not eng._paged                        # auto: no paged layout for rwkv
    assert eng.generate(ROWS, max_new=8, prefix=prefix) == want
    st, rst = eng.stats, ref.stats
    assert (st.rows, st.cache_hits, st.prefix_hits, st.prefills, st.prefill_tokens_saved) == \
        (rst.rows, rst.cache_hits, rst.prefix_hits, rst.prefills, rst.prefill_tokens_saved)
    assert (st.prefix_hits > 0) == (prefix is not None)


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


def _calibrated(d_ff=160):
    rcfg, rparams, cfg, params = _model(d_ff)
    toks = _tokens(4, 27, seed=1)
    toks[:, 22:] = 0
    ro, po = RInstanceOptimizer(rparams, rcfg), InstanceOptimizer(params, cfg)
    rst = ro.run_calibration({"tokens": jnp.asarray(toks)})
    st = po.run_calibration({"tokens": torch.from_numpy(toks)})
    return rcfg, rparams, cfg, params, ro, po, rst, st, toks


def test_calibrate_prune_ffn_and_drop_layers_match_reference():
    rcfg, rparams, cfg, params, ro, po, rst, st, toks = _calibrated()
    _stats_equal(rst, st)
    names = {k.split(".", 3)[3] for k in st.weights if k.startswith("blocks.")}
    assert names == {"tm.wr", "tm.wk", "tm.wv", "tm.wg", "tm.wa1", "tm.wa2", "tm.wo",
                     "cm.wk", "cm.wr", "cm.wv"}
    assert set(st.block_sim) == {"blocks.0.0", "blocks.0.1"}
    assert st.weights["blocks.0.1.cm.wv"].count == toks.size
    # no-op KV-group pruning: attention-free
    p2, c2, s2 = P.prune_kv_groups(params, cfg, st, 1)
    assert p2 is params and c2 is cfg and s2 is st
    assert RP.prune_kv_groups(rparams, rcfg, rst, 1)[1] is rcfg
    # so a recipe's kv_keep_frac leaves it as it is, in both pipelines
    assert po.apply(Recipe(name="kv", kv_keep_frac=0.5))[1] == cfg
    assert ro.apply(RRecipe(name="kv", kv_keep_frac=0.5))[1] == rcfg
    # FFN pruning: 160 -> 120 channel-mix channels, each layer its own
    rq, rcfg2, rst2 = RP.prune_ffn(rparams, rcfg, RC.CalibStats(dict(rst.weights),
                                                                rst.block_sim, rst.n_tokens),
                                   0.75)
    q, cfg2, st2 = P.prune_ffn(params, cfg, st, 0.75)
    assert cfg2.d_ff == rcfg2.d_ff == 120
    got = q["blocks"][0]["cm"]
    assert tuple(got["wv"].shape) == (2, 120, 64) and tuple(got["wk"].shape) == (2, 64, 120)
    want = bridge.from_reference(rq, device="cpu")["blocks"][0]["cm"]
    assert torch.equal(got["wv"], want["wv"]) and torch.equal(got["wk"], want["wk"])
    _stats_equal(rst2, st2)
    assert st2.weights["blocks.0.0.cm.wv"].H.shape == (120, 120)
    # layer dropping: the layer of highest block similarity goes, stats re-keyed
    rd, rcfg3, rst3 = RP.drop_layers(rparams, rcfg, rst, 1)
    d, cfg3, st3 = P.drop_layers(params, cfg, st, 1)
    assert cfg3.n_layers == rcfg3.n_layers == 1 and W.depth(d) == 1
    _stats_equal(rst3, st3)
    wd = bridge.from_reference(rd, device="cpu")
    assert torch.equal(d["blocks"][0]["tm"]["wr"], wd["blocks"][0]["tm"]["wr"])


@pytest.mark.parametrize("name", ["w8-absmax", "w8-ffn75"])
def test_recipe_codes_and_configs_match_reference(name):
    """The grid's ``w8-absmax`` and ``w8-ffn75`` (GPTQ, the pruned cm.wv in
    groups of 120); the decay LoRA stays uncompressed in both."""
    rcfg, rparams, cfg, params, ro, po, rst, st, _ = _calibrated()
    grid = {r.name: r for r in POL.default_recipe_space(cfg)}
    rgrid = {r.name: r for r in RPOL.default_recipe_space(rcfg)}
    assert "w8-kv50" not in grid and sorted(grid) == sorted(rgrid)
    rq, rcfg2, rrep = ro.apply(rgrid[name])
    q, cfg2, rep = po.apply(grid[name])
    assert dataclasses.asdict(cfg2) == dataclasses.asdict(from_reference(rcfg2))
    assert cfg2.d_ff == (120 if name == "w8-ffn75" else 160)
    want = bridge.from_reference(rq, device="cpu")
    exact = name == "w8-absmax"

    def walk(a, b, path=""):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                walk(a[k], b[k], f"{path}.{k}")
        elif isinstance(b, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}.{i}")
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

    walk(q, want)
    cm = q["blocks"][0]["cm"]["wv"]
    assert cm.group == (120 if name == "w8-ffn75" else 80)
    assert q["blocks"][0]["tm"]["wa1"].dtype == torch.float32
    assert rep.bytes_after == rrep.bytes_after and rep.params_after == rrep.params_after
    toks2 = _tokens(2, 8, seed=2)
    with torch.no_grad():
        got = _np(api.forward(q, cfg2, {"tokens": torch.from_numpy(toks2)})[0])
    assert _rel(got, np.asarray(rapi.forward(rq, rcfg2, {"tokens": jnp.asarray(toks2)},
                                             remat=False)[0])) < 1e-4


def test_greedy_decode_without_lengths_absorbs_padding_in_both_packages():
    """``greedy_decode`` prefills without ``lengths`` (the reference's
    ``core/policy.py``), so a right-padded row's recurrent state takes in
    its padding: the port computes what the reference computes, and a
    prefill with ``lengths`` gives other logits for the short row only."""
    rcfg, rparams, cfg, params = _model()
    toks = _tokens(2, 12, seed=4)
    lens = np.array([12, 7])
    toks[1, 7:] = 0
    want = RPOL.greedy_decode(rparams, rcfg, jnp.asarray(toks), 6, lengths=jnp.asarray(lens))
    got = POL.greedy_decode(params, cfg, torch.from_numpy(toks), 6,
                            lengths=torch.from_numpy(lens))
    assert np.array_equal(got, np.asarray(want))
    first = np.asarray(want)[:, :1].astype(np.int32)
    last = []
    for ln in (None, lens):
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
        last.append(np.asarray(rl)[:, -1])
    full_row, short_row = _rel(last[0][0], last[1][0]), _rel(last[0][1], last[1][1])
    print(f"full row {full_row:.2e}, short row {short_row:.2e}")
    assert full_row < 1e-6 and short_row > 1e-3, (full_row, short_row)


SESSION_KW = dict(calib_rows=4, eval_rows=2, engine_kw=dict(slots=4, max_len=64,
                                                             buckets=(32, 48)))
SESSION_RECIPES = [dict(name="w8-absmax", **W8),
                   dict(name="w8a-ffn75", ffn_keep_frac=0.75, **W8)]


def test_session_query_matches_reference():
    """Q2 (``llm_correct``) through ``Query.run`` on an f32 session: the
    reference session's table and run statistics, the pruned candidate
    at d_ff 120 (groups of 120 in its cm.wv)."""
    rcfg, rparams, cfg, params = _model(160)
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
