"""Port model vs reference model on bridged weights.

The reference's params (``jax.random`` init) are bridged into the port
(``repro_torch.bridge``), and the same numpy tokens go through both.
Two configs — the shared ``tiny_dense`` shape (tests/conftest.py) and
the reduced gemma2-2b (local/global window, softcaps, post-norms, scaled
tied embeddings) — each in f32 and bf16.  Tolerances, relative to the
largest logit: f32 1e-4 with identical greedy tokens; bf16 2e-2 on
``tiny`` and 6e-2 on reduced gemma2, with token agreement reported.
The bf16 bound is the reference's own noise: the frameworks round bf16
at different places (XLA also fuses bf16 chains with excess precision).
On reduced gemma2 (4 layers, softcaps, post-norms) the reference's bf16
logits sit 5.1e-2 from its f32 logits on the same weights, and the port
reads 3.2e-2 (forward), 4.2e-2 (prefill) and 4.7e-2 (paged decode) from
the reference, so 2e-2 cannot hold there; on ``tiny`` the same readings
are 1.3e-2 and 1.2e-2 / 1.0e-2 / 1.4e-2.
``test_bf16_port_is_no_noisier_than_reference`` holds the port's bf16
error against f32 to 1.1x the reference's own.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rregistry  # noqa: E402
from repro.configs.base import ModelConfig as RConfig  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.core.compressed import kernel_backend  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api  # noqa: E402

# bf16 bounds from the readings in the module docstring
TOL = {("tiny", "float32"): 1e-4, ("gemma2", "float32"): 1e-4,
       ("tiny", "bfloat16"): 2e-2, ("gemma2", "bfloat16"): 6e-2}
CASES = [(m, d) for m in ("tiny", "gemma2") for d in ("float32", "bfloat16")]
MAX_LEN = 64


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _np(t):
    return t.float().numpy()


def _config(model, dtype):
    if model == "tiny":
        cfg = RConfig(name="t", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=260,
                      max_seq=256)
    else:
        cfg = rregistry.get_reduced("gemma2-2b").replace(window_size=8)
    return cfg.replace(param_dtype=dtype)


_MODELS = {}


def _model(model, dtype):
    """(reference cfg, reference params, port cfg, port params)."""
    if (model, dtype) not in _MODELS:
        rcfg = _config(model, dtype)
        rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
        _MODELS[model, dtype] = (rcfg, rparams, from_reference(rcfg),
                                 bridge.from_reference(rparams, device="cpu"))
    return _MODELS[model, dtype]


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(4, cfg.vocab_size, (B, S)).astype(np.int32)


def _check(got, want, model, dtype, *, tokens=True):
    assert _rel(_np(got), want) < TOL[model, dtype], _rel(_np(got), want)
    if tokens and dtype == "float32":
        assert np.array_equal(_np(got).argmax(-1), np.asarray(want, np.float32).argmax(-1))


def _check_cache(got, want, model, dtype):
    for sec in ("blocks", "tail"):
        for g, w in zip(got[sec], want[sec]):
            for name in ("k", "v"):
                assert _rel(_np(g[name]), w[name]) < TOL[model, dtype]


@pytest.mark.parametrize("model,dtype", CASES)
def test_forward_matches_reference(model, dtype):
    rcfg, rparams, cfg, params = _model(model, dtype)
    toks = _tokens(cfg, 2, 24, 1)
    want, _ = rapi.forward(rparams, rcfg, {"tokens": jnp.asarray(toks)})
    got, _ = api.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (2, 24, cfg.vocab_size)
    _check(got, want, model, dtype)


@pytest.mark.parametrize("model,dtype", CASES)
def test_prefill_matches_reference(model, dtype):
    rcfg, rparams, cfg, params = _model(model, dtype)
    toks = _tokens(cfg, 2, 24, 2)
    want, wcache = rapi.prefill(rparams, rcfg, {"tokens": jnp.asarray(toks)},
                                max_len=MAX_LEN, compact_local=False)
    got, gcache = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                              max_len=MAX_LEN, compact_local=False)
    _check(got, want, model, dtype)
    assert gcache["blocks"][0]["k"].shape == wcache["blocks"][0]["k"].shape
    _check_cache(gcache, wcache, model, dtype)


@pytest.mark.parametrize("model,dtype", CASES)
def test_prefill_from_matches_reference(model, dtype):
    """A batch-1 prefix state seeds two suffix rows (the engine's use);
    the reference gets the prefix broadcast to both rows."""
    rcfg, rparams, cfg, params = _model(model, dtype)
    prefix, suffix = _tokens(cfg, 1, 16, 3), _tokens(cfg, 2, 7, 4)
    _, rpre = rapi.prefill(rparams, rcfg, {"tokens": jnp.asarray(prefix)},
                           max_len=MAX_LEN, compact_local=False)
    rpre2 = jax.tree.map(lambda a: jnp.repeat(a, 2, axis=-4), rpre)
    want, wcache = rapi.prefill_from(rparams, rcfg, rpre2, jnp.asarray(suffix), 16,
                                     max_len=MAX_LEN)
    _, pre = api.prefill(params, cfg, {"tokens": torch.from_numpy(prefix)},
                         max_len=MAX_LEN, compact_local=False)
    got, gcache = api.prefill_from(params, cfg, pre, torch.from_numpy(suffix), 16,
                                   max_len=MAX_LEN)
    _check(got, want, model, dtype)
    _check_cache(gcache, wcache, model, dtype)
    assert pre["blocks"][0]["k"].shape[1] == 1          # the prefix is not modified
    assert not pre["blocks"][0]["k"][:, :, 16:].any()


def _rows_vmapped(cache):
    """Batched-prefill cache [R, n, T, ...] -> the reference engine's
    vmapped per-row layout [n, R, 1, T, ...]."""
    return {"blocks": [jax.tree.map(lambda a: jnp.moveaxis(a, 1, 0)[:, :, None], e)
                       for e in cache["blocks"]],
            "tail": [jax.tree.map(lambda a: a[:, None], e) for e in cache["tail"]]}


_BS, _B = 16, 2
_LENS = np.array([5, 9])
_DECODE = {}


def _reference_decode(model, dtype):
    """The reference's run: prefill two rows, scatter them into a pool
    through scrambled tables, then 8 jitted decode steps, each fed the
    previous step's greedy tokens.  Cached per config."""
    if (model, dtype) in _DECODE:
        return _DECODE[model, dtype]
    rcfg, rparams, cfg, _ = _model(model, dtype)
    nblk = MAX_LEN // _BS
    toks = _tokens(cfg, _B, 16, 5)
    rng = np.random.default_rng(6)
    tables = rng.permutation(_B * nblk + 2)[:_B * nblk].astype(np.int32).reshape(_B, nblk)
    _, rrows = rapi.prefill(rparams, rcfg, {"tokens": jnp.asarray(toks)},
                            max_len=MAX_LEN, compact_local=False)
    rstate = rapi.init_paged_cache(rcfg, _B, _B * nblk + 3, _BS)
    rstate = rapi.paged_insert(rcfg, rstate, _rows_vmapped(rrows), None,
                               jnp.asarray(tables), block_size=_BS)
    inserted = jax.tree.map(np.asarray, rstate)
    step = jax.jit(lambda st, t, p: rapi.paged_decode_step(
        rparams, rcfg, st, jnp.asarray(tables), t, p, block_size=_BS,
        max_len=MAX_LEN))
    tok, pos = toks[np.arange(_B), _LENS - 1], _LENS.copy()
    feeds, logits = [], []
    for _ in range(8):
        feeds.append((tok, pos))
        want, rstate = step(rstate, jnp.asarray(tok[:, None]), jnp.asarray(pos, jnp.int32))
        logits.append(np.asarray(want, np.float32))
        tok = logits[-1][:, -1].argmax(-1).astype(np.int32)
        pos = pos + 1
    _DECODE[model, dtype] = (toks, tables, inserted, feeds, logits,
                             jax.tree.map(np.asarray, rstate))
    return _DECODE[model, dtype]


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("model,dtype", CASES)
def test_paged_decode_matches_reference(model, dtype, backend):
    """Admission scatter and 8 paged decode steps against the reference's
    ``paged_insert`` / ``paged_decode_step``, same tokens fed to both.
    ``kernel_backend("cuda")`` on CPU tensors runs the kernel wrappers'
    plumbing with their plain versions."""
    _, _, cfg, params = _model(model, dtype)
    toks, tables, inserted, feeds, logits, final = _reference_decode(model, dtype)
    _, rows = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                          max_len=MAX_LEN, compact_local=False)
    state = api.init_paged_cache(cfg, _B, tables.size + 3, _BS, device="cpu")
    api.paged_insert(cfg, state, rows, None, tables, block_size=_BS)
    _check_cache(state, inserted, model, dtype)
    agree = []
    for (tok, pos), want in zip(feeds, logits):
        with kernel_backend(backend):
            got, state = api.paged_decode_step(
                params, cfg, state, torch.from_numpy(tables),
                torch.from_numpy(tok[:, None]), torch.from_numpy(pos),
                block_size=_BS, max_len=MAX_LEN)
        _check(got, want, model, dtype)
        agree.append(np.mean(_np(got[:, -1]).argmax(-1) == want[:, -1].argmax(-1)))
    _check_cache(state, final, model, dtype)
    print(f"{model}/{dtype}/{backend}: greedy agreement {np.mean(agree):.3f}")


@pytest.mark.parametrize("backend,calls", [(None, 0), ("reference", 0), ("auto", 0),
                                           ("cuda", 2)])
def test_paged_decode_attention_follows_scoped_backend(monkeypatch, backend, calls):
    """Attention takes its backend from the same scope as the int8 matmul:
    the paged kernel's wrapper runs once per layer under ``"cuda"``, and
    never under ``"reference"`` or under ``"auto"`` on CPU tensors."""
    _, _, cfg, params = _model("tiny", "float32")
    nblk = MAX_LEN // _BS
    state = api.init_paged_cache(cfg, _B, _B * nblk + 1, _BS, device="cpu")
    tables = torch.arange(_B * nblk, dtype=torch.int32).reshape(_B, nblk)
    seen = []
    orig = ops.paged_attention

    def spy(*a, **k):
        seen.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(ops, "paged_attention", spy)
    with kernel_backend(backend):
        got, _ = api.paged_decode_step(params, cfg, state, tables,
                                       torch.tensor([[5], [7]]), torch.tensor([3, 4]),
                                       block_size=_BS, max_len=MAX_LEN)
    assert len(seen) == calls == 2 * (backend == "cuda")
    assert got.shape == (_B, 1, cfg.vocab_size) and torch.isfinite(got).all()


def test_config_and_param_count_match_reference():
    rcfg = rregistry.get_config("gemma2-2b")
    cfg = from_reference(rcfg)
    from repro_torch.configs import registry
    assert cfg == registry.get_config("gemma2-2b")
    assert cfg.dtype == torch.bfloat16 and cfg.pattern() == rcfg.pattern()
    assert cfg.param_count() == rcfg.param_count()
    assert registry.get_reduced("gemma2-2b") == from_reference(
        rregistry.get_reduced("gemma2-2b"))


@pytest.mark.parametrize("model", ["tiny", "gemma2"])
def test_bf16_port_is_no_noisier_than_reference(model):
    """Against the f32 run of the same (bf16-valued) weights, the port's
    bf16 logits are no further off than the reference's bf16 logits."""
    rcfg, rparams, cfg, params = _model(model, "bfloat16")
    toks = _tokens(cfg, 2, 24, 1)
    ref16, _ = rapi.forward(rparams, rcfg, {"tokens": jnp.asarray(toks)})
    r32 = jax.tree.map(lambda a: a.astype(jnp.float32), rparams)
    truth, _ = rapi.forward(r32, rcfg.replace(param_dtype="float32"),
                            {"tokens": jnp.asarray(toks)})
    got, _ = api.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    ref_err, port_err = _rel(ref16, truth), _rel(_np(got), truth)
    print(f"{model}: bf16 error vs f32, reference {ref_err:.4f} port {port_err:.4f}")
    assert ref_err < TOL[model, "bfloat16"]
    assert port_err <= 1.1 * ref_err
