"""Port instance optimizer and flash prefill vs the reference's.

The tiny dense model (tests/conftest.py's shape) in f32, its weights
bridged from the reference's init, is calibrated on the same numpy
tokens by both sides and compressed with five recipes of the reference's
ablation grid (``benchmarks/ablation.py``): ``bs16@50``, ``w8-gptq``,
``w8-smooth.5``, ``24-sparse`` and ``w8+24``.  The compressed leaves must
equal the reference's (GPTQ codes on at least 99.9% of entries; SparseGPT
weights to a bf16 rounding) and greedy ``Engine`` outputs must be
identical.  Reduced gemma2 in bf16 is held to the bf16 bound of
tests/test_torch_model.py.  ``prefill(use_flash=True)`` and
``best_attention``'s long-sequence branch are held to the reference's
(the Pallas flash kernel in interpret mode, and ``flash_attention_jnp``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rregistry  # noqa: E402
from repro.configs.base import ModelConfig as RConfig  # noqa: E402
from repro.core.pipeline import InstanceOptimizer as RInstanceOptimizer  # noqa: E402
from repro.core.pipeline import Recipe as RRecipe  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.serving.engine import Engine as REngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.core import calibrate as C  # noqa: E402
from repro_torch.core.compressed import (BlockSparseTensor, QTensor,  # noqa: E402
                                         kernel_backend)
from repro_torch.core.pipeline import InstanceOptimizer, Recipe  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

RECIPES = {
    "bs16@50": dict(block_bs=16, block_density=0.5),
    "w8-gptq": dict(wbits=8),
    "w8-smooth.5": dict(wbits=8, smooth_alpha=0.5),
    "24-sparse": dict(nm=(2, 4)),
    "w8+24": dict(wbits=8, nm=(2, 4)),
}
TEMPLATE = "Sentiment (pos or neg) of review: "
ROWS = [TEMPLATE + r for r in (
    "great battery life", "arrived broken, no refund", "ok for the price",
    "great battery life", "the strap snapped after two days", "meh")]
KW = dict(slots=4, max_len=128, buckets=(16, 32, 64))


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _config(model, dtype):
    if model == "tiny":
        cfg = RConfig(name="t", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=260,
                      max_seq=256)
    else:
        cfg = rregistry.get_reduced("gemma2-2b").replace(window_size=8)
    return cfg.replace(param_dtype=dtype)


_BASE, _COMPRESSED = {}, {}


def _base(model, dtype):
    if (model, dtype) not in _BASE:
        rcfg = _config(model, dtype)
        rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
        _BASE[model, dtype] = (rcfg, rparams, from_reference(rcfg),
                               bridge.from_reference(rparams, device="cpu"))
    return _BASE[model, dtype]


def _sample(cfg):
    toks = np.random.default_rng(0).integers(4, cfg.vocab_size, (4, 32)).astype(np.int32)
    toks[:, 26:] = 0
    return toks


def _compressed(model, dtype, name):
    """(reference params, port params, reference report, port report),
    each side calibrated on the same sample and compressed with ``name``."""
    key = (model, dtype, name)
    if key not in _COMPRESSED:
        rcfg, rparams, cfg, params = _base(model, dtype)
        toks = _sample(cfg)
        ro = RInstanceOptimizer(rparams, rcfg)
        ro.run_calibration({"tokens": jnp.asarray(toks)})
        rq, _, rrep = ro.apply(RRecipe(name=name, **RECIPES[name]))
        po = InstanceOptimizer(params, cfg)
        po.run_calibration({"tokens": torch.from_numpy(toks)})
        pq, _, prep = po.apply(Recipe(name=name, **RECIPES[name]))
        _COMPRESSED[key] = (rq, pq, rrep, prep)
    return _COMPRESSED[key]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}.{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("name", list(RECIPES))
def test_apply_compressed_leaves_equal_reference(name):
    rq, pq, rrep, prep = _compressed("tiny", "float32", name)
    want = dict(_leaves(bridge.from_reference(rq, device="cpu")))
    got = dict(_leaves(pq))
    assert sorted(got) == sorted(want)
    kinds = set()
    for path, w in want.items():
        g = got[path]
        assert type(g) is type(w), path
        kinds.add(type(g).__name__)
        if isinstance(w, QTensor):
            assert (g.bits, g.group, g.shape) == (w.bits, w.group, w.shape), path
            assert torch.mean((g.q == w.q).float()) >= 0.999, path
            assert _rel(g.scale, w.scale) < 1e-6, path
            assert (g.in_scale is None) == (w.in_scale is None), path
            if w.in_scale is not None:
                assert _rel(g.in_scale, w.in_scale) < 1e-5, path
        elif isinstance(w, BlockSparseTensor):
            assert g.bs == w.bs and g.idx.shape == w.idx.shape, path
            assert torch.equal(g.w, w.w) and torch.equal(g.mask, w.mask), path
            assert torch.equal(g.idx, w.idx), path
        else:
            assert g.dtype == w.dtype, path
            # SparseGPT runs in float64 on both sides; the bf16 rounding of
            # a value that sits on a rounding boundary may go either way
            d = (g.float() - w.float()).abs()
            assert bool((d <= w.float().abs() * 2 ** -7 + 1e-7).all()), path
            assert torch.mean(((g != 0) == (w != 0)).float()) >= 0.999, path
    expect = {"bs16@50": "BlockSparseTensor", "24-sparse": "Tensor"}.get(name, "QTensor")
    assert expect in kinds
    assert prep.bytes_after == rrep.bytes_after
    assert prep.params_after == rrep.params_after
    assert [e["kind"] for e in prep.per_weight] == [e["kind"] for e in rrep.per_weight]


def _q_matmul_in_scale_once(x, w):
    """The reference's Pallas-kernel semantics (``kernels/ref.py``
    ``quant_matmul``): x * in_scale, then the codes times their scales.
    The reference's jnp path also folds ``in_scale`` into the weight
    (applying it twice, ROADMAP queue 3), so for SmoothQuant recipes the
    reference engine is run with this in its place."""
    from repro.kernels import ref as rref
    y = rref.quant_matmul(x, w.unpack(), w.scale, group=w.group, in_scale=w.in_scale)
    return y.astype(x.dtype)


@pytest.mark.parametrize("name", list(RECIPES))
def test_engine_greedy_outputs_identical_after_apply(monkeypatch, name):
    from repro.core import compressed as RC
    rcfg, _, cfg, _ = _base("tiny", "float32")
    rq, pq, _, _ = _compressed("tiny", "float32", name)
    if RECIPES[name].get("smooth_alpha"):
        monkeypatch.setattr(RC, "_q_matmul_jnp", _q_matmul_in_scale_once)
    want = REngine(rq, rcfg, backend="reference", **KW).generate(ROWS, max_new=8,
                                                                 prefix=TEMPLATE)
    got = Engine(pq, cfg, device="cpu", **KW).generate(ROWS, max_new=8, prefix=TEMPLATE)
    assert got == want
    if name == "bs16@50":
        # the cuda backend on CPU tensors: the block-sparse wrapper's plain version
        calls = []
        orig = ops.block_sparse_matmul

        def spy(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        try:
            ops.block_sparse_matmul = spy
            eng = Engine(pq, cfg, device="cpu", backend="cuda", **KW)
            assert eng.generate(ROWS, max_new=8, prefix=TEMPLATE) == want
        finally:
            ops.block_sparse_matmul = orig
        assert calls and eng.stats.backend == "cuda"


def _port_stats(rstats):
    """The reference's calibration statistics as the port's."""
    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a))
    return C.CalibStats({k: C.WeightStats(shape=w.shape, count=w.count, H=t(w.H),
                                          sqnorm=t(w.sqnorm), amax=t(w.amax))
                         for k, w in rstats.weights.items()},
                        dict(rstats.block_sim), rstats.n_tokens)


@pytest.mark.parametrize("name", ["bs16@50", "w8-gptq"])
def test_bf16_reduced_gemma2_compressed_forward(name):
    """In bf16 the two frameworks' calibration activations differ by bf16
    roundings, enough to swap a near-tied block between two masks; so the
    port compresses with the reference's statistics here (calibration
    itself is held to the reference in f32, tests/test_torch_calibrate.py)."""
    rcfg, rparams, cfg, params = _base("gemma2", "bfloat16")
    toks = _sample(cfg)
    ro = RInstanceOptimizer(rparams, rcfg)
    ro.run_calibration({"tokens": jnp.asarray(toks)})
    rq, _, _ = ro.apply(RRecipe(name=name, **RECIPES[name]))
    po = InstanceOptimizer(params, cfg)
    po.stats = _port_stats(ro.stats)
    pq, _, _ = po.apply(Recipe(name=name, **RECIPES[name]))
    got = dict(_leaves(pq))
    for path, w in _leaves(bridge.from_reference(rq, device="cpu")):
        if isinstance(w, BlockSparseTensor):
            assert torch.equal(got[path].mask, w.mask), path
            assert torch.equal(got[path].idx, w.idx), path
    toks = np.random.default_rng(1).integers(4, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = rapi.forward(rq, rcfg, {"tokens": jnp.asarray(toks)})
    got, _ = api.forward(pq, cfg, {"tokens": torch.from_numpy(toks)})
    assert _rel(got.float().numpy(), want) < 6e-2     # TOL of test_torch_model.py
    agree = np.mean(got.float().numpy().argmax(-1) == np.asarray(want).argmax(-1))
    print(f"{name}: bf16 greedy agreement {agree:.3f}")


@pytest.mark.parametrize("model", ["tiny", "gemma2"])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_prefill_use_flash_matches_reference(model, backend):
    """Under ``"cuda"`` on CPU tensors the flash wrapper runs (its plain
    version) once per layer."""
    rcfg, rparams, cfg, params = _base(model, "float32")
    toks = np.random.default_rng(2).integers(4, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, wcache = rapi.prefill(rparams, rcfg, {"tokens": jnp.asarray(toks)},
                                max_len=64, compact_local=False, use_flash=True)
    calls = []
    orig = ops.flash_attention

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    try:
        ops.flash_attention = spy
        with kernel_backend(backend):
            got, gcache = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                                      max_len=64, compact_local=False, use_flash=True)
            fwd, _ = api.forward(params, cfg, {"tokens": torch.from_numpy(toks)},
                                 use_flash=True)
    finally:
        ops.flash_attention = orig
    assert len(calls) == 2 * cfg.n_layers * (backend == "cuda")
    assert _rel(got.numpy(), want) < 1e-4
    assert _rel(fwd.numpy(), want) < 1e-4
    assert np.array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))
    for g, w in zip(gcache["blocks"], wcache["blocks"]):
        assert _rel(g["k"].numpy(), w["k"]) < 1e-4 and _rel(g["v"].numpy(), w["v"]) < 1e-4


@pytest.mark.parametrize("kind,window", [("G", 8), ("L", 2048), ("L", 128)])
def test_best_attention_long_branch_matches_reference(monkeypatch, kind, window):
    """S = T = 1024 reaches the blocked-flash branch once the threshold is
    lowered in both modules (here only); a local layer whose window covers
    S takes it too, with its window."""
    monkeypatch.setattr(RL, "_FLASH_MIN_ELEMS", 1 << 20)
    monkeypatch.setattr(RL, "_FLASH_MIN_ELEMS_OPT", 1 << 20)
    monkeypatch.setattr(L, "_FLASH_MIN_ELEMS", 1 << 20)
    rcfg = _config("gemma2", "float32").replace(window_size=window)
    cfg = from_reference(rcfg)
    rng = np.random.default_rng(window)
    q = rng.normal(size=(1, 1024, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, 1024, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, 1024, 2, 16)).astype(np.float32)
    want = RL.best_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             kind=kind, cfg=rcfg)
    calls = []
    orig = L.flash_attention

    def spy(*a, **kw):
        calls.append(kw["window"])
        return orig(*a, **kw)

    monkeypatch.setattr(L, "flash_attention", spy)
    got = L.best_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           kind=kind, cfg=cfg)
    long_branch = not (kind == "L" and 1024 > window)
    assert calls == ([window if kind == "L" else 0] if long_branch else [])
    assert _rel(got.numpy(), want) < 1e-5
