"""Port serving engine vs reference serving engine.

The tiny dense model (tests/conftest.py's shape) in f32, its weights
bridged from the reference's init, serves the same OLAP-style rows
through the reference ``Engine(backend="reference")`` and the port's
``Engine(device="cpu")``: greedy outputs must be identical, with and
without a shared template prefix, for the base model and for its
``w8-absmax`` instance.

The contiguous KV layout, as tests/test_paged_cache.py holds it in the
reference: contiguous, paged (reference backend) and paged on the cuda
backend (the kernels' plain versions on the CPU) give identical rows
for the tiny dense model, the reduced qwen2-moe and the reduced zamba2
(f32), with and without a shared prefix; ``auto`` picks the paged layout
with a block of 32 at ``max_len=128`` and falls back to the contiguous
one when the block would hold fewer than 8 positions, which an explicit
``paged`` keeps; slots retired and reused over three waves stay
identical across the layouts.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import registry as rregistry  # noqa: E402
from repro.configs.base import ModelConfig as RConfig  # noqa: E402
from repro.core.pipeline import InstanceOptimizer as RInstanceOptimizer  # noqa: E402
from repro.core.pipeline import Recipe as RRecipe  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.serving.engine import Engine as REngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.core.compressed import QTensor, param_bytes  # noqa: E402
from repro_torch.core.pipeline import InstanceOptimizer, Recipe  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

TEMPLATE = "Sentiment (pos or neg) of review: "
ROWS = [TEMPLATE + r for r in (
    "great battery life", "arrived broken, no refund", "ok for the price",
    "great battery life", "the strap snapped after two days",
    "works exactly as described, five stars", "meh")]
KW = dict(slots=4, max_len=128, buckets=(16, 32, 64))
W8 = dict(name="w8-absmax", wbits=8, quant_method="absmax")
_MODELS = {}


def _models(recipe):
    """(reference cfg, reference params, port cfg, port params)."""
    if recipe not in _MODELS:
        rcfg = RConfig(name="t", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=260,
                       max_seq=256, param_dtype="float32")
        rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
        cfg = from_reference(rcfg)
        params = bridge.from_reference(rparams, device="cpu")
        if recipe == "w8":
            rparams, _, _ = RInstanceOptimizer(rparams, rcfg).apply(RRecipe(**W8))
            params, _, report = InstanceOptimizer(params, cfg).apply(Recipe(**W8))
            assert report.compression > 1.0
            ref_q = bridge.from_reference(rparams, device="cpu")
            for u, blk in enumerate(params["blocks"]):
                for name in ("wq", "wk", "wv", "wo"):
                    got, want = blk["attn"][name], ref_q["blocks"][u]["attn"][name]
                    assert isinstance(got, QTensor) and got.q.shape == want.q.shape
                    assert torch.equal(got.q, want.q) and torch.equal(got.scale, want.scale)
            assert param_bytes(params) == param_bytes(ref_q)
        _MODELS[recipe] = (rcfg, rparams, cfg, params)
    return _MODELS[recipe]


@pytest.mark.parametrize("recipe", ["base", "w8"])
@pytest.mark.parametrize("prefix", [None, TEMPLATE])
def test_engine_greedy_outputs_identical(recipe, prefix):
    rcfg, rparams, cfg, params = _models(recipe)
    ref = REngine(rparams, rcfg, backend="reference", **KW)
    want = ref.generate(ROWS, max_new=8, prefix=prefix)
    got_engine = Engine(params, cfg, device="cpu", **KW)
    got = got_engine.generate(ROWS, max_new=8, prefix=prefix)
    assert got == want
    st, rst = got_engine.stats, ref.stats
    assert st.backend == "reference"
    assert (st.rows, st.cache_hits, st.prefix_hits, st.prefills) == \
        (rst.rows, rst.cache_hits, rst.prefix_hits, rst.prefills)
    assert st.cache_hits == 1                       # the duplicate row
    assert (st.prefix_hits > 0) == (prefix is not None)
    # the cuda backend on CPU tensors: the kernel wrappers' plain versions
    cuda_engine = Engine(params, cfg, device="cpu", backend="cuda", **KW)
    assert cuda_engine.generate(ROWS, max_new=8, prefix=prefix) == want
    assert cuda_engine.stats.backend == "cuda"


def test_engine_async_api_and_stream():
    """submit/step/drain and generate_stream give generate's rows."""
    _, _, cfg, params = _models("base")
    want = Engine(params, cfg, device="cpu", **KW).generate(ROWS, max_new=6)
    eng = Engine(params, cfg, device="cpu", **KW)
    reqs = [eng.submit(r, max_new=6) for r in ROWS[:3]]
    pending = eng.step_begin()
    reqs += [eng.submit(r, max_new=6) for r in ROWS[3:]]
    eng.step_finish(pending)
    eng.drain()
    assert [r.text for r in reqs] == want
    stream = Engine(params, cfg, device="cpu", **KW)
    assert stream.generate_stream(iter(ROWS), max_new=6, chunk=2) == want


def test_engine_cuda_device_raises_without_card():
    _, _, cfg, params = _models("base")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(params, cfg, **KW)
    from repro_torch.launch.mesh import make_mesh
    with pytest.raises(ValueError, match="not both"):
        Engine(params, cfg, device="cpu", mesh=make_mesh((1, 2), ("data", "model"),
                                                         device="cpu"), **KW)


# ---------------------------------------------------------------------------
# the contiguous layout
# ---------------------------------------------------------------------------

PROMPTS = ["fix: pyton", "fix: javascrpt", "fix: golag", "fix: rst",
           "fix: kotln", "fix: hsakell"]


def _family_model(arch):
    """Port (cfg, params) of the tiny dense model (``arch`` None) or a
    reduced registry architecture, f32, bridged from the reference."""
    if arch is None:
        _, _, cfg, params = _models("base")
        return cfg, params
    rcfg = rregistry.get_reduced(arch).replace(vocab_size=260, param_dtype="float32")
    rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
    return from_reference(rcfg), bridge.from_reference(rparams, device="cpu")


def _serve(cfg, params, prompts, *, kv_layout, backend="auto", prefix=None, slots=2,
           max_len=128):
    eng = Engine(params, cfg, device="cpu", slots=slots, max_len=max_len,
                 buckets=(16, 48, 64), use_result_cache=False, kv_layout=kv_layout,
                 backend=backend)
    return eng, eng.generate(prompts, max_new=8, prefix=prefix)


@pytest.mark.parametrize("arch", [None, "qwen2-moe-a2.7b", "zamba2-7b"])
def test_contiguous_equals_paged(arch):
    cfg, params = _family_model(arch)
    for prefix in (None, "fix: "):
        ec, base = _serve(cfg, params, PROMPTS, kv_layout="contiguous", prefix=prefix)
        ep, paged = _serve(cfg, params, PROMPTS, kv_layout="paged", prefix=prefix)
        ek, kern = _serve(cfg, params, PROMPTS, kv_layout="paged", backend="cuda",
                          prefix=prefix)
        assert not ec._paged and ep._paged and ek._paged
        assert paged == base and kern == base
        assert ec.stats.prefix_hits == ep.stats.prefix_hits
        assert (ec.stats.prefix_hits > 0) == (prefix is not None)


def test_auto_layout_picks_paged_for_dense():
    cfg, params = _family_model(None)
    eng = Engine(params, cfg, device="cpu", max_len=128)
    assert eng._paged and eng._block_size == 32
    assert eng.stats.backend == "reference"         # auto on the CPU


def test_tiny_block_auto_falls_back_to_contiguous():
    cfg, params = _family_model(None)
    # max_len=36: the largest power-of-two block dividing it is 4 (< 8), so
    # auto takes the contiguous layout; an explicit "paged" keeps block 4
    eng = Engine(params, cfg, device="cpu", max_len=36, buckets=(16, 32))
    assert not eng._paged
    eng2 = Engine(params, cfg, device="cpu", max_len=36, buckets=(16, 32),
                  kv_layout="paged")
    assert eng2._paged and eng2._block_size == 4
    assert eng.generate(PROMPTS[:3], max_new=4) == eng2.generate(PROMPTS[:3], max_new=4)


def test_slot_retire_and_reuse_stays_identical():
    """More requests than slots: every slot is retired and reused (three
    waves or more through 2 slots, ragged lengths so that retirement
    interleaves)."""
    cfg, params = _family_model(None)
    prompts = [f"row {i}: " + "v" * (3 + 5 * (i % 3)) for i in range(7)]
    _, base = _serve(cfg, params, prompts, kv_layout="contiguous")
    eng, outs = _serve(cfg, params, prompts, kv_layout="paged")
    assert outs == base
    used, shared = eng._alloc.stats()
    assert shared == 0 and not eng._alloc._occupied
