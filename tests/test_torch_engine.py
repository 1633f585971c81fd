"""Port serving engine vs reference serving engine.

The tiny dense model (tests/conftest.py's shape) in f32, its weights
bridged from the reference's init, serves the same OLAP-style rows
through the reference ``Engine(backend="reference")`` and the port's
``Engine(device="cpu")``: greedy outputs must be identical, with and
without a shared template prefix, for the base model and for its
``w8-absmax`` instance.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

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
    with pytest.raises(NotImplementedError):
        Engine(params, cfg, device="cpu", kv_layout="contiguous", **KW)
