"""Port sampler (``serving/sampler.py``) with ``temperature > 0``.

``torch`` and ``jax.random`` draw different streams from one seed, so
the sampled tokens are held to their distribution: 20,000 draws with
``temperature=0.8, top_k=8`` on fixed logits never leave the top 8, and
their frequencies lie within a total-variation distance of TV_EXACT of
``softmax(logits / T)`` restricted to the top 8, and within TV_PAIR of
the reference sampler's frequencies drawn with ``jax.random``.  For
8 tokens the sampling noise of 20,000 draws is under 0.008 in total
variation (under 0.011 between two samples); the measured distances on
these seeds are about 0.004.
An ``Engine`` that samples gives the same rows when run again from the
same seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serving import sampler as RSM  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.sampler import SamplingConfig, sample  # noqa: E402

N, V, T, K = 20_000, 64, 0.8, 8
TV_EXACT = 0.02
TV_PAIR = 0.03


def _logits():
    return np.random.default_rng(5).normal(scale=2.0, size=V).astype(np.float32)


def _law(logits):
    top = np.argsort(-logits, kind="stable")[:K]
    z = logits[top].astype(np.float64) / T
    p = np.exp(z - z.max())
    law = np.zeros(V)
    law[top] = p / p.sum()
    return top, law


def _freq(tokens):
    return np.bincount(np.asarray(tokens).ravel(), minlength=V) / np.asarray(tokens).size


def _tv(p, q):
    return 0.5 * float(np.abs(p - q).sum())


@pytest.fixture(scope="module")
def draws():
    logits = _logits()
    gen = torch.Generator().manual_seed(0)
    got = sample(torch.from_numpy(np.broadcast_to(logits, (N, V)).copy()), gen,
                 temperature=T, top_k=K)
    want = RSM.sample(jnp.broadcast_to(jnp.asarray(logits), (N, V)),
                      jax.random.PRNGKey(0), temperature=T, top_k=K)
    return logits, got.numpy(), np.asarray(want)


def test_samples_never_leave_the_top_k(draws):
    logits, got, want = draws
    top, _ = _law(logits)
    assert got.shape == (N,) and got.dtype == np.int32
    assert set(np.unique(got)) <= set(top.tolist())
    assert set(np.unique(want)) <= set(top.tolist())


def test_frequencies_match_the_tempered_softmax(draws):
    logits, got, _ = draws
    _, law = _law(logits)
    assert _tv(_freq(got), law) < TV_EXACT


def test_frequencies_match_the_reference_sampler(draws):
    logits, got, want = draws
    _, law = _law(logits)
    assert _tv(_freq(want), law) < TV_EXACT       # the reference obeys the law too
    assert _tv(_freq(got), _freq(want)) < TV_PAIR


def test_top_k_zero_and_greedy():
    logits = torch.from_numpy(_logits())[None].repeat(4, 1)
    assert torch.equal(sample(logits, None), torch.argmax(logits, -1).to(torch.int32))
    full = sample(logits.repeat(2000, 1), torch.Generator().manual_seed(1), temperature=T)
    assert len(torch.unique(full)) > K             # no top-k: the tail is reachable


def test_sampling_engine_replays_from_its_seed():
    cfg = ModelConfig(name="s", family="dense", n_layers=1, d_model=32, n_heads=2,
                      n_kv_heads=1, d_ff=64, vocab_size=260, max_seq=128,
                      param_dtype="float32")
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    rows = [f"row {i}: value" for i in range(5)]

    def run(seed):
        eng = Engine(params, cfg, slots=2, max_len=48, buckets=(16,), device="cpu",
                     use_result_cache=False,
                     sampling=SamplingConfig(temperature=T, top_k=K, seed=seed))
        return [r.out_ids for r in eng.generate(rows, max_new=6, return_requests=True)]

    first = run(3)
    assert run(3) == first
    assert run(4) != first
