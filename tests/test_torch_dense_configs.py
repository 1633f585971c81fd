"""Dense configs the ported transformer covers beyond gemma2-2b:
``mistral-nemo-12b`` (GQA 32/8, head dim 128), ``gemma3-1b`` (MQA,
``LLLLLG``, a local rope theta of 10k, window 512, a tied vocab) and
``granite-20b`` (MQA 48/1, an ungated GELU MLP, an untied vocab).

Each config equals the reference's field for field, at full width and
reduced.  The reduced forms in f32, the reference's weights bridged into
the port, give logits within 1e-4 of the largest and identical greedy
tokens through ``forward``, ``prefill`` and a paged decode step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rregistry  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference, registry  # noqa: E402
from repro_torch.models import api  # noqa: E402

ARCHS = ["mistral-nemo-12b", "gemma3-1b", "granite-20b"]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        rcfg = rregistry.get_reduced(arch).replace(param_dtype="float32")
        rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
        _MODELS[arch] = (rcfg, rparams, from_reference(rcfg),
                         bridge.from_reference(rparams, device="cpu"))
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    for mine, ref in ((registry.get_config(arch), rregistry.get_config(arch)),
                      (registry.get_reduced(arch), rregistry.get_reduced(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(from_reference(ref))
        assert mine.param_count() == ref.param_count()
    assert arch in registry.ARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_forward_and_prefill_match_reference(arch):
    rcfg, rparams, cfg, params = _model(arch)
    # gemma3's reduced window is 64: 128 tokens take the local-block branch
    toks = np.random.default_rng(1).integers(4, cfg.vocab_size, (2, 128)).astype(np.int32)
    want, _ = rapi.forward(rparams, rcfg, {"tokens": jnp.asarray(toks)})
    got, _ = api.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert _rel(got.numpy(), want) < 1e-4
    assert np.array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))
    wl, _ = rapi.prefill(rparams, rcfg, {"tokens": jnp.asarray(toks)}, max_len=160,
                         compact_local=False)
    gl, _ = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)}, max_len=160,
                        compact_local=False)
    assert _rel(gl.numpy(), wl) < 1e-4
    assert np.array_equal(gl.numpy().argmax(-1), np.asarray(wl).argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_engine_greedy_rows_match_reference(arch):
    from repro.serving.engine import Engine as REngine
    from repro_torch.serving.engine import Engine
    rcfg, rparams, cfg, params = _model(arch)
    rows = ["Classify: great battery life", "Classify: arrived broken",
            "Classify: ok for the price", "Classify: meh"]
    kw = dict(slots=4, max_len=128, buckets=(16, 32, 64))
    want = REngine(rparams, rcfg, backend="reference", **kw).generate(rows, max_new=8)
    got = Engine(params, cfg, device="cpu", **kw).generate(rows, max_new=8)
    assert got == want
