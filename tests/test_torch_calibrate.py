"""Port calibration and GPTQ vs the reference's ``core/calibrate.py`` and
``core/quantize.py``.

Calibration runs the tiny dense model (tests/conftest.py's shape) in f32
on the same numpy tokens, with the reference's weights bridged into the
port: every weight's sqnorm, amax, Hessian and row count, and every
block's input/output cosine, within 1e-5 relative (the two sum in other
orders).  GPTQ runs on the same Hessian in float64 on both sides: codes
equal on at least 99.9% of entries, scales within 1e-6 relative.
"""
import importlib
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as RConfig  # noqa: E402
from repro.core import calibrate as RC  # noqa: E402
from repro.core import quantize as RQ  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.core import calibrate as C  # noqa: E402
from repro_torch.core import quantize as Q  # noqa: E402


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = got.double().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.fixture(scope="module")
def tiny():
    rcfg = RConfig(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, d_ff=128, vocab_size=260, max_seq=256,
                   param_dtype="float32")
    rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, rparams, from_reference(rcfg), bridge.from_reference(rparams, device="cpu")


@pytest.mark.parametrize("hessian", [True, False])
def test_calibrate_stats_match_reference(tiny, hessian):
    rcfg, rparams, cfg, params = tiny
    toks = np.random.default_rng(0).integers(4, 260, (4, 24)).astype(np.int32)
    toks[:, 18:] = 0                                # right padding is recorded too
    want = RC.calibrate(rparams, rcfg, {"tokens": jnp.asarray(toks)}, hessian=hessian)
    got = C.calibrate(params, cfg, {"tokens": torch.from_numpy(toks)}, hessian=hessian)
    assert got.n_tokens == want.n_tokens == 96
    assert sorted(got.weights) == sorted(want.weights)
    assert len(got.weights) == 2 * 7 + 1                  # 7 linears a layer + unembed
    for path, w in want.weights.items():
        g = got.weights[path]
        assert g.shape == w.shape and g.count == w.count == 96, path
        assert g.sqnorm.dtype == torch.float32 and _rel(g.sqnorm, w.sqnorm) < 1e-5, path
        assert _rel(g.amax, w.amax) < 1e-5, path
        assert _rel(g.merge_norm(), w.merge_norm()) < 1e-5, path
        if hessian:
            assert g.H.dtype == torch.float64 and _rel(g.H, w.H) < 1e-5, path
        else:
            assert g.H is None and w.H is None
    assert sorted(got.block_sim) == sorted(want.block_sim) == ["blocks.0.0", "blocks.0.1"]
    for path, cos in want.block_sim.items():
        assert got.block_sim[path] == pytest.approx(cos, rel=1e-5)


def test_calibrate_unregistered_weights_and_hook_scope(tiny):
    """Only the registered per-layer slices are recorded, and the hook is
    gone after the run."""
    from repro_torch.core import compressed
    _, _, cfg, params = tiny
    rec = C.Recorder()
    x = torch.ones((2, 64))
    with rec.active():
        compressed.matmul(x, params["unembed"])           # not registered: ignored
        rec.register("", {"unembed": params["unembed"]})
        compressed.matmul(x, params["unembed"])
    compressed.matmul(x, params["unembed"])               # hook removed
    st = rec.finish().get("unembed")
    assert st.count == 2 and torch.equal(st.sqnorm, torch.full((64,), 2.0))
    with pytest.raises(ValueError, match="nonesuch"):      # a family neither package knows
        C.calibrate(params, cfg.replace(family="nonesuch"), {"tokens": torch.zeros((1, 4))})


def test_hook_sees_only_its_own_thread(tiny):
    """A recorder active in one thread records none of another thread's
    matmuls (a CPU reference run beside a calibration), and a thread
    started inside the ``with`` block runs unobserved."""
    import threading

    from repro_torch.core import compressed
    _, _, cfg, params = tiny
    rec = C.Recorder()
    x = torch.ones((2, 64))
    rec.register("", {"unembed": params["unembed"]})
    other = threading.Thread(target=lambda: [compressed.matmul(2 * x, params["unembed"])
                                             for _ in range(3)])
    with rec.active():
        other.start()
        other.join()
        compressed.matmul(x, params["unembed"])
    st = rec.finish().get("unembed")
    assert st.count == 2 and torch.equal(st.sqnorm, torch.full((64,), 2.0))


def _problem(seed, K=256, N=96):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(K, N)).astype(np.float32)
    x = rng.normal(size=(512, K)) * (np.abs(rng.normal(size=K)) + 0.2)
    H = x.T @ x
    H[3] = H[:, 3] = 0.0                                  # a dead input channel
    amax = np.abs(x).max(0).astype(np.float32)
    return w, H, amax


@pytest.mark.parametrize("fn,name", [("quantize.gptq_quantize", "percdamp"),
                                     ("quantize.gptq_quantize", "blocksize"),
                                     ("sparsify.sparsegpt_prune", "percdamp"),
                                     ("sparsify.sparsegpt_prune", "blocksize")])
def test_damping_and_block_constants_are_the_references_defaults(fn, name):
    """The port keeps the reference's ``percdamp``/``blocksize`` options as
    the constants ``PERCDAMP``/``BLOCKSIZE``: no caller passes another
    value, so each constant must be the reference's default."""
    mod, func = fn.split(".")
    ref = getattr(importlib.import_module(f"repro.core.{mod}"), func)
    port = importlib.import_module(f"repro_torch.core.{mod}")
    assert name not in inspect.signature(getattr(port, func)).parameters
    assert getattr(Q, name.upper()) == inspect.signature(ref).parameters[name].default


@pytest.mark.parametrize("kw", [dict(bits=8, group=128), dict(bits=4, group=64),
                                dict(bits=8, group=128, smooth_alpha=0.5),
                                dict(bits=8, group=80, mask=True)])
def test_gptq_codes_match_reference(kw):
    w, H, amax = _problem(sum(map(ord, str(kw))))
    kw = dict(kw)
    mask = None
    if kw.pop("mask", False):
        mask = np.random.default_rng(1).random(w.shape) > 0.5
    smooth = dict(amax_x=amax, smooth_alpha=kw.pop("smooth_alpha")) if "smooth_alpha" in kw else {}
    want = RQ.gptq_quantize(w, H, mask=mask, **smooth, **kw)
    got = Q.gptq_quantize(torch.from_numpy(w), torch.from_numpy(H),
                          mask=None if mask is None else torch.from_numpy(mask),
                          **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                             for k, v in smooth.items()}, **kw)
    assert (got.bits, got.group, got.shape) == (want.bits, want.group, tuple(want.shape))
    codes, want_codes = got.unpack().numpy(), np.asarray(want.unpack())
    assert np.mean(codes == want_codes) >= 0.999
    assert _rel(got.scale, want.scale) < 1e-6
    if mask is not None:
        assert not codes[~mask].any()
    if smooth:
        assert _rel(got.in_scale, want.in_scale) < 1e-5
    else:
        assert got.in_scale is None and want.in_scale is None
    Ht = torch.from_numpy(H)
    assert Q.quant_error(torch.from_numpy(w), got, Ht) == pytest.approx(
        RQ.quant_error(w, want, H), rel=1e-3)
    assert Q.quant_error(torch.from_numpy(w), got) == pytest.approx(
        RQ.quant_error(w, want), rel=1e-3)
    # GPTQ beats round-to-nearest on the proxy it minimizes
    if not smooth and mask is None:
        rtn = Q.absmax_quantize(torch.from_numpy(w), bits=kw["bits"], group=kw["group"])
        assert Q.quant_error(torch.from_numpy(w), got, Ht) < Q.quant_error(
            torch.from_numpy(w), rtn, Ht)
