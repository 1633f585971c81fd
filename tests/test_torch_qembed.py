"""Int8 embedding tables (``QEmbed``, ``Recipe.quant_embed``) and the tied
unembed's f32 logits, against the reference.

- ``quantize_embed``: the reference's codes, equal, and scales, equal, on
  f32 and bf16 tables;
- ``QEmbed.lookup`` equals the reference's (bf16 rows); ``QEmbed.logits``
  within 1e-5 of the reference's largest logit (f32 accumulation order);
- the tied unembed gives the f32 product of its bf16 operands (1e-5 of
  the largest logit), and the reference's logits; rounding them through
  bf16, as the port once did, puts them 2.5e-3 away at 256 x 64;
- ``InstanceOptimizer.apply`` with ``quant_embed=True`` on reduced gemma2
  (tied, bf16, as gemma2 is served; the reference's engine cannot serve
  an f32 model whose embedding is a ``QEmbed``: its bf16 rows change the
  type of its decode scan's carry): the reference's ``Report`` bytes and
  param counts, the same codes; logits no further (RMS of the difference
  over the RMS logit) from the reference instance's than the two
  packages' ``w8-absmax`` instances are from each other (2.2e-2 to
  2.4e-2: bf16 through 4 layers), and no further from the port's
  ``w8-absmax`` instance's than the reference's ``QEmbed`` instance is
  from its own (5e-2 to 7e-2), both within 1.25 times; the ``Engine``
  serves the reference ``Engine``'s rows from it, or rows that the
  reference's ``forward`` scores at least as high, to within noise;
- a ``QEmbed`` instance written by either package's checkpoint restores in
  the other with the same codes, scales and logits;
- ``tree.value_and_grad`` passes ``QEmbed`` and ``QTensor`` leaves through
  (no gradient) and differentiates the float leaves.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rregistry  # noqa: E402
from repro.core import compressed as RC  # noqa: E402
from repro.core.pipeline import InstanceOptimizer as RInstanceOptimizer  # noqa: E402
from repro.core.pipeline import Recipe as RRecipe  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.serving.engine import Engine as REngine  # noqa: E402
from repro.training import checkpoint as RCK  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.core.compressed import QEmbed, param_bytes, quantize_embed  # noqa: E402
from repro_torch.core.pipeline import InstanceOptimizer, Recipe  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.training import checkpoint as CK  # noqa: E402
from repro_torch.training.data import ByteTokenizer  # noqa: E402

LOGIT_RTOL = 1e-5
BF16_RATIO = 1.25
TEMPLATE = "Sentiment (pos or neg) of review: "
ROWS = [TEMPLATE + r for r in (
    "great battery life", "arrived broken, no refund", "ok for the price",
    "great battery life", "the strap snapped after two days", "meh")]
KW = dict(slots=4, max_len=128, buckets=(16, 32, 64))
W8 = dict(wbits=8, quant_method="absmax")


def _rel(got, want):
    want = np.asarray(jax.device_get(want), np.float64) if not isinstance(
        want, torch.Tensor) else want.double().numpy()
    got = got.detach().double().numpy()
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _rms_rel(got, want):
    """RMS of the difference over the RMS of ``want``."""
    want = torch.from_numpy(np.asarray(jax.device_get(want), np.float64)) if not isinstance(
        want, torch.Tensor) else want.double()
    d = got.double() - want
    return float(d.pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def _table(V=260, d=64, seed=0, dtype=np.float32):
    return (np.random.default_rng(seed).standard_normal((V, d)) * 0.02).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_embed_codes_and_scales_equal_reference(dtype):
    w = jnp.asarray(_table()).astype(dtype)
    rq = RC.quantize_embed(w)
    q = quantize_embed(bridge.to_tensor(w, "cpu"))
    assert q.q.dtype == torch.int8 and q.scale.dtype == torch.float32
    assert torch.equal(q.q, torch.from_numpy(np.array(rq.q)))
    assert torch.equal(q.scale, torch.from_numpy(np.array(rq.scale)))
    assert q.shape == tuple(rq.shape) and q.ndim == 2 and q.dtype == torch.bfloat16
    assert q.nbytes == rq.nbytes == 260 * 64 + 4 * 260 == param_bytes({"embed": q})


def test_lookup_and_logits_match_reference():
    rq = RC.quantize_embed(jnp.asarray(_table()))
    q = bridge.from_reference({"embed": rq}, device="cpu")["embed"]
    assert isinstance(q, QEmbed)
    toks = np.random.default_rng(1).integers(0, 260, (3, 7)).astype(np.int32)
    got = q.lookup(torch.from_numpy(toks).long())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, bridge.to_tensor(rq.lookup(jnp.asarray(toks)), "cpu"))
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(np.float32)
    want = rq.logits(jnp.asarray(x))
    got = q.logits(torch.from_numpy(x))
    assert got.dtype == torch.float32 and _rel(got, want) <= LOGIT_RTOL


def test_tied_unembed_keeps_f32_logits():
    """E = normal * 0.02 [256, 64] and X [4, 64] from default_rng(0), in
    bf16, through gemma2's tied unembed (softcap 30)."""
    rcfg = rregistry.get_reduced("gemma2-2b")
    cfg = from_reference(rcfg)
    r = np.random.default_rng(0)
    E = jnp.asarray((r.standard_normal((256, 64)) * 0.02).astype(np.float32)).astype(jnp.bfloat16)
    X = jnp.asarray(r.standard_normal((4, 64)).astype(np.float32)).astype(jnp.bfloat16)
    tE, tX = bridge.to_tensor(E, "cpu"), bridge.to_tensor(X, "cpu")
    got = L.unembed({"embed": tE}, cfg, tX)
    want = L.softcap(tX.float() @ tE.float().t(), cfg.final_softcap)
    assert got.dtype == torch.float32 and _rel(got, want) <= LOGIT_RTOL
    assert _rel(got, RL.unembed({"embed": E}, rcfg, X)) <= LOGIT_RTOL
    rounded = L.softcap((tX @ tE.t()).float(), cfg.final_softcap)
    assert _rel(rounded, want) > 1e-3           # the fault this test guards


_MODELS = {}


def _instances():
    """Reduced gemma2 (tied, vocab 260, window 128) in bf16 and its
    ``w8-absmax`` instances with and without ``quant_embed`` on both
    sides: (rcfg, cfg, {name: (reference params, report)}, {name: (port
    params, report)})."""
    if not _MODELS:
        rcfg = rregistry.get_reduced("gemma2-2b").replace(param_dtype="bfloat16",
                                                         vocab_size=260, window_size=128)
        rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
        cfg, params = from_reference(rcfg), bridge.from_reference(jax.device_get(rparams),
                                                                   device="cpu")
        ropt, opt = RInstanceOptimizer(rparams, rcfg), InstanceOptimizer(params, cfg)
        ref, mine = {}, {}
        for name, qe in (("w8", False), ("w8-qe", True)):
            p, _, rep = ropt.apply(RRecipe(name=name, quant_embed=qe, **W8))
            ref[name] = (p, rep)
            p, _, rep = opt.apply(Recipe(name=name, quant_embed=qe, **W8))
            mine[name] = (p, rep)
        _MODELS.update(rcfg=rcfg, cfg=cfg, ref=ref, mine=mine)
    return _MODELS["rcfg"], _MODELS["cfg"], _MODELS["ref"], _MODELS["mine"]


def _tokens():
    return np.random.default_rng(4).integers(4, 256, (2, 24)).astype(np.int32)


def test_apply_quant_embed_matches_reference():
    rcfg, cfg, ref, mine = _instances()
    (rp, rrep), (p, rep) = ref["w8-qe"], mine["w8-qe"]
    assert (rep.bytes_before, rep.bytes_after, rep.params_before, rep.params_after) == \
        (rrep.bytes_before, rrep.bytes_after, rrep.params_before, rrep.params_after)
    V, d = cfg.vocab_size, cfg.d_model
    # the table moves from 2 V d bytes (bf16) to V d + 4 V
    assert rep.bytes_after == mine["w8"][1].bytes_after - 2 * V * d + V * d + 4 * V
    assert isinstance(p["embed"], QEmbed)
    assert torch.equal(p["embed"].q, torch.from_numpy(np.array(rp["embed"].q)))
    assert torch.equal(p["embed"].scale, torch.from_numpy(np.array(rp["embed"].scale)))
    toks = _tokens()
    with torch.no_grad():
        got = api.forward(p, cfg, {"tokens": torch.from_numpy(toks)})[0]
        w8 = api.forward(mine["w8"][0], cfg, {"tokens": torch.from_numpy(toks)})[0]
    want = rapi.forward(rp, rcfg, {"tokens": jnp.asarray(toks)})[0]
    # bf16 noise between the packages, and QEmbed's own change of the
    # logits, each no larger than the reference's (STEP_BF16_RATIO)
    rw8 = rapi.forward(ref["w8"][0], rcfg, {"tokens": jnp.asarray(toks)})[0]
    assert _rms_rel(got, want) <= BF16_RATIO * _rms_rel(w8, rw8)
    assert _rms_rel(got, w8) <= BF16_RATIO * _rms_rel(
        torch.from_numpy(np.array(want, np.float32)), rw8)


def test_engine_rows_of_qembed_instance_match_reference():
    """The paged and the contiguous ``Engine`` serve the same rows from the
    ``QEmbed`` instance.  A row may part from the reference engine's, whose
    bf16 decode path need not follow its own ``forward`` (here row 4 at
    its 7th token: EOS, where the reference's ``forward`` prefers the
    port's 170 by 0.36).  At the first differing token the port's token
    may score below the reference engine's on the reference's
    ``forward`` by no more than 4 sqrt(2) sigma, sigma the RMS over the
    vocabulary of the two packages' ``forward`` logit difference there (a
    difference of two logits carries sqrt(2) sigma); at most half the
    rows may part."""
    rcfg, cfg, ref, mine = _instances()
    p, rp = mine["w8-qe"][0], ref["w8-qe"][0]
    got = Engine(p, cfg, device="cpu", **KW).generate(ROWS, max_new=8, prefix=TEMPLATE,
                                                      return_requests=True)
    cont = Engine(p, cfg, device="cpu", kv_layout="contiguous", **KW).generate(
        ROWS, max_new=8, prefix=TEMPLATE, return_requests=True)
    want = REngine(rp, rcfg, backend="reference", **KW).generate_stream(
        ROWS, max_new=8, prefix=TEMPLATE, return_requests=True)
    assert [r.out_ids for r in got] == [r.out_ids for r in cont]
    tok, parted = ByteTokenizer(260), 0
    for text, g, w in zip(ROWS, got, want):
        a, b = list(g.out_ids), list(w.out_ids)
        if a == b:
            continue
        parted += 1
        j = next(i for i in range(min(len(a), len(b)) + 1)
                 if i == min(len(a), len(b)) or a[i] != b[i])
        x, y = (a[j] if j < len(a) else tok.EOS), (b[j] if j < len(b) else tok.EOS)
        ids = np.array([tok.encode(text, bos=True) + [tok.SEP] + a[:j]], np.int32)
        with torch.no_grad():
            lp = api.forward(p, cfg, {"tokens": torch.from_numpy(ids)})[0][0, -1].double()
        lr = torch.from_numpy(np.asarray(
            rapi.forward(rp, rcfg, {"tokens": jnp.asarray(ids)})[0][0, -1], np.float64))
        sigma = (lp - lr).pow(2).mean().sqrt().item()
        assert (lr[y] - lr[x]).item() <= 4 * np.sqrt(2) * sigma, (j, x, y, sigma)
    assert parted <= len(ROWS) // 2


def test_qembed_instance_checkpoint_crosses_packages(tmp_path):
    rcfg, cfg, ref, mine = _instances()
    p, rp = mine["w8-qe"][0], ref["w8-qe"][0]
    CK.save(str(tmp_path / "port"), 0, p)
    back, _, _ = RCK.restore_tree(str(tmp_path / "port"))
    assert isinstance(back["embed"], RC.QEmbed)
    assert np.array_equal(np.array(back["embed"].q), np.array(rp["embed"].q))
    assert np.array_equal(np.array(back["embed"].scale), np.array(rp["embed"].scale))
    RCK.save(str(tmp_path / "ref"), 0, rp)
    got, _, _ = CK.restore_tree(str(tmp_path / "ref"), device="cpu")
    assert isinstance(got["embed"], QEmbed)
    assert torch.equal(got["embed"].q, p["embed"].q)
    toks = torch.from_numpy(_tokens())
    with torch.no_grad():
        assert torch.equal(api.forward(got, cfg, {"tokens": toks})[0],
                           api.forward(p, cfg, {"tokens": toks})[0])


def test_value_and_grad_passes_container_leaves():
    """``tree.value_and_grad`` over a compressed instance: the ``QEmbed``
    and ``QTensor`` leaves pass as they are (gradient ``None``), the float
    leaves (norms) get gradients; the loss is the plain ``loss_fn``'s."""
    from repro_torch.core.compressed import QTensor
    from repro_torch.tree import flatten_with_path, value_and_grad
    _, cfg, _, mine = _instances()
    p = mine["w8-qe"][0]
    toks = torch.from_numpy(_tokens()).long()
    batch = {"tokens": toks, "labels": toks}
    loss, grads = value_and_grad(lambda q: api.loss_fn(q, cfg, batch), p)
    with torch.no_grad():
        assert float(loss) == float(api.loss_fn(p, cfg, batch))
    got = dict(flatten_with_path(grads))
    for path, leaf in flatten_with_path(p):
        if isinstance(leaf, (QEmbed, QTensor)):
            assert path not in got
        else:
            assert got[path].shape == leaf.shape and torch.isfinite(got[path]).all()
