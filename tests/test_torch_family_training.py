"""Training of the hybrid (zamba2) and rwkv families: the port against the
reference on the same numpy inputs.

Models: reduced zamba2-7b (7 block applications: 2 groups of 2 Mamba
layers and the shared block, whose gradient sums over its 2 sites, and
one Mamba tail layer) and reduced rwkv6-3b
(2 layers), vocab 260, f32 params from the reference's init carried
across with ``bridge.from_reference``; ``rwkv_strong`` is the rwkv model
with its decay base ``tm.w0`` raised by 4, so that per-token decays reach
e^-60 and below and the WKV6 scan's clamps (log decay at -60, decay at
1e-30, ``exp(min(E, 0))``) are hit.  Tolerances:

- ``loss_fn`` and every gradient leaf against
  ``jax.value_and_grad(repro.models.api.loss_fn)``, remat on and off:
  loss within 1e-5 relative, each gradient leaf within 1e-4 of the
  leaf's largest reference value (rwkv_strong: within twice the largest
  spread of the reference's own f32 gradients over two chunk sizes,
  8e-2; see the test);
- ``wkv6_chunked``'s gradients (r, k, v, the log decay, u, S0; decays
  down to e^-80 a token) against ``jax.grad`` of the reference's: 1e-4
  of each input's largest gradient;
- one ``make_train_step`` step with AdamW and with Adafactor, each at 1
  and 2 microbatches, against the reference's: loss and grad norm within 1e-5
  relative; updated params within two learning rates (one update that
  the two sides take in opposite directions where a gradient is within
  rounding of 0) and their RMS difference within 1e-3 of the RMS update;
- remat recomputes the same values: loss and gradients bit for bit
  equal with and without it; the optimizers' slice-by-slice update of a
  stacked leaf equals the whole leaf's;
- a bf16 step's loss and grad norm within 2e-2 relative of the f32
  step's (bf16 rounds to 2^-8 relative);
- a checkpoint of a step's params and optimizer state, written by either
  package, restores in the other bit for bit.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rregistry  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import rwkv as RW  # noqa: E402
from repro.training import checkpoint as RCK  # noqa: E402
from repro.training import optimizer as ROPT  # noqa: E402
from repro.training import train_loop as RTL  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import rwkv as W  # noqa: E402
from repro_torch.training import checkpoint as CK  # noqa: E402
from repro_torch.training import optimizer as OPT  # noqa: E402
from repro_torch.training import train_loop as TL  # noqa: E402
from repro_torch.tree import leaves, tree_map, value_and_grad  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
UPDATE_RMS_RTOL = 1e-3
BF16_RTOL = 2e-2
LR = 1e-3
FLIP = 2.0 * LR * (1 + 1e-3)
MODELS = ["hybrid", "rwkv", "rwkv_strong"]

_MODELS = {}


def _model(name):
    """(reference cfg, reference params, port cfg, port params), f32."""
    if name not in _MODELS:
        if name == "hybrid":
            rcfg = rregistry.get_reduced("zamba2-7b").replace(
                param_dtype="float32", n_layers=7, vocab_size=260)
        else:
            rcfg = rregistry.get_reduced("rwkv6-3b").replace(param_dtype="float32",
                                                             vocab_size=260)
        if name == "rwkv_strong":
            rparams = _model("rwkv")[1]
            blocks = dict(rparams["blocks"][0])
            blocks["tm"] = {**blocks["tm"], "w0": blocks["tm"]["w0"] + 4.0}
            rparams = {**rparams, "blocks": [blocks]}
        else:
            rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
        _MODELS[name] = (rcfg, rparams, from_reference(rcfg),
                         bridge.from_reference(jax.device_get(rparams), device="cpu"))
    return _MODELS[name]


def _batch(B=2, S=32, seed=1):
    r = np.random.default_rng(seed)
    toks = r.integers(4, 256, (B, S)).astype(np.int32)
    labels = r.integers(4, 256, (B, S)).astype(np.int32)
    return ({"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long()},
            {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})


def _leaf_errors(got_tree, want_tree):
    """Per leaf: max |got - want| over max |want|."""
    got = leaves(got_tree)
    want = leaves(bridge.from_reference(jax.device_get(want_tree), device="cpu"))
    assert len(got) == len(want)
    out = []
    for a, b in zip(got, want):
        assert a.shape == b.shape
        d = (a.double() - b.double()).abs().max().item()
        out.append(d / max(b.double().abs().max().item(), 1e-30))
    return out


def test_strong_model_reaches_the_clamps():
    """rwkv_strong's decays fall below the clamps for some channels."""
    rcfg, rparams, _, _ = _model("rwkv_strong")
    w0 = np.asarray(rparams["blocks"][0]["tm"]["w0"])
    # w = exp(-exp(w0 + dd)): log w = -exp(w0 + dd) below -60 where w0 > log 60
    assert (w0 > math.log(60.0) + 0.5).any() and (w0 < math.log(60.0)).any()


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_reference(name, remat, monkeypatch):
    """With rwkv_strong's decays the chunked scan's log-decay sums reach
    -1920 (32 tokens at -60), where an f32 ulp is 1.2e-4, so f32 gradients
    move with the order of the sums: the reference's own at chunk 16
    differ from its chunk-32 ones by up to 8e-2 of a leaf (tm.w0, whose
    gradient is 5e-5 at most), which leaf varies with the order.  There
    the largest leaf error is held within twice the reference's largest
    spread."""
    rcfg, rparams, cfg, params = _model(name)
    tb, jb = _batch()
    loss, grads = value_and_grad(lambda p: api.loss_fn(p, cfg, tb, remat=remat), params)

    def ref():
        return jax.jit(jax.value_and_grad(
            lambda p: rapi.loss_fn(p, rcfg, jb, remat=remat)))(rparams)

    rloss, rgrads = ref()
    assert float(loss) == pytest.approx(float(rloss), rel=LOSS_RTOL)
    errs = _leaf_errors(grads, rgrads)
    tol = GRAD_RTOL
    if name == "rwkv_strong":
        chunked = RW.wkv6_chunked
        monkeypatch.setattr(RW, "wkv6_chunked", lambda *a, chunk: chunked(*a, chunk=16))
        spread = _leaf_errors(bridge.from_reference(jax.device_get(ref()[1]), device="cpu"),
                              rgrads)
        tol = max(GRAD_RTOL, 2 * max(spread))
    assert max(errs) <= tol, (errs, tol)


@pytest.mark.parametrize("name", ["hybrid", "rwkv"])
def test_remat_recomputes_the_same_values(name):
    """``checkpoint(..., use_reentrant=False)`` recomputes each group or
    layer exactly: loss and gradients bit for bit equal without remat."""
    _, _, cfg, params = _model(name)
    tb, _ = _batch(seed=2)
    out = [value_and_grad(lambda p: api.loss_fn(p, cfg, tb, remat=remat), params)
           for remat in (True, False)]
    assert float(out[0][0]) == float(out[1][0])
    for a, b in zip(leaves(out[0][1]), leaves(out[1][1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("strong", [False, True], ids=["mild", "strong"])
def test_wkv6_chunked_grads_match_reference(strong):
    """Gradients of r, k, v, the log decay (the model reaches w only as
    exp(-exp(...)), so its gradient flows through log w; that of w itself
    is d/dlog w over w, noise over 1e-26 where w is near e^-60), u and S0;
    T 21 in chunks of 7."""
    r = np.random.default_rng(5 + strong)
    B, T, H, N = 2, 21, 3, 4
    lo, hi = (1e-3, 80.0) if strong else (0.01, 2.0)
    args = [r.standard_normal((B, T, H, N)).astype(np.float32) for _ in range(3)]
    args.append(-r.uniform(lo, hi, (B, T, H, N)).astype(np.float32))
    args.append((r.standard_normal((H, N)) * 0.3).astype(np.float32))
    args.append(r.standard_normal((B, H, N, N)).astype(np.float32))
    co = r.standard_normal((B, T, H, N)).astype(np.float32)
    cS = r.standard_normal((B, H, N, N)).astype(np.float32)

    def rf(rr, k, v, lw, u, S0):
        o, S = RW.wkv6_chunked(rr, k, v, jnp.exp(lw), u, S0, chunk=8)
        return jnp.sum(o * co) + jnp.sum(S * cS)

    want = jax.grad(rf, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    o, S = W.wkv6_chunked(ts[0], ts[1], ts[2], torch.exp(ts[3]), *ts[4:], chunk=8)
    (torch.sum(o * torch.from_numpy(co)) + torch.sum(S * torch.from_numpy(cS))).backward()
    for t, w in zip(ts, want):
        w = np.asarray(w, np.float64)
        err = np.abs(t.grad.double().numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_RTOL


OPTIMIZERS = {
    "adamw": lambda m: m.adamw(lr=LR, warmup=0, total_steps=10),
    "adafactor": lambda m: m.adafactor(lr=LR, warmup=0, total_steps=10),
}


def _update_errors(new, want_tree, old):
    """(max |new - want| over FLIP, RMS(new - want) over RMS(want - old))."""
    want = leaves(bridge.from_reference(jax.device_get(want_tree), device="cpu"))
    worst = diff2 = upd2 = 0.0
    for a, b, o in zip(leaves(new), want, leaves(old)):
        a, b, o = a.double(), b.double(), o.double()
        worst = max(worst, (a - b).abs().max().item())
        diff2 += torch.sum((a - b) ** 2).item()
        upd2 += torch.sum((b - o) ** 2).item()
    return worst / FLIP, math.sqrt(diff2 / max(upd2, 1e-30))


def _port_step(name, opt, microbatches, dtype=None):
    rcfg, rparams, cfg, params = _model(name)
    if dtype is not None:
        cfg = cfg.replace(param_dtype=dtype)
        like = api.init_params(torch.Generator().manual_seed(0), cfg)
        params = tree_map(lambda a, s: a.to(s.dtype), params, like)
    o = OPTIMIZERS[opt](OPT)
    p = tree_map(torch.clone, params)           # the step writes into p and s
    s = o.init(p)
    p, s, m = TL.make_train_step(cfg, o, microbatches=microbatches)(p, s, _batch(4)[0], 0)
    return p, s, {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("name,opt,microbatches", [
    ("hybrid", "adamw", 1), ("hybrid", "adafactor", 2), ("rwkv", "adafactor", 1),
    ("rwkv", "adamw", 2)])
def test_train_step_tracks_reference(name, opt, microbatches):
    """Each family with both optimizers, each optimizer at 1 and 2
    microbatches."""
    rcfg, rparams, cfg, params = _model(name)
    p, s, m = _port_step(name, opt, microbatches)
    ro = OPTIMIZERS[opt](ROPT)
    rp, rs, rm = jax.jit(RTL.make_train_step(rcfg, ro, microbatches=microbatches))(
        rparams, ro.init(rparams), _batch(4)[1], 0)
    assert m["loss"] == pytest.approx(float(rm["loss"]), rel=LOSS_RTOL)
    assert m["grad_norm"] == pytest.approx(float(rm["grad_norm"]), rel=LOSS_RTOL)
    flips, rms = _update_errors(p, rp, params)
    assert flips <= 1.0 and rms <= UPDATE_RMS_RTOL, (flips, rms)
    assert max(_leaf_errors(s, rs)) <= GRAD_RTOL


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_sliced_update_equals_whole_leaf_update(opt, monkeypatch):
    """Stacked leaves cut into slices (``optimizer.SLICE_ELEMS``, which
    full-width zamba2-7b's Mamba stacks exceed) update as whole leaves do:
    AdamW bit for bit, Adafactor within 1e-6 (its RMS rule sums the
    slices' squares in another order)."""
    whole = _port_step("hybrid", opt, 1)
    monkeypatch.setattr(OPT, "SLICE_ELEMS", 64)
    sliced = _port_step("hybrid", opt, 1)
    assert whole[2] == sliced[2]
    for a, b in zip(leaves(whole[:2]), leaves(sliced[:2])):
        if opt == "adamw":
            assert torch.equal(a, b)
        else:
            assert (a - b).abs().max().item() <= 1e-6 * max(b.abs().max().item(), 1e-30)


@pytest.mark.parametrize("name", ["hybrid", "rwkv"])
def test_bf16_step_stays_near_f32(name):
    _, _, m32 = _port_step(name, "adamw", 2)
    p, _, m16 = _port_step(name, "adamw", 2, dtype="bfloat16")
    assert any(t.dtype == torch.bfloat16 for t in leaves(p))
    for k in ("loss", "grad_norm"):
        assert math.isfinite(m16[k])
        assert m16[k] == pytest.approx(m32[k], rel=BF16_RTOL), (k, m16[k], m32[k])


@pytest.mark.parametrize("name", ["hybrid", "rwkv"])
def test_trained_checkpoint_crosses_packages(name, tmp_path):
    rcfg, rparams, cfg, _ = _model(name)
    p, s, _ = _port_step(name, "adafactor", 1)
    CK.save(str(tmp_path / "port"), 1, {"params": p, "opt": s})
    back, step, _ = RCK.restore_tree(str(tmp_path / "port"))
    assert step == 1
    for a, b in zip(leaves({"params": p, "opt": s}),
                    leaves(bridge.from_reference(jax.device_get(back), device="cpu"))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tb, jb = _batch()
    assert float(rapi.loss_fn(back["params"], rcfg, jb)) == pytest.approx(
        float(api.loss_fn(p, cfg, tb)), rel=LOSS_RTOL)
    # and the other way: the trained state written by the reference
    RCK.save(str(tmp_path / "ref"), 2, back)
    got, _, _ = CK.restore_tree(str(tmp_path / "ref"), device="cpu")
    for a, b in zip(leaves(got), leaves({"params": p, "opt": s})):
        assert a.dtype == b.dtype and torch.equal(a, b)
