"""Port training (``repro_torch.training``, ``models.transformer.loss_fn``)
against the reference's, on the same numpy inputs.

- ``train_batch`` equals the reference's arrays, element for element.
- ``loss_fn`` equals the reference's ``loss_fn`` with ``xent_chunk`` 0
  and 16 and remat on and off, on tiny f32 params carried over by
  ``bridge.from_reference``; remat changes neither loss nor gradients.
- Five steps of ``make_train_step`` with AdamW and Adafactor, at 1 and 2
  microbatches, track the reference's jitted step: per-step loss and
  grad norm within 1e-5 relative (measured at most 2.0e-7 loss, 9.4e-7
  grad norm), final params and optimizer state within 2e-6 absolute
  (measured at most 2.7e-7).  In bf16 the losses stay within 2e-2 relative.
- ``api.build_train_step`` takes the reference's step (loss, grad
  norm and params within the same tolerances).
- The reference's ``test_loss_decreases`` contract on the port's
  ``train`` (the last logged loss below 0.7 of the first).
- The kernel wrappers refuse inputs that require grad on their launch
  path (``ops.grad_refused``), checked on meta tensors, which take the
  launch path without reaching a kernel.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as RConfig  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.training import data as RD  # noqa: E402
from repro.training import optimizer as ROPT  # noqa: E402
from repro.training import train_loop as RTL  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.training import data as D  # noqa: E402
from repro_torch.training import optimizer as OPT  # noqa: E402
from repro_torch.training import train_loop as TL  # noqa: E402
from repro_torch.tree import leaves, tree_map, value_and_grad  # noqa: E402

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-6
BF16_RTOL = 2e-2
TOK = D.ByteTokenizer(260)


def _cfgs(dtype="float32"):
    rcfg = RConfig(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, d_ff=128, vocab_size=260, max_seq=256,
                   param_dtype=dtype)
    return rcfg, from_reference(rcfg)


@pytest.fixture(scope="module")
def tiny():
    rcfg, cfg = _cfgs()
    rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, rparams, cfg, bridge.from_reference(jax.device_get(rparams), device="cpu")


def _batches(step, batch=4, seq_len=32, seed=0):
    b = D.train_batch(step, batch=batch, seq_len=seq_len, tok=TOK, seed=seed)
    return ({k: torch.from_numpy(v) for k, v in b.items() if k != "weights"},
            {k: jnp.asarray(v) for k, v in b.items() if k != "weights"})


@pytest.mark.parametrize("step,seed,batch,seq_len", [(0, 0, 4, 32), (17, 3, 5, 64),
                                                      (1234, 7, 16, 96)])
def test_train_batch_equals_reference(step, seed, batch, seq_len):
    got = D.train_batch(step, batch=batch, seq_len=seq_len, tok=TOK, seed=seed)
    want = RD.train_batch(step, batch=batch, seq_len=seq_len,
                          tok=RD.ByteTokenizer(260), seed=seed)
    assert set(got) == set(want) == {"tokens", "labels", "weights"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    again = D.train_batch(step, batch=batch, seq_len=seq_len, tok=TOK, seed=seed)
    np.testing.assert_array_equal(got["tokens"], again["tokens"])


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("xent_chunk", [0, 16])
def test_loss_fn_matches_reference(tiny, xent_chunk, remat):
    rcfg, rparams, cfg, params = tiny
    tb, jb = _batches(3)
    got = float(api.loss_fn(params, cfg, tb, xent_chunk=xent_chunk, remat=remat))
    want = float(rapi.loss_fn(rparams, rcfg, jb, xent_chunk=xent_chunk, remat=remat))
    assert got == pytest.approx(want, rel=LOSS_RTOL)


@pytest.mark.parametrize("xent_chunk", [0, 16])
def test_remat_changes_no_gradient(tiny, xent_chunk):
    _, _, cfg, params = tiny
    tb, _ = _batches(5)
    out = [value_and_grad(lambda p: api.loss_fn(p, cfg, tb, xent_chunk=xent_chunk,
                                                remat=remat), params)
           for remat in (True, False)]
    assert float(out[0][0]) == float(out[1][0])
    for a, b in zip(leaves(out[0][1]), leaves(out[1][1])):
        assert torch.equal(a, b)


OPTIMIZERS = {
    "adamw": lambda m: m.adamw(lr=3e-3, warmup=2, total_steps=5),
    "adafactor": lambda m: m.adafactor(lr=3e-3, warmup=2, total_steps=5),
}


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_train_steps_track_reference(tiny, opt, microbatches):
    rcfg, rparams, cfg, params = tiny
    make = OPTIMIZERS[opt]
    o, ro = make(OPT), make(ROPT)
    step = TL.make_train_step(cfg, o, microbatches=microbatches)
    rstep = jax.jit(RTL.make_train_step(rcfg, ro, microbatches=microbatches))
    p = tree_map(torch.clone, params)           # the steps write into p and s
    s, rp, rs = o.init(p), rparams, ro.init(rparams)
    for i in range(5):
        tb, jb = _batches(i)
        p, s, m = step(p, s, tb, i)
        rp, rs, rm = rstep(rp, rs, jb, i)
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=LOSS_RTOL)
        assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=LOSS_RTOL)
    want = bridge.from_reference(jax.device_get((rp, rs)), device="cpu")
    for a, b in zip(leaves((p, s)), leaves(want)):
        assert a.shape == b.shape
        assert (a.float() - b.float()).abs().max().item() <= PARAM_ATOL


def test_build_train_step_matches_reference(tiny):
    rcfg, rparams, cfg, params = tiny
    o, ro = OPTIMIZERS["adamw"](OPT), OPTIMIZERS["adamw"](ROPT)
    tb, jb = _batches(2)
    p = tree_map(torch.clone, params)
    p, s, m = api.build_train_step(cfg, o, xent_chunk=16)(p, o.init(p), tb, 0)
    rp, rs, rm = jax.jit(rapi.build_train_step(rcfg, ro, xent_chunk=16))(
        rparams, ro.init(rparams), jb, 0)
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=LOSS_RTOL)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=LOSS_RTOL)
    want = bridge.from_reference(jax.device_get(rp), device="cpu")
    for a, b in zip(leaves(p), leaves(want)):
        assert (a - b).abs().max().item() <= PARAM_ATOL


def test_bf16_steps_track_reference():
    rcfg, cfg = _cfgs("bfloat16")
    rparams = rapi.init_params(jax.random.PRNGKey(1), rcfg)
    params = bridge.from_reference(jax.device_get(rparams), device="cpu")
    o, ro = OPTIMIZERS["adamw"](OPT), OPTIMIZERS["adamw"](ROPT)
    step = TL.make_train_step(cfg, o, xent_chunk=16)
    rstep = jax.jit(RTL.make_train_step(rcfg, ro, xent_chunk=16))
    p, s, rp, rs = params, o.init(params), rparams, ro.init(rparams)
    for i in range(3):
        tb, jb = _batches(i)
        p, s, m = step(p, s, tb, i)
        rp, rs, rm = rstep(rp, rs, jb, i)
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=BF16_RTOL)
    assert p["embed"].dtype == torch.bfloat16 and s["m"]["embed"].dtype == torch.float32


def test_donated_update_writes_in_place(tiny):
    """The step writes its update into the params and state it was given
    (the reference donates both), and a step on a copy gives the same."""
    _, _, cfg, params = tiny
    o = OPTIMIZERS["adamw"](OPT)
    tb, _ = _batches(0)
    step = TL.make_train_step(cfg, o)
    copy = tree_map(torch.clone, params)
    fresh = step(copy, o.init(copy), tb, 1)     # step 0 of the warmup has rate 0
    p = tree_map(torch.clone, params)
    s = o.init(p)
    embed, m_embed = p["embed"], s["m"]["embed"]
    donated = step(p, s, tb, 1)
    assert donated[0]["embed"] is embed and donated[1]["m"]["embed"] is m_embed
    assert not torch.equal(embed, params["embed"])
    for a, b in zip(leaves(fresh[:2]), leaves(donated[:2])):
        assert torch.equal(a, b)


def test_grad_compressor_hook_sees_grads_and_carries_residual(tiny):
    _, _, cfg, params = tiny
    o = OPTIMIZERS["adamw"](OPT)
    seen = []

    def compress(grads, residual):
        seen.append(residual)
        return grads, (residual or 0) + 1

    step = TL.make_train_step(cfg, o, grad_compressor=compress)
    tb, _ = _batches(0)
    p = tree_map(torch.clone, params)
    p, s, res, m = step(p, o.init(p), tb, 0, None)
    p, s, res, m = step(p, s, tb, 1, res)
    assert seen == [None, 1] and res == 2 and torch.isfinite(m["loss"])


def test_loss_decreases():
    """The reference's ``TestTraining.test_loss_decreases`` on the port."""
    cfg = from_reference(RConfig(name="t2", family="dense", n_layers=2, d_model=64,
                                 n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=260,
                                 max_seq=256))
    out = TL.train(cfg, TL.TrainConfig(steps=25, batch=8, seq_len=64, log_every=24),
                   OPT.adamw(lr=3e-3, warmup=5, total_steps=25),
                   log=lambda *_: None, device="cpu")
    assert [s for s, _ in out["losses"]] == [0, 24]
    assert out["losses"][-1][1] < out["losses"][0][1] * 0.7


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TL.train(_cfgs()[1], TL.TrainConfig(steps=1), OPT.adamw(), log=lambda *_: None)


def _meta(*shape, dtype=torch.bfloat16, grad=True):
    return torch.empty(shape, dtype=dtype, device="meta").requires_grad_(grad)


WRAPPERS = {
    "quant_matmul": lambda g: ops.quant_matmul(
        _meta(4, 128, grad=g), torch.empty((128, 64), dtype=torch.int8, device="meta"),
        torch.empty((1, 64), dtype=torch.float32, device="meta"), group=128),
    "paged_attention": lambda g: ops.paged_attention(
        _meta(2, 1, 4, 32, grad=g), _meta(4, 16, 2, 32, grad=g), _meta(4, 16, 2, 32, grad=g),
        torch.empty((2, 2), dtype=torch.int32, device="meta"),
        torch.empty((2,), dtype=torch.int32, device="meta")),
    "block_sparse_matmul": lambda g: ops.block_sparse_matmul(
        _meta(4, 64, grad=g), _meta(64, 32, grad=g),
        torch.empty((2, 2), dtype=torch.int32, device="meta"), bs=16),
    "flash_attention": lambda g: ops.flash_attention(
        _meta(1, 16, 4, 32, grad=g), _meta(1, 16, 2, 32, grad=g), _meta(1, 16, 2, 32, grad=g)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_refuses_inputs_that_require_grad(name):
    """On the launch path (any non-CPU tensor) a wrapper raises before
    building or launching its kernel when grad mode is on and an input
    requires grad."""
    with pytest.raises(ops.KernelInputError, match="no backward"):
        WRAPPERS[name](True)


def test_grad_refused_predicate():
    x = torch.ones(2, requires_grad=True)
    assert ops.grad_refused(torch.ones(2), x, None)
    assert not ops.grad_refused(torch.ones(2), None)
    with torch.no_grad():
        assert not ops.grad_refused(x)
