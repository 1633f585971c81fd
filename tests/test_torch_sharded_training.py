"""Training a placed (sharded) param tree, against the reference's step.

The params of every family at the reduced widths of ``test_torch_tp.py``
(and ``tiny_dense`` of tests/conftest.py), in f32, are placed by
``sharding.place(params, param_shardings(cfg, params, mesh, fsdp=...))``
on a (1, 4) and a (2, 2) mesh whose positions are all the CPU, and take
one step of the port's ``make_train_step`` (one and two microbatches)
from an optimizer state ``Optimizer.init`` builds on the placed tree.
The reference's jitted ``make_train_step`` runs the same step on the same
numpy params and batch: dense (gemma2) and tiny_dense with AdamW, hybrid
(zamba2) with Adafactor, rwkv (rwkv6) and MoE (qwen2-moe: experts over
"data") with AdamW.

- Loss and grad norm within 1e-5 relative; every gathered state leaf
  within 2e-6 absolute, and every param element too, but for one
  exception: an element whose reference gradient is below 1e-6 in
  magnitude.  AdamW's first step moves an element by about lr * sign(g)
  whatever |g|, so where |g| sits near f32 noise (eps is 1e-8) its
  direction is not determined, and the unsharded port parts from the
  reference there as well (by up to 1.5e-4 at lr 1.5e-3 on reduced
  gemma2, measured).  Those elements are held to 2 * lr, the most a
  flipped direction moves them, and must be fewer than one in a
  thousand; a sharding fault moves elements whose gradient is large.
- Each position's bytes of params and optimizer state equal
  ``spec_bytes`` of ``param_shardings`` and ``opt_state_shardings``.
- A checkpoint saved from the sharded tree is read by the reference's
  ``restore`` and by the port's ``restore(shardings=)`` onto another
  mesh, bit for bit; ``train(params=placed)`` resumes onto its layout.
- ``compressed_allreduce`` over sharded gradients equals it over the same
  gradients whole, bit for bit, handed back cut as they came.
- Adafactor on a row-split and a column-split matrix equals the
  reference's update; with per-piece statistics (a planted fault) it
  does not.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_tp import _mesh, _models  # noqa: E402

from repro.training import checkpoint as RCK  # noqa: E402
from repro.training import optimizer as ROPT  # noqa: E402
from repro.training import train_loop as RTL  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.core.compressed import ShardedTensor, position_bytes  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch.dryrun import bytes_per_position  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import grad_compress as GC  # noqa: E402
from repro_torch.training import optimizer as OPT  # noqa: E402
from repro_torch.training.train_loop import TrainConfig, make_train_step, train  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves, tree_map, value_and_grad  # noqa: E402

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-6
GRAD_FLOOR = 1e-6           # below it an AdamW element's direction is f32 noise
LR, WARMUP, STEP = 3e-3, 2, 1
LR_T = LR * STEP / WARMUP
SHAPES = ((1, 4), (2, 2))
FAMILIES = {"tiny-dense": "adamw", "gemma2-2b": "adamw", "zamba2-7b": "adafactor",
            "rwkv6-3b": "adamw", "qwen2-moe-a2.7b": "adamw"}
_REF = {}


def _opt(mod, kind):
    return getattr(mod, kind)(lr=LR, warmup=WARMUP, total_steps=5)


def _family(name, tiny_dense):
    """(reference cfg, reference params, port cfg, port params) in f32."""
    if name == "tiny-dense":
        rcfg, rparams = tiny_dense
        rcfg = rcfg.replace(param_dtype="float32")
        rparams = jax.tree.map(lambda a: a.astype(jnp.float32), rparams)
        return rcfg, rparams, from_reference(rcfg), bridge.from_reference(
            jax.device_get(rparams), device="cpu")
    return _models(name)[:4]


def _batch(cfg):
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
    return ({"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])},
            {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])})


def _reference(name, mb, tiny_dense):
    """The reference's step: (metrics, [params, state] as port tensors)."""
    if (name, mb) not in _REF:
        rcfg, rparams, cfg, _ = _family(name, tiny_dense)
        ro = _opt(ROPT, FAMILIES[name])
        _, jb = _batch(cfg)
        rp, rs, rm = jax.jit(RTL.make_train_step(rcfg, ro, microbatches=mb))(
            rparams, ro.init(rparams), jb, STEP)
        _REF[name, mb] = ({k: float(v) for k, v in rm.items()},
                          bridge.from_reference(jax.device_get((rp, rs)), device="cpu"))
    return _REF[name, mb]


def _whole(t):
    return SH.gather(t) if isinstance(t, ShardedTensor) else t


def _placed(cfg, params, shape, fsdp):
    mesh = _mesh(shape)
    sh = SH.param_shardings(cfg, params, mesh, fsdp=fsdp)
    return mesh, sh, SH.place(tree_map(torch.clone, params), sh)


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mb", [1, 2], ids=["mb1", "mb2"])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_sharded_step_equals_reference(name, mb, shape, fsdp, tiny_dense):
    _, _, cfg, params = _family(name, tiny_dense)
    kind = FAMILIES[name]
    want_m, want = _reference(name, mb, tiny_dense)
    mesh, sh, placed = _placed(cfg, params, shape, fsdp)
    o = _opt(OPT, kind)
    state = o.init(placed)
    # the state is placed as opt_state_shardings says, and each position's
    # bytes of params and state are the rule table's
    osh = SH.opt_state_shardings(sh, mesh, kind)
    assert [SH.spec_of(t) for t in leaves(state)] == [
        s.spec for s in leaves(osh, is_leaf=SH._is_sharding)]
    want_p = bytes_per_position(params, sh)
    want_s = bytes_per_position(o.init(params), osh)
    for i in range(mesh.size):
        assert position_bytes(placed, i) == pytest.approx(want_p, rel=1e-12)
        assert position_bytes(state, i) == pytest.approx(want_s, rel=1e-12)
    tb, _ = _batch(cfg)
    p2, s2, m = make_train_step(cfg, o, microbatches=mb)(placed, state, tb, STEP)
    assert float(m["loss"]) == pytest.approx(want_m["loss"], rel=LOSS_RTOL)
    assert float(m["grad_norm"]) == pytest.approx(want_m["grad_norm"], rel=LOSS_RTOL)
    got = flatten_with_path([p2, s2])
    assert any(isinstance(t, ShardedTensor) for _, t in got)
    assert [type(t) for _, t in flatten_with_path(p2)] == [
        type(t) for _, t in flatten_with_path(placed)]
    ref_m = dict(flatten_with_path(want[1]["m"])) if kind == "adamw" else {}
    undetermined = total = 0
    for (path, a), b in zip(got, leaves(want)):
        a = _whole(a)
        assert a.shape == b.shape, path
        err = (a - b).abs()
        if path[0] == 0 and kind == "adamw":
            noise = ref_m[path[1:]].abs() < (1 - 0.9) * GRAD_FLOOR     # m = 0.1 g
            assert err[~noise].max().item() <= PARAM_ATOL, path
            if noise.any():
                assert err[noise].max().item() <= 2 * LR_T, path
            undetermined += int((noise & (err > PARAM_ATOL)).sum())
            total += a.numel()
        else:
            assert err.max().item() <= PARAM_ATOL, path
    assert undetermined <= total / 1000


def test_checkpoint_of_a_sharded_tree_reads_everywhere(tiny_dense, tmp_path):
    """The port writes a sharded (params, AdamW state) gathered whole: the
    reference's ``restore`` reads it, and the port's ``restore(shardings=)``
    places it onto another mesh's layout, bit for bit."""
    rcfg, rparams, cfg, params = _family("gemma2-2b", tiny_dense)
    _, _, placed = _placed(cfg, params, (2, 2), True)
    o = _opt(OPT, "adamw")
    state = o.init(placed)
    tb, _ = _batch(cfg)
    placed, state, _ = make_train_step(cfg, o)(placed, state, tb, STEP)
    whole = [tree_map(_whole, placed), tree_map(_whole, state)]
    ckpt.save(str(tmp_path), 7, (placed, state))
    ro = _opt(ROPT, "adamw")
    rtree, step, _ = RCK.restore(str(tmp_path), (rparams, ro.init(rparams)))
    assert step == 7
    for a, b in zip(leaves(whole), jax.tree_util.tree_leaves(rtree)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mesh = _mesh((1, 4))
    target_sh = SH.param_shardings(cfg, params, mesh)
    shardings = (target_sh, SH.opt_state_shardings(target_sh, mesh, "adamw"))
    got, _, _ = ckpt.restore(str(tmp_path), (params, o.init(params)), shardings=shardings,
                             device="cpu")
    want = SH.place(whole, list(shardings))
    for (path, a), (_, b) in zip(flatten_with_path(got), flatten_with_path(want)):
        assert SH.spec_of(a) == SH.spec_of(b), path
        for x, y in zip(_pieces(a), _pieces(b)):
            assert torch.equal(x, y), path
    assert sum(isinstance(t, ShardedTensor) for t in leaves(got)) > 0
    # and read back onto the layout the tree was saved from
    again, _, _ = ckpt.restore(str(tmp_path), (params, o.init(params)), device="cpu",
                               shardings=SH.shardings_of((placed, state)))
    for (path, a), (_, b) in zip(flatten_with_path(again), flatten_with_path([placed, state])):
        assert SH.spec_of(a) == SH.spec_of(b), path
        assert all(torch.equal(x, y) for x, y in zip(_pieces(a), _pieces(b))), path


def _pieces(t):
    return t.tensors() if isinstance(t, ShardedTensor) else [t]


def test_train_entry_point_trains_and_resumes_a_placed_tree(tmp_path):
    """``train(params=placed)`` gives the unsharded run's losses, writes
    checkpoints, and resumes onto the placed layout."""
    _, _, cfg, params, _ = _models("gemma2-2b")
    tc = dict(steps=3, batch=4, seq_len=32, log_every=1, ckpt_every=2)
    quiet = lambda _: None  # noqa: E731
    flat = train(cfg, TrainConfig(**tc), _opt(OPT, "adamw"),
                 params=tree_map(torch.clone, params), log=quiet, device="cpu")
    mesh, _, placed = _placed(cfg, params, (2, 2), True)
    run = train(cfg, TrainConfig(**tc, ckpt_dir=str(tmp_path)), _opt(OPT, "adamw"),
                params=placed, log=quiet, device="cpu")
    assert [s for s, _ in run["losses"]] == [0, 1, 2]
    for (_, a), (_, b) in zip(run["losses"], flat["losses"]):
        assert a == pytest.approx(b, rel=LOSS_RTOL)
    layout = [SH.spec_of(t) for t in leaves(run["params"])]
    _, _, fresh = _placed(cfg, params, (2, 2), True)
    resumed = train(cfg, TrainConfig(**{**tc, "steps": 4}, ckpt_dir=str(tmp_path)),
                    _opt(OPT, "adamw"), params=fresh, log=quiet, device="cpu")
    assert [s for s, _ in resumed["losses"]] == [3]
    assert [SH.spec_of(t) for t in leaves(resumed["params"])] == layout
    assert any(isinstance(t, ShardedTensor) for t in leaves(resumed["opt_state"]))


def test_compressed_allreduce_over_sharded_gradients():
    """The hook takes a placed tree's gradients: each leaf enters whole (the
    reference's ``in_specs=P()``), so the result and the residual equal
    those of the whole gradients, and the result is cut as they came."""
    _, _, cfg, params, _ = _models("gemma2-2b")
    mesh, _, placed = _placed(cfg, params, (2, 2), True)
    tb, _ = _batch(cfg)
    _, grads = value_and_grad(lambda p: _loss(p, cfg, tb), placed)
    whole = tree_map(_whole, grads)
    pod = SH.axis_size(mesh, "data")
    res = GC.init_residual(grads)
    got, got_res = GC.compressed_allreduce(grads, res, axis="data", mesh=mesh)
    want, want_res = GC.compressed_allreduce(whole, GC.init_residual(whole), axis="data",
                                             mesh=mesh)
    assert pod == 2
    for (path, g), a, b, r, s in zip(flatten_with_path(grads), leaves(got), leaves(want),
                                     leaves(got_res), leaves(want_res)):
        assert SH.spec_of(a) == SH.spec_of(g), path
        assert torch.equal(_whole(a), b), path
        assert torch.equal(r, s), path
    assert not all(torch.equal(_whole(a), b) for a, b in zip(leaves(got), leaves(whole)))


def _loss(p, cfg, batch):
    from repro_torch.models import api
    return api.loss_fn(p, cfg, batch)


def _adafactor_fault(monkeypatch):
    """Each piece's statistics taken as if its piece were the whole matrix."""
    monkeypatch.setattr(OPT, "_sum_over", lambda parts, dev: parts[0].to(dev) * len(parts))


@pytest.mark.parametrize("fault", [False, True], ids=["right", "per_piece_fault"])
@pytest.mark.parametrize("split", ["row", "column", "both"])
def test_adafactor_keeps_the_whole_matrix_statistics(split, fault, monkeypatch):
    rng = np.random.default_rng(5)
    p = {"w": rng.standard_normal((2, 16, 24)).astype(np.float32)}
    g = {"w": rng.standard_normal((2, 16, 24)).astype(np.float32) * 0.01}
    g["w"][:, :8] *= 30.0                     # rows and columns of unequal scale
    g["w"][..., :6] *= 0.05
    mesh = _mesh((2, 2))
    spec = {"row": SH.P(None, "model", None), "column": SH.P(None, None, "model"),
            "both": SH.P(None, "data", "model")}[split]
    sh = {"w": SH.NamedSharding(mesh, spec)}
    ro = ROPT.adafactor(lr=LR, warmup=WARMUP, total_steps=5)
    rp = jax.tree.map(jnp.asarray, p)
    rs = ro.init(rp)
    for step in range(2):
        rp, rs = ro.update(rp, jax.tree.map(jnp.asarray, g), rs, step + 1)
    if fault:
        _adafactor_fault(monkeypatch)
    o = OPT.adafactor(lr=LR, warmup=WARMUP, total_steps=5)
    tp = SH.place({"w": torch.from_numpy(p["w"].copy())}, sh)
    ts = o.init(tp)
    assert SH.spec_of(ts["f"]["w"]["vr"]) == SH.P(*spec[:-1])
    assert SH.spec_of(ts["f"]["w"]["vc"]) == SH.P(*spec[:-2], spec[-1])
    tg = SH.place({"w": torch.from_numpy(g["w"].copy())}, sh)
    for step in range(2):
        tp, ts = o.update(tp, tg, ts, step + 1)
    # the params' change, and the factored moments
    got = [_whole(tp["w"]) - torch.from_numpy(p["w"]), _whole(ts["f"]["w"]["vr"]),
           _whole(ts["f"]["w"]["vc"])]
    want = [np.asarray(rp["w"]) - p["w"], np.asarray(rs["f"]["w"]["vr"]),
            np.asarray(rs["f"]["w"]["vc"])]
    errs = [float(np.abs(a.numpy() - b).max() / np.abs(b).max()) for a, b in zip(got, want)]
    if fault:
        assert max(errs) > 1e-2, errs
    else:
        assert np.abs(_whole(tp["w"]).numpy() - np.asarray(rp["w"])).max() <= PARAM_ATOL
        assert max(errs[1:]) <= LOSS_RTOL, errs
