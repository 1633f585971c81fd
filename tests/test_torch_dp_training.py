"""The data-parallel train step on a mesh (``distributed/data_parallel.py``).

- Each collective's autograd conjugate: its gradient equals the plain
  op's (``torch.cat``/``torch.stack``, the f32 sum, ``torch.split``, the
  identity of a hand-off), and its backward counts what the module
  docstring of ``distributed/collectives.py`` states: nothing for a
  gather or a sum to a whole tensor, an all-reduce for a hand-off, an
  all-gather for a split or a reduce-scatter, the same kind back for an
  all-to-all or a permutation.
- For reduced tiny-dense, gemma2-2b, zamba2-7b, rwkv6-3b and
  qwen2-moe-a2.7b (f32, the widths of ``test_torch_tp.py``) placed at
  (1, 4), (2, 2) and (2, 2, 1), FSDP off and on: the collectives one
  executed ``make_train_step`` step records (``collectives.result_bytes``
  and ``calls``, read by a ``grad_compressor`` hook after the gradients'
  reduction, and again after the AdamW update, which adds none) equal
  ``roofline.train_collectives`` exactly; gemma2-2b also at two
  microbatches and with cross-entropy chunks.  Where the dp axes split
  the batch the step reduces gradients (all-reduces, and reduce-scatters
  where FSDP splits leaves); at (1, 4) it reduces nothing.
- An MoE step split over "data" (8 experts, top 2, a capacity factor of
  0.5, so that entries drop, and one of 4, so that none do) equals the
  unsplit step: every layer's kept entries per expert exactly, its aux
  loss, the step's loss and every gradient within 1e-6 (f32; measured
  at most 9.6e-7 and 5.6e-7), and its output rows within 2e-6 of their
  largest magnitude (measured 1.0e-6 at a largest of 1.06: the model
  axis's pieces round differently from the whole matmuls).
- A (2, 2, 1) step (rows over "pod" and "data") equals the reference's
  jitted step under ``test_sharded_step_equals_reference``'s tolerances:
  qwen2-moe-a2.7b FSDP off and on (its experts over "data" split the
  tree either way), gemma2-2b FSDP on.
- A batch whose rows split over the dp axes but whose microbatches do
  not raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import test_torch_sharded_training as TST  # noqa: E402
from test_torch_tp import _mesh  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import compressed  # noqa: E402
from repro_torch.core.compressed import ShardedTensor  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed import data_parallel as DP  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.training import optimizer as OPT  # noqa: E402
from repro_torch.training.train_loop import make_train_step  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

SHAPES = ((1, 4), (2, 2), (2, 2, 1))
FAMILIES = ("gemma2-2b", "qwen2-moe-a2.7b", "rwkv6-3b", "tiny-dense", "zamba2-7b")
MOE_TOL = 1e-6
OUT_RTOL = 2e-6       # the MoE layers' output rows, of their largest magnitude


def _counts():
    return ({k: v for k, v in C.result_bytes.items() if v},
            {k: v for k, v in C.calls.items() if v})


def _rand(*shape, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).requires_grad_(True)


def _grads(out, ins, cot):
    outs = out if isinstance(out, (list, tuple)) else [out]
    cots = cot if isinstance(cot, (list, tuple)) else [cot]
    return torch.autograd.grad(outs, ins, cots)


CPU = torch.device("cpu")


def _case(op):
    """(inputs, the collective, the plain op, cotangents, backward's count)."""
    ps = [_rand(2, 5, seed=i) for i in range(3)]
    if op == "all_gather":
        return (ps, lambda: C.all_gather(ps, dim=-1), lambda: torch.cat(ps, -1),
                _rand(2, 15, seed=9), {})
    if op == "all_gather_stack":
        return (ps, lambda: C.all_gather(ps, dim=0, stack=True), lambda: torch.stack(ps),
                _rand(3, 2, 5, seed=9), {})
    if op == "all_reduce_sum":
        bf = [p.detach().bfloat16().requires_grad_(True) for p in ps]

        def plain():
            acc = bf[0].float()
            for p in bf[1:]:
                acc = acc + p.float()
            return acc.bfloat16()
        return bf, lambda: C.all_reduce_sum(bf), plain, _rand(2, 5, seed=9).bfloat16(), {}
    x = _rand(4, 6, seed=3)
    if op == "replicate":          # the plain gradient: the cotangents' f32 sum in order
        return ([x], lambda: C.replicate(x, [CPU] * 3), None,
                [_rand(4, 6, seed=10 + i) for i in range(3)], {"all-reduce": (x.numel() * 4, 1)})
    if op == "split":
        return ([x], lambda: C.split(x, [2, 4], -1, [CPU, CPU]),
                lambda: list(torch.split(x, [2, 4], -1)),
                [_rand(4, 2, seed=11), _rand(4, 4, seed=12)], {"all-gather": (x.numel() * 4, 1)})
    if op == "reduce_scatter":
        parts = [[_rand(3, seed=10 * j + k) for k in range(2)] for j in range(3)]
        flat = [t for p in parts for t in p]
        return (flat, lambda: C.reduce_scatter(parts),
                lambda: [parts[0][k] + parts[1][k] + parts[2][k] for k in range(2)],
                [_rand(3, seed=20), _rand(3, seed=21)], {"all-gather": (2 * 3 * 4, 1)})
    qs = [_rand(3, 4, seed=i) for i in range(3)]
    if op == "all_to_all":
        return (qs, lambda: C.all_to_all(qs),
                lambda: [torch.cat([q[j:j + 1] for q in qs]) for j in range(3)],
                [_rand(3, 4, seed=30 + i) for i in range(3)],
                {"all-to-all": (3 * 12 * 4, 1)})
    perm = [(0, 1), (1, 2)]
    return (qs, lambda: C.ppermute(qs, perm), lambda: [qs[2] * 0, qs[0] * 1, qs[1] * 1],
            [_rand(3, 4, seed=40 + i) for i in range(3)],
            {"collective-permute": (2 * 12 * 4, 1)})


@pytest.mark.parametrize("op", ["all_gather", "all_gather_stack", "all_reduce_sum", "replicate",
                                "split", "reduce_scatter", "all_to_all", "ppermute"])
def test_each_collective_differentiates_as_its_plain_op(op):
    ins, fn, plain, cot, back = _case(op)
    if op == "replicate":
        want = [(cot[0] + cot[1] + cot[2]).detach()]
    else:
        want = _grads(plain(), ins, cot)
    C.reset_result_bytes()
    out = fn()
    forward = _counts()
    C.reset_result_bytes()
    got = _grads(out, ins, cot)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), op
    nb, nc = _counts()
    assert nb == {k: v[0] for k, v in back.items()} and nc == {k: v[1] for k, v in back.items()}
    if op not in ("replicate", "split"):           # the hand-offs count nothing
        assert sum(forward[1].values()) == 1
    else:
        assert forward == ({}, {})


def _snapshot_step(cfg, params, shape, fsdp, mb=1, xent_chunk=0, batch=None):
    """One AdamW step of ``params`` placed at ``shape``: (counts after the
    gradients' reduction, counts after the update, placed tree, loss)."""
    mesh = _mesh(shape)
    placed = SH.place(tree_map(torch.clone, params), SH.param_shardings(cfg, params, mesh,
                                                                        fsdp=fsdp))
    snap = []

    def hook(g, r):
        snap.append(_counts())
        return g, r

    o = TST._opt(OPT, "adamw")
    step = make_train_step(cfg, o, microbatches=mb, xent_chunk=xent_chunk, grad_compressor=hook)
    batch = TST._batch(cfg)[0] if batch is None else batch
    C.reset_result_bytes()
    _, _, _, m = step(placed, o.init(placed), batch, TST.STEP)
    return snap[0], _counts(), placed, float(m["loss"])


def _count_cases():
    cases = [(name, shape, fsdp, 1, 0) for name in FAMILIES for shape in SHAPES
             for fsdp in (False, True)]
    cases += [("gemma2-2b", shape, fsdp, 2, 0) for shape in SHAPES[:2] for fsdp in (False, True)]
    cases += [("gemma2-2b", (2, 2), True, 1, 8)]
    return cases


@pytest.mark.parametrize("name,shape,fsdp,mb,chunk", _count_cases(),
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_executed_step_collectives_equal_the_count(name, shape, fsdp, mb, chunk, tiny_dense):
    _, _, cfg, params = TST._family(name, tiny_dense)
    (got_b, got_c), after, placed, _ = _snapshot_step(cfg, params, shape, fsdp, mb, chunk)
    assert after == (got_b, got_c)                  # AdamW's update adds none
    want = roofline.train_collectives(placed, cfg, roofline.TrainStep(4, 32, mb, chunk))
    assert got_b == {k: v for k, v in want["bytes"].items() if v}
    assert got_c == {k: v for k, v in want["calls"].items() if v}
    assert roofline.collective_bytes(placed, cfg, 0, train=roofline.TrainStep(4, 32, mb, chunk)) \
        == want["bytes"]
    split = shape[0] * shape[1] if len(shape) == 3 else shape[0]
    sharded = any(isinstance(t, ShardedTensor) for t in leaves(placed))
    assert want["split"] == (split if sharded and split > 1 else 1)
    grads = want["breakdown"]["gradients"]
    if want["split"] == 1:
        assert grads == {}
    else:
        assert grads.get("all-reduce", 0) > 0
        assert ("reduce-scatter" in grads) == (fsdp and any(
            DP._is_fsdp(t) for t in _nodes(placed)))
        assert want["breakdown"]["backward"]


def _nodes(tree):
    out = []

    def walk(t):
        if isinstance(t, ShardedTensor):
            out.append(t)
            for p in t.pieces:
                walk(p)
    for t in leaves(tree):
        walk(t)
    return out


def _moe_cfg():
    return registry.get_config("qwen2-moe-a2.7b").replace(
        param_dtype="float32", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, moe_d_ff=64, vocab_size=256, n_experts=8, top_k=2, n_shared_experts=0)


def _moe_run(cfg, params, mesh_shape, fsdp, batch, monkeypatch):
    """(loss, gradients gathered whole, [(piece, aux, out)] of the forward's
    MoE calls, [kept entries per expert] of each call)."""
    calls, kept = [], []
    real = L.moe_block

    def spy(p, x, cfg, **kw):
        out, aux = real(p, x, cfg, **kw)
        piece = DP.active()
        if piece is None or piece.replay is None:
            calls.append((piece.index if piece is not None else 0, aux.detach().clone(),
                          out.detach().clone()))
        return out, aux
    monkeypatch.setattr(L, "moe_block", spy)
    compressed.set_route_hook(lambda r, counts, pm: kept.append(counts.clone()))
    try:
        tree = tree_map(torch.clone, params)
        if mesh_shape is not None:
            mesh = _mesh(mesh_shape)
            tree = SH.place(tree, SH.param_shardings(cfg, params, mesh, fsdp=fsdp))
        got = []
        o = TST._opt(OPT, "adamw")
        step = make_train_step(cfg, o, grad_compressor=lambda g, r: (got.append(g) or g, r))
        _, _, _, m = step(tree, o.init(tree), batch, TST.STEP)
    finally:
        compressed.set_route_hook(None)
        monkeypatch.setattr(L, "moe_block", real)
    whole = [SH.gather(g) if isinstance(g, ShardedTensor) else g for g in leaves(got[0])]
    return float(m["loss"]), whole, calls, kept


@pytest.mark.parametrize("biased", [True, False], ids=["drops", "dropless"])
@pytest.mark.parametrize("fsdp", [False, True], ids=["ep", "fsdp"])
def test_moe_step_split_over_data_equals_the_unsplit_step(biased, fsdp, monkeypatch):
    cfg = _moe_cfg()
    params = api.init_params(torch.Generator().manual_seed(4), cfg)
    # a capacity below the mean load drops entries; one of every token none
    cfg = cfg.replace(capacity_factor=0.5 if biased else 4.0)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 33))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    want_loss, want_g, want_calls, want_kept = _moe_run(cfg, params, None, False, batch,
                                                         monkeypatch)
    loss, grads, calls, kept = _moe_run(cfg, params, (2, 2), fsdp, batch, monkeypatch)
    T, k = 4 * 32, cfg.top_k
    layers = cfg.n_layers
    dropped = [T * k - int(c.sum()) for c in want_kept[:layers]]
    assert (max(dropped) > 0) == biased, dropped
    assert len(calls) >= 2 * layers and [c[0] for c in calls[:2 * layers]] == [0, 1] * layers
    for layer in range(layers):
        (_, a0, o0), (_, a1, o1) = calls[2 * layer], calls[2 * layer + 1]
        _, aw, ow = want_calls[layer]
        assert abs(a0 - aw) <= MOE_TOL and abs(a1 - aw) <= MOE_TOL
        assert (torch.cat([o0, o1]) - ow).abs().max() <= OUT_RTOL * ow.abs().max()
        assert torch.equal(kept[2 * layer] + kept[2 * layer + 1], want_kept[layer])
    assert abs(loss - want_loss) <= MOE_TOL
    assert max((a - b).abs().max().item() for a, b in zip(grads, want_g)) <= MOE_TOL


@pytest.mark.parametrize("name,fsdp", [("qwen2-moe-a2.7b", False), ("qwen2-moe-a2.7b", True),
                                       ("gemma2-2b", True)])
def test_pod_and_data_split_step_equals_reference(name, fsdp, tiny_dense):
    _, _, cfg, params = TST._family(name, tiny_dense)
    placed = SH.place(tree_map(torch.clone, params),
                      SH.param_shardings(cfg, params, _mesh((2, 2, 1)), fsdp=fsdp))
    assert roofline.train_collectives(placed, cfg, roofline.TrainStep(4, 32))["split"] == 4
    TST.test_sharded_step_equals_reference(name, 1, (2, 2, 1), fsdp, tiny_dense)


def test_microbatches_that_do_not_split_raise(tiny_dense):
    _, _, cfg, params = TST._family("gemma2-2b", tiny_dense)
    with pytest.raises(ValueError, match="microbatches of rows"):
        _snapshot_step(cfg, params, (2, 2, 1), True, mb=2)


def _run_bounded(fn, seconds=60):
    """``fn()`` on a thread, joined with a timeout: (result, error)."""
    import threading
    box = {}

    def body():
        try:
            box["out"] = fn()
        except Exception as e:          # the caller asserts on it
            box["err"] = e
    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), "the lockstep run did not finish"
    return box.get("out"), box.get("err")


def test_lockstep_exchanges_in_turn_under_contention():
    """16 pieces (more than the cores) with a short switch interval: each
    of 20 exchanges gives every piece the same combination of every
    piece's deposit, in piece order, and the combination runs once."""
    import sys
    n, rounds, combined = 16, 20, []

    def combine(deposits):
        combined.append(list(deposits))
        return sum(deposits)

    def piece(j, group):
        got = []
        for r in range(rounds):
            got.append(group.exchange(j, 100 * r + j, combine))
        return got

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        group = DP._Lockstep(n)
        out, err = _run_bounded(lambda: group.run([lambda j=j: piece(j, group)
                                                   for j in range(n)]))
    finally:
        sys.setswitchinterval(old)
    assert err is None
    want = [sum(100 * r + j for j in range(n)) for r in range(rounds)]
    assert out == [want] * n
    assert combined == [[100 * r + j for j in range(n)] for r in range(rounds)]


@pytest.mark.parametrize("fault", ["raises", "fewer_exchanges"])
def test_lockstep_stops_every_piece_on_a_fault(fault):
    """A piece that raises, or that reaches fewer exchanges than the
    others, makes the run raise, and no piece is left waiting."""
    n = 4

    def piece(j, group):
        for r in range(3):
            if fault == "raises" and j == 2 and r == 1:
                raise KeyError("planted")
            if fault == "fewer_exchanges" and j == 1 and r == 2:
                return "early"
            group.exchange(j, j, sum)
        return "done"

    group = DP._Lockstep(n)
    _, err = _run_bounded(lambda: group.run([lambda j=j: piece(j, group) for j in range(n)]))
    assert isinstance(err, KeyError if fault == "raises" else RuntimeError), err
