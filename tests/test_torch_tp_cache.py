"""A mesh engine's slot state sharded by ``cache_shardings``, run where its
pieces live (``models/sharded_cache.py``).

Every family of ``test_torch_tp.py`` at (1, 4) and (2, 2) in f32: each
leaf of ``Engine(mesh=)``'s slot state, k/v and recurrent ones alike, is
cut as the spec of ``distributed/sharding.py``'s ``cache_shardings``
says (held leaf for leaf to the reference's by ``test_torch_sharding.py``)
and each position's state bytes are the specs' ``spec_bytes``: k/v over
slots and KV heads (or ``head_dim``), rwkv ``S`` and mamba ``h`` over
slots and heads, the carries, the conv window and whisper's ``enc_len``
over slots.  Both k/v branches are covered: KV heads over "model"
(qwen2-moe, zamba2, whisper, gemma2 at (2, 2)) and ``head_dim`` over
"model" (granite, paligemma, gemma2 at (1, 4)); rwkv's heads split at
(2, 2), and at (1, 4), where its 2 heads do not divide 4, ``wr`` is cut
by columns while ``S`` stays whole.  ``test_torch_tp.py`` holds every
family's greedy tokens on this state to the unsharded engine's and the
reference's; here the ``w8`` instance and prefix-seeded rows too, the
decode step's recorded collectives against ``roofline.collective_bytes``
(no q/k/v gather where KV heads split, no r/k/v/g gather where rwkv's
heads split, the partial-score sums and no cache gather where
``head_dim`` splits), a planted fault (one piece's heads written into
another piece), the hot-path auditor and the pool's record of what each
position holds.  The two placements the engine once refused: three slots
at (2, 2), whose k/v positions go over "data" (the sequence split), and
four at (2, 2, 1) over ("pod", "data", "model"), whose slots go over
"pod" and "data": every family's leaves, bytes and tokens, the step's
collectives and the auditor over both.
"""
import math
from typing import NamedTuple

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_tp import ARCHS, KW, ROWS, SHAPES, W8, _ids, _mesh, _models  # noqa: E402

from repro_torch.analysis import jit_audit  # noqa: E402
from repro_torch.core.compressed import ShardedTensor, position_bytes  # noqa: E402
from repro_torch.core.pipeline import InstanceOptimizer, Recipe  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import sharded_cache as SC  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

# which dim "model" cuts each family's k/v (and rwkv S, mamba h) at each
# mesh: their heads, or head_dim (None: nothing split over "model")
BRANCH = {"gemma2-2b": {(1, 4): "hd", (2, 2): "heads"},
          "granite-20b": {(1, 4): "hd", (2, 2): "hd"},
          "paligemma-3b": {(1, 4): "hd", (2, 2): "hd"},
          "qwen2-moe-a2.7b": {(1, 4): "heads", (2, 2): "heads"},
          "zamba2-7b": {(1, 4): "heads", (2, 2): "heads"},
          "whisper-base": {(1, 4): "heads", (2, 2): "heads"},
          "rwkv6-3b": {(1, 4): None, (2, 2): "heads"}}
class Seq(NamedTuple):
    """A mesh whose "data" axis does not divide the engine's ``slots``: the
    rule puts the k/v positions over "data" (the sequence split)."""
    mesh: tuple
    slots: int = 3


SEQ, POD = Seq((2, 2)), (2, 2, 1)        # the sequence split; slots over "pod" and "data"
PREFIX = "fix: "
PREFIX_ROWS = [PREFIX + w for w in ("pythn", "jvaa", "rubby", "golng")]


def _splits(leaf):
    """[(dim, axis)] of a nested ShardedTensor, outermost first."""
    out = []
    while isinstance(leaf, ShardedTensor):
        out.append((leaf.dim, leaf.axis))
        leaf = leaf.pieces[0]
    return out


def _spec_splits(spec):
    return [(i - len(spec), ax) for i, ax in enumerate(spec) if ax is not None]


def _engine(arch, shape, **kw):
    _, _, cfg, params, extra = _models(arch)
    return Engine(params, cfg, mesh=_mesh(shape), extra_inputs=extra, **{**KW, **kw})


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_kv_leaves_follow_cache_shardings(arch, shape):
    eng = _engine(arch, shape)
    cfg, mesh = eng.cfg, eng.mesh
    specs = dict(flatten_with_path(
        SH.cache_shardings(cfg, api.init_cache(cfg, eng.slots, eng.max_len,
                                               compact_local=False, device="meta"),
                           mesh), is_leaf=lambda x: isinstance(x, SH.P)))
    spec_total = [0.0] * mesh.size            # every leaf by the reference's spec
    item_14b = [0.0] * mesh.size              # placed minus spec
    branches = set()
    for path, leaf in flatten_with_path(eng._slot_state):
        spec = specs[path]
        assert _splits(leaf) == _spec_splits(spec), (arch, shape, path, spec)
        if path[-1] in ("k", "v", "S", "h"):
            branches |= {"hd" if d == -1 else "heads" for d, ax in _splits(leaf)
                         if ax == "model"}
        itemsize = leaf.dtype.itemsize
        for i in range(mesh.size):
            part = SH.spec_bytes(leaf.shape, itemsize, spec, mesh)
            spec_total[i] += part
            if isinstance(leaf, ShardedTensor):
                piece = leaf.piece_at(i)
                coords = mesh.coords(i)
                assert piece.device == SH._device_at(
                    mesh, {ax: coords[ax] for _, ax in _splits(leaf)}), (path, i)
            else:                 # replicated by the spec: one copy, on the first device
                piece = leaf
                assert leaf.device == mesh.first_device, path
            item_14b[i] += piece.numel() * itemsize - part
    assert branches == ({BRANCH[arch][shape]} if BRANCH[arch][shape] else set())
    # every leaf, recurrent ones and whisper's enc_len included, holds the
    # reference's share at every position: nothing is left to ROADMAP item 14b
    assert not any(item_14b), (arch, shape, item_14b)
    assert [SC.state_position_bytes(eng._slot_state, i) for i in range(mesh.size)] == \
        spec_total
    assert [eng.position_bytes(i) for i in range(mesh.size)] == [
        position_bytes(eng.params, i) + spec_total[i] for i in range(mesh.size)]


def test_rwkv_columns_split_where_its_heads_do_not():
    """rwkv's 2 heads on 4 model positions: ``wr`` (128 columns) is cut by
    columns, ``S`` stays whole (its spec does not split the heads), and
    decode takes the whole-head route, still giving the unsharded tokens."""
    _, _, cfg, params, _ = _models("rwkv6-3b")
    eng = _engine("rwkv6-3b", (1, 4))
    tm = eng.params["blocks"][0]["tm"]
    assert cfg.n_heads % 4 and isinstance(tm["wr"], ShardedTensor) and tm["wr"].dim == -1
    assert all(torch.is_tensor(t) for t in eng._slot_state["blocks"][0].values())
    want = _ids(Engine(params, cfg, device="cpu", kv_layout="contiguous", **KW))
    assert _ids(eng) == want
    split = _engine("rwkv6-3b", (2, 2))
    S = split._slot_state["blocks"][0]["S"]
    assert _splits(S) == [(-4, "data"), (-3, "model")]
    assert _ids(split) == want


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch,which", [("gemma2-2b", "w8"), ("qwen2-moe-a2.7b", "w8"),
                                        ("zamba2-7b", "base")])
def test_w8_and_prefix_seeded_rows_equal_unsharded(arch, which, shape):
    _, _, cfg, params, _ = _models(arch)
    if which == "w8":
        params, cfg, _ = InstanceOptimizer(params, cfg).apply(Recipe(**W8))
    flat = Engine(params, cfg, device="cpu", kv_layout="contiguous", **KW)
    eng = Engine(params, cfg, mesh=_mesh(shape), **KW)
    assert _ids(eng) == _ids(flat)
    want = [r.out_ids for r in flat.generate(PREFIX_ROWS, max_new=6, prefix=PREFIX,
                                             return_requests=True)]
    got = [r.out_ids for r in eng.generate(PREFIX_ROWS, max_new=6, prefix=PREFIX,
                                           return_requests=True)]
    assert eng.stats.prefix_hits > 0 and got == want


def _faulty_write_rows(real):
    """``write_rows`` with the rows of model pieces 0 and 1 exchanged:
    piece 1's KV heads (or head_dim slice) land in piece 0."""
    def write_rows(leaf, axis, slot_idxs, rows):
        if isinstance(leaf, ShardedTensor) and leaf.axis == "model":
            parts = list(torch.chunk(rows, len(leaf.pieces), dim=leaf.dim))
            parts[0], parts[1] = parts[1], parts[0]
            for piece, r in zip(leaf.pieces, parts):
                real(piece, axis, slot_idxs, r)
            return
        real(leaf, axis, slot_idxs, rows)
    return write_rows


@pytest.mark.parametrize("arch,shape", [("gemma2-2b", (1, 4)), ("gemma2-2b", (2, 2)),
                                        ("qwen2-moe-a2.7b", (1, 4)), ("rwkv6-3b", (2, 2)),
                                        ("zamba2-7b", (1, 4))])
def test_planted_fault_fails_the_token_check(arch, shape, monkeypatch):
    _, _, cfg, params, _ = _models(arch)
    want = _ids(Engine(params, cfg, device="cpu", kv_layout="contiguous", **KW))
    monkeypatch.setattr(SC, "write_rows", _faulty_write_rows(SC.write_rows))
    assert _ids(_engine(arch, shape)) != want


@pytest.mark.parametrize("arch,shape", [("gemma2-2b", (1, 4)), ("gemma2-2b", (2, 2)),
                                        ("granite-20b", (2, 2)), ("qwen2-moe-a2.7b", (1, 4)),
                                        ("zamba2-7b", (2, 2)), ("whisper-base", (1, 4)),
                                        ("paligemma-3b", (1, 4)), ("rwkv6-3b", (1, 4)),
                                        ("rwkv6-3b", (2, 2)), ("zamba2-7b", (1, 4)),
                                        ("whisper-base", (2, 2))]
                         + [pytest.param(a, s, id=f"{a}-{'seq' if s == SEQ else 'pod'}")
                            for a, s in (("gemma2-2b", SEQ), ("paligemma-3b", SEQ),
                                         ("whisper-base", SEQ), ("zamba2-7b", SEQ),
                                         ("gemma2-2b", POD), ("rwkv6-3b", POD),
                                         ("zamba2-7b", POD), ("whisper-base", POD))])
def test_decode_step_collectives_equal_the_roofline_count(arch, shape, monkeypatch):
    """One decode step of every slot live records what
    ``collective_bytes`` counts over the engine's sharded state; where KV
    heads split that is no gather of q/k/v, where ``head_dim`` splits no
    gather holds a layer's cache, and over a sequence split each
    attention layer's merge gathers its pieces' maxima [2, slots, heads]."""
    eng = (_engine(arch, shape.mesh, slots=shape.slots) if isinstance(shape, Seq)
           else _engine(arch, shape))
    for r in ROWS[:eng.slots]:
        eng.submit(r, max_new=6)
    eng.step()                               # admit all four rows, one decode
    assert not len(eng.batcher) and eng._active
    gathered = []
    real = collectives.all_gather
    monkeypatch.setattr(collectives, "all_gather",
                        lambda pieces, *a, **kw: gathered.append(real(pieces, *a, **kw))
                        or gathered[-1])
    collectives.reset_result_bytes()
    eng.step()                               # one decode step, no admission
    got = {k: v for k, v in collectives.result_bytes.items() if v}
    want = roofline.collective_bytes(eng.params, eng.cfg, eng.slots, eng._slot_state)
    assert got == {k: v for k, v in want.items() if v}
    cost = roofline.decode_step_cost(eng.params, eng.cfg, eng.slots, eng.max_len,
                                     eng._slot_state)
    assert cost.coll_detail == want
    unsharded = roofline.collective_bytes(eng.params, eng.cfg, eng.slots)
    kv = [(p, leaf) for p, leaf in flatten_with_path(eng._slot_state) if p[-1] == "k"]
    tally = roofline._Tally()
    roofline._recurrent_collectives(eng.params, eng._slot_state, eng.cfg, eng.slots,
                                    eng.cfg.dtype.itemsize, tally)
    recurrent = tally.bytes["forward"]
    if isinstance(shape, Seq) or len(shape) == 3:
        lays = [(SC.layout(leaf), math.prod(leaf.shape[:-4])) for _, leaf in kv]
        assert all(lay.data_dim == (-3 if isinstance(shape, Seq) else -4) for lay, _ in lays)
        if isinstance(shape, Seq):       # one merge per layer use and KV-head piece
            maxima = [g for g in gathered if g.dim() == 6 and g.shape[:2] == (2, eng.slots)]
            assert len(maxima) == sum(uses * (lay.model if lay.model_dim == -2 else 1)
                                      for lay, uses in lays) > 0
    elif arch == "rwkv6-3b" and BRANCH[arch][shape] == "heads":
        # no gather of the r/k/v/g projections (4 [slots, d] a layer); the
        # time mix's rows and the two f32 carries gathered over the slots
        L, B, d, act = eng.cfg.n_layers, eng.slots, eng.cfg.d_model, eng.cfg.dtype.itemsize
        assert recurrent == {"all-gather": L * B * d * (-4 * act + act + 2 * 4)}
    elif BRANCH[arch][shape] == "heads" and shape[0] == 1:
        # the q (and k/v) projections' gathers are gone, nothing replaces
        # them (beyond a mamba y's gather over heads)
        assert got["all-gather"] - recurrent.get("all-gather", 0) < unsharded["all-gather"]
        assert got["all-reduce"] == unsharded["all-reduce"]
    elif BRANCH[arch][shape] == "hd":
        # one f32 sum of the partial scores [slots, H, T] per attention
        assert got["all-reduce"] == unsharded["all-reduce"] + sum(
            eng.slots * eng.cfg.n_heads * leaf.shape[-3] * 4 * math.prod(leaf.shape[:-4])
            for _, leaf in kv)
    # no gather holds cache positions (max_len of them a row)
    assert gathered and all(eng.max_len not in g.shape for g in gathered)


def test_auditor_finds_nothing_in_the_mesh_engines_steps():
    for shape in SHAPES:
        eng = _engine("gemma2-2b", shape)
        report = jit_audit.audit_engine(eng)
        assert report.diagnostics == [], [d.to_dict() for d in report.diagnostics]
        meta = api.init_cache(eng.cfg, eng.slots, eng.max_len, compact_local=False,
                              device="meta")
        assert report.budget["state_bytes"] == sum(t.numel() * t.element_size()
                                                   for _, t in flatten_with_path(meta))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b", "whisper-base"])
def test_auditor_finds_nothing_over_split_recurrent_state(arch):
    """Admission hands the recurrent pieces (and ``enc_len``'s) their rows
    through ``RowSplit`` with no host copy inside a step method."""
    eng = _engine(arch, (2, 2))
    assert SC.data_split(eng._slot_state) == 2
    report = jit_audit.audit_engine(eng)
    assert report.diagnostics == [], [d.to_dict() for d in report.diagnostics]


def test_sequence_split_raises():
    """Three slots over two data positions put the positions on "data"
    (the reference's sequence parallelism), which the engine once
    refused: it now serves them, every k/v leaf's 96 positions in two
    pieces of 48, with the unsharded engine's tokens."""
    _, _, cfg, params, _ = _models("gemma2-2b")
    eng = Engine(params, cfg, mesh=_mesh((2, 2)), **{**KW, "slots": 3})
    k = eng._slot_state["blocks"][0]["k"]
    assert _splits(k) == [(-3, "data"), (-2, "model")] and SC.data_split(eng._slot_state) == 1
    assert [p.shape[-3] for p in k.pieces] == [48, 48]
    want = _ids(Engine(params, cfg, device="cpu", kv_layout="contiguous",
                       **{**KW, "slots": 3}))
    assert _ids(eng) == want


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_family_serves_a_sequence_split_and_a_pod_mesh(arch):
    """Three slots at (2, 2), which put every k/v leaf's positions on
    "data" (recurrent leaves stay whole along their slots), and four at
    (2, 2, 1) over ("pod", "data", "model"), which put every leaf's slots
    on "pod" and "data": each leaf as its spec says, each position the
    specs' bytes, and the unsharded engine's greedy tokens."""
    _, _, cfg, params, extra = _models(arch)
    for shape, slots in ((SEQ.mesh, SEQ.slots), (POD, 4)):
        eng = _engine(arch, shape, slots=slots)
        meta = api.init_cache(cfg, slots, eng.max_len, compact_local=False, device="meta")
        specs = dict(flatten_with_path(SH.cache_shardings(cfg, meta, eng.mesh),
                                       is_leaf=lambda x: isinstance(x, SH.P)))
        want_bytes = [0.0] * eng.mesh.size
        for path, leaf in flatten_with_path(eng._slot_state):
            assert SH.spec_of(leaf) == specs[path], (arch, shape, path, specs[path])
            n = SH.spec_bytes(leaf.shape, leaf.dtype.itemsize, specs[path], eng.mesh)
            want_bytes = [w + n for w in want_bytes]
            if path[-1] == "k" and shape == SEQ.mesh:
                assert SC.layout(leaf).data_dim == -3, (arch, path)
        assert [SC.state_position_bytes(eng._slot_state, i)
                for i in range(eng.mesh.size)] == want_bytes
        assert SC.data_split(eng._slot_state) == (1 if shape == SEQ.mesh else 4)
        flat = Engine(params, cfg, device="cpu", kv_layout="contiguous", extra_inputs=extra,
                      **{**KW, "slots": slots})
        assert _ids(eng) == _ids(flat), (arch, shape)


@pytest.mark.parametrize("arch,shape", [("gemma2-2b", SEQ), ("gemma2-2b", POD),
                                        ("paligemma-3b", SEQ), ("zamba2-7b", POD),
                                        ("whisper-base", POD)],
                         ids=["gemma2-2b-seq", "gemma2-2b-pod", "paligemma-3b-seq",
                              "zamba2-7b-pod", "whisper-base-pod"])
def test_auditor_finds_nothing_over_a_sequence_split_or_a_pod_mesh(arch, shape):
    """The sequence split's write (a masked write into every position
    piece) and the merge keep every row index on the device, and a pod
    mesh's admission hands its four pieces their rows through
    ``RowSplit``: nothing syncs or copies inside a step method."""
    eng = (_engine(arch, shape.mesh, slots=shape.slots) if isinstance(shape, Seq)
           else _engine(arch, shape))
    report = jit_audit.audit_engine(eng)
    assert report.diagnostics == [], [d.to_dict() for d in report.diagnostics]


def test_pool_records_what_each_position_holds():
    from test_torch_device_parallel import ENGINE_KW, _SameParamsSession

    from repro_torch.serving import scheduler as PS
    from repro_torch.training.data import ByteTokenizer
    _, _, cfg, params, _ = _models("gemma2-2b")
    mesh = _mesh((1, 4))
    pool = PS.ModelPool(_SameParamsSession(params, cfg, ByteTokenizer(512)), 100,
                        engine_kw={**ENGINE_KW, "device": "cpu"}, mesh=mesh,
                        entry_bytes=lambda m: 300)
    eng = pool.engine_for("big")
    assert pool.stats.sharded_admissions == 1
    assert [pool.device_bytes(i) for i in range(4)] == [75] * 4
    assert [pool.held_bytes(i) for i in range(4)] == [eng.position_bytes(i) for i in range(4)]
    assert all(b > 0 for b in (pool.held_bytes(i) for i in range(4)))
