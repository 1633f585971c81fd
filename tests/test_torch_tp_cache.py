"""A mesh engine's slot state sharded by ``cache_shardings``, attended where
its pieces live (``models/sharded_cache.py``).

Every family of ``test_torch_tp.py`` at (1, 4) and (2, 2) in f32: each
k/v leaf of ``Engine(mesh=)``'s slot state is a ``ShardedTensor`` whose
splits are the spec of ``distributed/sharding.py``'s ``cache_shardings``
(held leaf for leaf to the reference's by ``test_torch_sharding.py``),
every other leaf a tensor on the first device, and each position's state
bytes the k/v specs' ``spec_bytes`` plus, at position 0 alone, every
other leaf whole (where the reference's spec splits a recurrent leaf, the
difference is counted leaf by leaf: ROADMAP item 14b).  Both branches are covered: KV heads over "model" (qwen2-moe,
zamba2, whisper, gemma2 at (2, 2)) and ``head_dim`` over "model"
(granite, paligemma, gemma2 at (1, 4)).  ``test_torch_tp.py`` holds every
family's greedy tokens on this state to the unsharded engine's and the
reference's; here the ``w8`` instance and prefix-seeded rows too, the
decode step's recorded collectives against ``roofline.collective_bytes``
(no q/k/v gather where KV heads split, the partial-score sums and no
cache gather where ``head_dim`` splits), a planted fault (one piece's
heads written into another piece), the hot-path auditor and the pool's
record of what each position holds.
"""
import math

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

# which dim "model" cuts each family's k/v at each mesh (None: no k/v)
BRANCH = {"gemma2-2b": {(1, 4): "hd", (2, 2): "heads"},
          "granite-20b": {(1, 4): "hd", (2, 2): "hd"},
          "paligemma-3b": {(1, 4): "hd", (2, 2): "hd"},
          "qwen2-moe-a2.7b": {(1, 4): "heads", (2, 2): "heads"},
          "zamba2-7b": {(1, 4): "heads", (2, 2): "heads"},
          "whisper-base": {(1, 4): "heads", (2, 2): "heads"},
          "rwkv6-3b": {(1, 4): None, (2, 2): None}}
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
        SH.cache_shardings(cfg, api.init_cache(cfg, eng.slots, eng.max_len, device="meta"),
                           mesh), is_leaf=lambda x: isinstance(x, SH.P)))
    spec_total = [0.0] * mesh.size            # every leaf by the reference's spec
    item_14b = [0.0] * mesh.size              # placed minus spec, recurrent leaves
    branches = set()
    for path, leaf in flatten_with_path(eng._slot_state):
        spec = specs[path]
        if path[-1] in ("k", "v"):
            assert isinstance(leaf, ShardedTensor), (arch, shape, path)
            assert _splits(leaf) == _spec_splits(spec), (arch, shape, path, spec)
            branches |= {"heads" if d == -2 else "hd" for d, ax in _splits(leaf)
                         if ax == "model"}
            itemsize = leaf.dtype.itemsize
            for i in range(mesh.size):
                spec_total[i] += SH.spec_bytes(leaf.shape, itemsize, spec, mesh)
                piece = leaf.piece_at(i)
                assert piece.device == mesh.devices.flat[i]
                assert piece.numel() * itemsize == SH.spec_bytes(leaf.shape, itemsize, spec,
                                                                 mesh)
        else:                 # recurrent leaves and enc_len stay whole on the first device
            assert torch.is_tensor(leaf) and leaf.device == mesh.first_device, path
            whole = leaf.numel() * leaf.element_size()
            for i in range(mesh.size):
                part = SH.spec_bytes(leaf.shape, leaf.element_size(), spec, mesh)
                spec_total[i] += part
                item_14b[i] += (whole if i == 0 else 0) - part
    assert branches == ({BRANCH[arch][shape]} if BRANCH[arch][shape] else set())
    # the reference holds its share of every recurrent leaf and of whisper's
    # enc_len at every position (split over "data", rwkv S and mamba h over
    # "model" too); the port keeps them whole on position 0 alone (item 14b)
    kept_on_first = arch in ("rwkv6-3b", "zamba2-7b", "whisper-base")
    assert any(item_14b) == kept_on_first, (arch, shape, item_14b)
    want = [s + d for s, d in zip(spec_total, item_14b)]
    assert [SC.state_position_bytes(eng._slot_state, i) for i in range(mesh.size)] == want
    assert [eng.position_bytes(i) for i in range(mesh.size)] == [
        position_bytes(eng.params, i) + want[i] for i in range(mesh.size)]


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
                                        ("qwen2-moe-a2.7b", (1, 4))])
def test_planted_fault_fails_the_token_check(arch, shape, monkeypatch):
    _, _, cfg, params, _ = _models(arch)
    want = _ids(Engine(params, cfg, device="cpu", kv_layout="contiguous", **KW))
    monkeypatch.setattr(SC, "write_rows", _faulty_write_rows(SC.write_rows))
    assert _ids(_engine(arch, shape)) != want


@pytest.mark.parametrize("arch,shape", [("gemma2-2b", (1, 4)), ("gemma2-2b", (2, 2)),
                                        ("granite-20b", (2, 2)), ("qwen2-moe-a2.7b", (1, 4)),
                                        ("zamba2-7b", (2, 2)), ("whisper-base", (1, 4)),
                                        ("paligemma-3b", (1, 4))])
def test_decode_step_collectives_equal_the_roofline_count(arch, shape, monkeypatch):
    """One decode step of four live slots records what
    ``collective_bytes`` counts over the engine's sharded state; where KV
    heads split that is no gather of q/k/v, and where ``head_dim``
    splits no gather holds a layer's cache."""
    eng = _engine(arch, shape)
    for r in ROWS:
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
    if BRANCH[arch][shape] == "heads" and shape[0] == 1:
        # the q (and k/v) projections' gathers are gone, nothing replaces them
        assert got["all-gather"] < unsharded["all-gather"]
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
        meta = api.init_cache(eng.cfg, eng.slots, eng.max_len, device="meta")
        assert report.budget["state_bytes"] == sum(t.numel() * t.element_size()
                                                   for _, t in flatten_with_path(meta))


def test_sequence_split_raises():
    """Three slots over two data positions would put the positions on
    "data" (sequence parallelism): not handled, so the engine refuses."""
    _, _, cfg, params, _ = _models("gemma2-2b")
    with pytest.raises(NotImplementedError, match="sequence-split"):
        Engine(params, cfg, mesh=_mesh((2, 2)), **{**KW, "slots": 3})


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
