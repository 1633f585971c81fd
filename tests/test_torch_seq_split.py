"""Decode over a slot state split along its positions, or over (pod, data).

The reference's ``cache_shardings`` (``distributed/sharding.py``) puts a
k/v leaf's positions on "data" when its slots do not divide that axis
(the sequence split of the ``long_500k`` cells), and every slot-state
leaf's slots on ``("pod", "data")`` on the multi-pod mesh.  The port
places both (``models/sharded_cache.py`` ``place_slot_state``) and
decodes over them: each position piece keeps its own softmax sums, which
merge in mesh order.

- Placement and bytes, on the production meshes' ``meta`` positions
  ((16, 16) and (2, 16, 16)): every leaf of gemma3-1b's and zamba2-7b's
  ``long_500k`` cache and of every architecture's ``decode_32k`` cache
  is cut as its spec says (``spec_of`` reads the spec back, tuple axes
  included), and each position holds the specs' ``spec_bytes``.
- Decode, reduced models in f32 on the reference's weights: three rows
  of 64 equal-length tokens prefilled into the compact cache at
  ``max_len`` 192, then 8 greedy steps (positions 64-71: every local
  buffer wraps, and the last position piece of every global layer holds
  no valid slot).  gemma3-1b at (2, 1), (2, 2) (``head_dim`` over
  "model") and (4, 1), zamba2-7b's shared K/V and gemma2-2b (softcap 50,
  KV heads over "model") at (2, 2), and gemma3-1b at (2, 2, 1) over
  ("pod", "data", "model"), whose "data" axis takes the positions:
  logits within 1e-5 of the largest |logit| of the
  unplaced compact cache's (the layout's tolerance within the port,
  ``tests/test_torch_compact_cache.py``) and within 5e-5 of the
  reference's unsharded ``build_serve_step`` (the two frameworks' f32
  noise), greedy tokens identical.
- The write: one step's k/v lands only in the piece holding slot
  ``pos % T``, at its local offset.
- A planted fault: a merge that drops the last piece's weight
  ``e^{m_i - m}`` fails the token check.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rregistry  # noqa: E402
from repro.configs.base import ShapeSpec as RShapeSpec  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference, registry  # noqa: E402
from repro_torch.core.compressed import ShardedTensor  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.roofline import ShapeSpec  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import sharded_cache as SC  # noqa: E402
from repro_torch.tree import flatten_with_path, tree_map  # noqa: E402

LAYOUT_TOL = 1e-5     # f32 within the port: placed against unplaced
TOL = 5e-5            # f32 across frameworks
ROWS, PROMPT, MAX_LEN, STEPS = 3, 64, 192, 8
POD_AXES = ("pod", "data", "model")


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _mesh(shape):
    return make_mesh(shape, POD_AXES if len(shape) == 3 else ("data", "model"), device="cpu")


# ---------------------------------------------------------------------------
# placement and bytes on the production meshes
# ---------------------------------------------------------------------------

CELLS = [("gemma3-1b", "long_500k"), ("zamba2-7b", "long_500k")] + [
    (a, "decode_32k") for a in registry.ARCH_IDS]


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_placed_leaves_and_bytes_follow_cache_shardings(arch, shape, multi):
    cfg = registry.get_config(arch)
    mesh = make_production_mesh(multi_pod=multi)
    spec = dryrun.SHAPES[shape]
    cache = api.init_cache(cfg, spec.global_batch, spec.seq_len, compact_local=True,
                           device="meta")
    specs = dict(flatten_with_path(SH.cache_shardings(cfg, cache, mesh), is_leaf=SH._is_spec))
    placed = SC.place_slot_state(cache, cfg, mesh)
    want = [0.0] * mesh.size
    splits = set()
    for path, leaf in flatten_with_path(placed):
        assert SH.spec_of(leaf) == specs[path], (path, specs[path])
        if isinstance(leaf, ShardedTensor):
            splits.add((path[-1], SC.layout(leaf).data_dim if path[-1] in ("k", "v")
                        else leaf.dim, leaf.axis))
        n = SH.spec_bytes(leaf.shape, leaf.dtype.itemsize, specs[path], mesh)
        want = [w + n for w in want]
    assert [SC.state_position_bytes(placed, i) for i in range(mesh.size)] == want
    if shape == "long_500k":            # one row: the positions over "data"
        assert ("k", -3, "data") in splits
        assert SC.data_split(placed) == 1
    elif multi:                          # 128 slots over pod x data
        assert {ax for _, _, ax in splits} >= {"pod"} and SC.data_split(placed) == 32


def test_gemma3_long_500k_holds_a_256th_at_every_position():
    """One row of gemma3-1b at 524,288 positions in bf16: 2,159,017,984 B
    of K/V, its positions over 16 "data" pieces and its head_dim over 16
    "model" ones, so every position of either mesh holds 1/256 of it."""
    cfg = registry.get_config("gemma3-1b")
    cache = api.init_cache(cfg, 1, 524288, compact_local=True, device="meta")
    for multi in (False, True):
        placed = SC.place_slot_state(cache, cfg, make_production_mesh(multi_pod=multi))
        assert {SC.state_position_bytes(placed, i) for i in (0, 17, 255)} == {2159017984 / 256}


# ---------------------------------------------------------------------------
# decode over the placed cache
# ---------------------------------------------------------------------------

_MODELS, _REF = {}, {}


def _model(arch):
    """(reference cfg, reference params, port cfg, port params), f32."""
    if arch not in _MODELS:
        rcfg = rregistry.get_reduced(arch).replace(param_dtype="float32")
        rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
        _MODELS[arch] = (rcfg, rparams, from_reference(rcfg),
                         bridge.from_reference(rparams, device="cpu"))
    return _MODELS[arch]


def _tokens(cfg):
    return np.random.default_rng(5).integers(4, cfg.vocab_size, (ROWS, PROMPT)).astype(np.int32)


def _reference(arch):
    """The reference's unsharded prefill and STEPS greedy serve steps:
    [(fed tokens, logits)]."""
    if arch not in _REF:
        rcfg, rparams, _, _ = _model(arch)
        rspec = RShapeSpec("c", MAX_LEN, ROWS, "decode")
        last, cache = rapi.build_prefill_step(rcfg, rspec)(
            rparams, {"tokens": jnp.asarray(_tokens(rcfg))})
        serve = jax.jit(rapi.build_serve_step(rcfg, rspec))
        tok = np.asarray(last)[:, -1].argmax(-1).astype(np.int32)[:, None]
        out = []
        for i in range(STEPS):
            nxt, lg, cache = serve(rparams, cache, jnp.asarray(tok),
                                   jnp.full((ROWS,), PROMPT + i, jnp.int32))
            out.append((tok, np.asarray(lg, np.float32)))
            tok = np.asarray(nxt)
        _REF[arch] = out
    return _REF[arch]


def _prefill(arch):
    _, _, cfg, params = _model(arch)
    spec = ShapeSpec("c", MAX_LEN, ROWS, "decode")
    with torch.no_grad():
        last, cache = api.build_prefill_step(cfg, spec)(
            params, {"tokens": torch.from_numpy(_tokens(cfg)).long()})
    return last[:, -1].argmax(-1).to(torch.int32)[:, None], cache


def _decode(params, cfg, cache, tok, steps=STEPS):
    """STEPS greedy serve steps: [(fed tokens, logits)]."""
    serve = api.build_serve_step(cfg, ShapeSpec("c", MAX_LEN, ROWS, "decode"))
    out = []
    with torch.no_grad():
        for i in range(steps):
            nxt, lg, cache = serve(params, cache, tok, torch.full((ROWS,), PROMPT + i))
            out.append((tok.numpy(), lg.numpy()))
            tok = nxt
    return out


def _placed_run(arch, shape):
    _, _, cfg, params = _model(arch)
    tok, cache = _prefill(arch)
    mesh = _mesh(shape)
    placed = SC.place_slot_state(cache, cfg, mesh)
    return _decode(SH.shard_params(params, cfg, mesh), cfg, placed, tok), placed


CASES = [("gemma3-1b", (2, 1)), ("gemma3-1b", (2, 2)), ("gemma3-1b", (4, 1)),
         ("zamba2-7b", (2, 2)), ("gemma2-2b", (2, 2)), ("gemma3-1b", (2, 2, 1))]
# (2, 2, 1): the multi-pod mesh's sequence split (three rows over pod x data)


@pytest.mark.parametrize("arch,shape", CASES, ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else v)
def test_placed_decode_matches_unplaced_and_reference(arch, shape):
    _, _, cfg, params = _model(arch)
    tok, cache = _prefill(arch)
    want = _decode(params, cfg, cache, tok)
    got, placed = _placed_run(arch, shape)
    kv = [t for p, t in flatten_with_path(placed) if p[-1] == "k"]
    lays = {SC.layout(t) for t in kv}
    # three rows: neither "data" nor pod x data divides them, so the
    # positions go over "data"
    n = shape[-2]
    assert {(lay.data, lay.data_dim) for lay in lays} == {(n, -3)}
    # the last position piece of every layer at max_len holds no valid slot
    assert max(t.shape[-3] for t in kv) == MAX_LEN and PROMPT + STEPS <= MAX_LEN // n * (n - 1)
    if shape[-1] == 2:
        assert {lay.model_dim for lay in lays} == {-1 if cfg.n_kv_heads % 2 else -2}
    ref = _reference(arch)
    for (t_want, l_want), (t_got, l_got), (t_ref, l_ref) in zip(want, got, ref):
        assert np.array_equal(t_got, t_want) and np.array_equal(t_got, t_ref)
        assert _rel(l_got, l_want) < LAYOUT_TOL
        assert _rel(l_got, l_ref) < TOL


def test_pod_mesh_splits_the_slots_when_they_divide():
    """Four rows on (2, 2, 1): every k/v leaf's slots over "pod" then
    "data", one row a piece, and decode equal to the unplaced cache's."""
    _, _, cfg, params = _model("gemma3-1b")
    mesh = _mesh((2, 2, 1))
    spec = ShapeSpec("c", MAX_LEN, 4, "decode")
    toks = torch.from_numpy(np.random.default_rng(9).integers(4, cfg.vocab_size, (4, PROMPT)))
    serve = api.build_serve_step(cfg, spec)
    with torch.no_grad():
        last, cache = api.build_prefill_step(cfg, spec)(params, {"tokens": toks.long()})
        placed = SC.place_slot_state(tree_map(torch.clone, cache), cfg, mesh)
        k = placed["blocks"][0]["k"]
        assert SH.spec_of(k) == SH.P(None, ("pod", "data"), None, None, None)
        assert SC.layout(k) == SC.KVLayout(4, None, 1, -4) and SC.data_split(placed) == 4
        assert [p.shape[-4] for p in SC.dim_pieces(k)] == [1] * 4
        a = b = last[:, -1].argmax(-1).to(torch.int32)[:, None]
        for i in range(STEPS):
            pos = torch.full((4,), PROMPT + i)
            a, la, cache = serve(params, cache, a, pos)
            b, lb, placed = serve(params, placed, b, pos)
            assert torch.equal(a, b) and _rel(lb.numpy(), la.numpy()) < LAYOUT_TOL


def test_a_step_writes_only_the_piece_holding_its_slot():
    """gemma3-1b at (4, 1), a step at position 64: the global layer's
    192 slots in pieces of 48 take it in piece 1 at offset 16, a local
    layer's 64-slot buffer in pieces of 16 at slot 0 of piece 0; every
    other entry of every piece stays bit for bit."""
    _, _, cfg, params = _model("gemma3-1b")
    tok, cache = _prefill("gemma3-1b")
    before = SC.place_slot_state(tree_map(torch.clone, cache), cfg, _mesh((4, 1)))
    placed = SC.place_slot_state(cache, cfg, _mesh((4, 1)))
    serve = api.build_serve_step(cfg, ShapeSpec("c", MAX_LEN, ROWS, "decode"))
    with torch.no_grad():
        serve(params, placed, tok, torch.full((ROWS,), PROMPT))
    seen = set()
    for (path, new), (_, old) in zip(flatten_with_path(placed), flatten_with_path(before)):
        T = new.shape[-3]
        for s in range(4):
            a, b = SC.piece_of(new, s, 0), SC.piece_of(old, s, 0)
            changed = (a != b).flatten(-2).any(-1)             # [..., rows, Ts]
            hit = s == (PROMPT % T) // (T // 4)
            if hit:
                assert changed.sum(-1).eq(1).all(), path
                assert changed[..., (PROMPT % T) % (T // 4)].all(), path
                seen.add(T)
            else:
                assert not changed.any(), (path, s)
    assert seen == {64, MAX_LEN}


def test_planted_fault_in_the_merge_fails_the_token_check(monkeypatch):
    """The last position piece's weight ``e^{m_i - m}`` taken as 1: where
    that piece holds no valid slot its ``l_i`` (its slot count) joins the
    denominator, elsewhere its sums weigh too much."""
    _, _, cfg, params = _model("gemma3-1b")
    tok, cache = _prefill("gemma3-1b")
    want = _decode(params, cfg, cache, tok)
    real = SC.position_weights

    def dropped(ms, device):
        w = real(ms, device)
        return torch.cat([w[:-1], torch.ones_like(w[-1:])])
    monkeypatch.setattr(SC, "position_weights", dropped)
    got, _ = _placed_run("gemma3-1b", (4, 1))
    assert any(not np.array_equal(g[0], w[0]) for g, w in zip(got, want))
    assert max(_rel(g[1], w[1]) for g, w in zip(got, want)) > 1e-2


def test_chip_phase_rehearses_on_the_cpu():
    """``chip_smoke.py``'s ``seq_split_decode`` on reduced gemma3-1b: the
    compact caches ``long_decode(keep=True)`` leaves, placed at (2, 2) and
    (4, 1), decode with the unplaced runs' tokens, every position a
    quarter of each cache (its launch gates apply on the card only)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.configs import gemma3_1b
    _, kept = chip_smoke.long_decode(gemma3_1b.reduced(), device="cpu", prompt=128, steps=4,
                                     max_len=MAX_LEN, keep=True)
    line = chip_smoke.seq_split_decode(kept, device="cpu")
    assert set(line["runs"]) == {"f32_2x2", "bf16_2x2", "f32_4x1", "bf16_4x1"}
    for name, run in line["runs"].items():
        assert run["token_agreement"] == 1.0 and run["rms_rel_diff"] < 1e-5, name
        assert len(set(run["position_bytes"])) == 1
