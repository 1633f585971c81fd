"""The compact local-window cache and its step builders vs the reference's.

A local (``"L"``) layer of ``init_cache(compact_local=True)`` keeps a
circular buffer of T = min(window, max_len) slots, position p at slot
p % T; ``prefill`` fills it with the last T positions, rolled, or pads
when the prompt is shorter than T.  Reduced gemma2-2b (``"LG" * 2``) and
reduced gemma3-1b (``"LLLLLG" + "LL"``), both at window 64, in f32, on the
reference's weights (``jax.random`` from a fixed key, bridged) and numpy
tokens from a seed:

- equal-length prompts of 128 tokens (two windows) at ``max_len`` 192,
  then 8 greedy decode steps from position 128, which wrap every local
  buffer; and prompts of 32 tokens (the padding branch);
- logits within 5e-5 of the largest |logit| of the reference's, greedy
  tokens identical, every K/V leaf equal to the reference's slot for slot
  within 5e-5 of its largest |value|, after prefill and after the steps.
  The bound is the two frameworks' f32 noise, not the layout's: the
  port's and the reference's plain ``forward`` on these weights and
  tokens, with no cache at all, part by up to 1.44e-5 (gemma3-1b, S
  128), and the prefill's K/V by up to 2.03e-5;
- the layout itself is held to 1e-5 within the port: every compact
  local leaf is the absolute cache's last window, rolled, bit for bit,
  and the compact steps' logits are the absolute steps' within 1e-5;
- ``build_prefill_step``/``build_serve_step`` give the reference's
  outputs under the same tolerance;
- ``cache_spec`` gives the reference's shapes, at reduced and published
  widths: one row of gemma3-1b at 524,288 positions holds 2,159,017,984
  bytes of K/V in bf16 (13,958,643,712 at absolute slots), one row of
  gemma2-2b at 32,768 holds 1,962,934,272 (3,489,660,928);
- the hybrid, rwkv and encdec caches ignore ``compact_local``, as the
  reference's do;
- rows must have equal lengths: a right-padded shorter row loses its
  real positions to the roll, in both packages alike;
- the compact cache placed on a (1, 2) mesh (the dry run's decode cells
  place it so) decodes past the window as the unplaced one does: the
  sharded attention writes at slot pos % T too.
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
from repro.models import transformer as rT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference, registry  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.roofline import ShapeSpec  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import sharded_cache as SC  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

TOL = 5e-5            # f32 across frameworks: relative to the reference's largest |value|
LAYOUT_TOL = 1e-5     # f32 within the port: compact steps against absolute ones
MAX_LEN = 192
STEPS = 8
ARCHS = ["gemma2-2b", "gemma3-1b"]

_MODELS = {}


def _model(arch):
    """(reference cfg, reference params, port cfg, port params), f32."""
    if arch not in _MODELS:
        rcfg = rregistry.get_reduced(arch).replace(param_dtype="float32")
        assert rcfg.window_size == 64
        rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
        _MODELS[arch] = (rcfg, rparams, from_reference(rcfg),
                         bridge.from_reference(rparams, device="cpu"))
    return _MODELS[arch]


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(4, cfg.vocab_size, (B, S)).astype(np.int32)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _check_cache(got, want, T_local):
    """Every k/v leaf of the port's cache equals the reference's slot for
    slot; local leaves hold ``T_local`` slots."""
    rleaves = jax.tree_util.tree_flatten_with_path(want)[0]
    pleaves = flatten_with_path(got)
    assert len(rleaves) == len(pleaves)
    for (_, w), (path, g) in zip(rleaves, pleaves):
        assert tuple(g.shape) == tuple(w.shape), path
        assert _rel(g.numpy(), w) < TOL, path
    assert T_local in {g.shape[-3] for _, g in pleaves}


_DECODE = {}


def _reference_run(arch, S):
    """The reference's compact prefill and STEPS jitted greedy decode
    steps: (tokens, prefill logits, prefill cache, [(fed tokens, pos,
    logits)], final cache).  Cached per (arch, S)."""
    if (arch, S) in _DECODE:
        return _DECODE[arch, S]
    rcfg, rparams, _, _ = _model(arch)
    toks = _tokens(rcfg, 2, S, 7)
    logits, rcache = rapi.prefill(rparams, rcfg, {"tokens": jnp.asarray(toks)},
                                  max_len=MAX_LEN, compact_local=True)
    first = jax.tree.map(np.asarray, rcache)
    step = jax.jit(lambda c, t, p: rapi.decode_step(rparams, rcfg, c, t, p, max_len=MAX_LEN))
    tok = np.asarray(logits)[:, -1].argmax(-1).astype(np.int32)
    feeds = []
    for i in range(STEPS):
        pos = np.full((2,), S + i, np.int32)
        out, rcache = step(rcache, jnp.asarray(tok[:, None]), jnp.asarray(pos))
        out = np.asarray(out, np.float32)
        feeds.append((tok, pos, out))
        tok = out[:, -1].argmax(-1).astype(np.int32)
    _DECODE[arch, S] = (toks, np.asarray(logits, np.float32), first, feeds,
                        jax.tree.map(np.asarray, rcache))
    return _DECODE[arch, S]


@pytest.mark.parametrize("S", [128, 32])
@pytest.mark.parametrize("arch", ARCHS)
def test_compact_prefill_and_decode_match_reference(arch, S):
    """S 128: the last 64 positions rolled into every local buffer, then 8
    steps that wrap it (positions 128-135 at slots 0-7); S 32: the
    padding branch."""
    _, _, cfg, params = _model(arch)
    toks, want, first, feeds, final = _reference_run(arch, S)
    with torch.no_grad():
        got, cache = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                                 max_len=MAX_LEN)
        _, absolute = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                                  max_len=MAX_LEN, compact_local=False)
        assert _rel(got.numpy(), want) < TOL
        _check_cache(cache, first, 64)
        for (kind, c), (_, a) in zip(T._layers(cache, cfg), T._layers(absolute, cfg)):
            for n in ("k", "v"):
                if kind == "G":
                    assert torch.equal(c[n], a[n])
                elif S >= 64:             # the last window, position p at slot p % 64
                    assert torch.equal(c[n], torch.roll(a[n][:, S - 64:S], S % 64, dims=1))
                else:                     # the prompt, then zeros
                    assert torch.equal(c[n], a[n][:, :64])
        tok = got[:, -1].argmax(-1)
        for fed, pos, out in feeds:
            assert np.array_equal(tok.numpy(), fed)
            p = torch.from_numpy(pos).long()
            lg, cache = api.decode_step(params, cfg, cache, tok[:, None].long(), p,
                                        max_len=MAX_LEN)
            la, absolute = api.decode_step(params, cfg, absolute, tok[:, None].long(), p,
                                           max_len=MAX_LEN)
            assert _rel(lg.numpy(), out) < TOL
            assert _rel(lg.numpy(), la.numpy()) < LAYOUT_TOL
            tok = lg[:, -1].argmax(-1)
    _check_cache(cache, final, 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_builders_match_reference(arch):
    rcfg, rparams, cfg, params = _model(arch)
    toks, _, _, feeds, _ = _reference_run(arch, 128)
    rspec, spec = RShapeSpec("c", MAX_LEN, 2, "decode"), ShapeSpec("c", MAX_LEN, 2, "decode")
    want, rcache = rapi.build_prefill_step(rcfg, rspec)(rparams, {"tokens": jnp.asarray(toks)})
    rtok, rlog, rcache = rapi.build_serve_step(rcfg, rspec)(
        rparams, rcache, jnp.asarray(feeds[0][0][:, None]), jnp.asarray(feeds[0][1]))
    with torch.no_grad():
        got, cache = api.build_prefill_step(cfg, spec)(params, {"tokens": torch.from_numpy(toks)})
        assert got.shape == (2, 1, cfg.vocab_size) and _rel(got.numpy(), want) < TOL
        tok, lg, cache = api.build_serve_step(cfg, spec)(
            params, cache, got[:, -1].argmax(-1)[:, None], torch.from_numpy(feeds[0][1]))
    assert tok.dtype == torch.int32 and tok.shape == (2, 1)
    assert np.array_equal(tok.numpy(), np.asarray(rtok))
    assert _rel(lg.numpy(), rlog) < TOL
    _check_cache(cache, jax.tree.map(np.asarray, rcache), 64)


def _shapes(tree):
    return [tuple(t.shape) for _, t in flatten_with_path(tree)]


def _rshapes(tree):
    return [tuple(t.shape) for t in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_shapes_equal_reference(arch):
    for rcfg in (rregistry.get_reduced(arch), rregistry.get_config(arch)):
        cfg = from_reference(rcfg)
        for B, L in ((2, 192), (1, 32), (3, 64)):
            for compact in (True, False):
                got = T.cache_spec(cfg, B, L, compact_local=compact)
                assert {t.device.type for _, t in flatten_with_path(got)} == {"meta"}
                assert _shapes(got) == _rshapes(rT.cache_spec(rcfg, B, L,
                                                              compact_local=compact))


@pytest.mark.parametrize("arch,seq,compact,absolute", [
    ("gemma3-1b", 524288, 2159017984, 13958643712),
    ("gemma2-2b", 32768, 1962934272, 3489660928)])
def test_one_rows_cache_bytes_at_published_widths(arch, seq, compact, absolute):
    cfg = registry.get_config(arch)

    def nbytes(c):
        return sum(t.numel() * t.element_size() for _, t in flatten_with_path(c))
    assert cfg.dtype == torch.bfloat16
    assert nbytes(T.cache_spec(cfg, 1, seq)) == compact
    assert nbytes(api.init_cache(cfg, 1, seq, compact_local=False, device="meta")) == absolute


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-3b", "whisper-base"])
def test_other_families_ignore_compact_local(arch):
    rcfg = rregistry.get_reduced(arch)
    cfg = from_reference(rcfg)
    want = _rshapes(jax.eval_shape(lambda: rapi.init_cache(rcfg, 2, 96, compact_local=True)))
    assert want == _rshapes(jax.eval_shape(
        lambda: rapi.init_cache(rcfg, 2, 96, compact_local=False)))
    got = api.init_cache(cfg, 2, 96, compact_local=True, device="meta")
    assert _shapes(got) == _shapes(api.init_cache(cfg, 2, 96, compact_local=False,
                                                  device="meta"))
    assert sorted(_shapes(got)) == sorted(want)


def test_ragged_rows_lose_their_window_in_both_packages():
    """Row 1 holds 100 real tokens right-padded to 128.  The compact
    prefill rolls every row by 128, so row 1's local buffers keep its pads
    (positions 64-127) and lose its real positions 36-63: its next step,
    at position 100, parts from the absolute layout's, in the reference as
    in the port, while the full row 0 agrees.  The port's compact step
    equals the reference's."""
    rcfg, rparams, cfg, params = _model("gemma3-1b")
    toks = _tokens(rcfg, 2, 128, 11)
    toks[1, 100:] = 0
    tok = np.array([[5], [6]], np.int32)
    pos = np.array([128, 100], np.int32)
    want = {}
    for compact in (True, False):
        _, rc = rapi.prefill(rparams, rcfg, {"tokens": jnp.asarray(toks)}, max_len=MAX_LEN,
                             compact_local=compact)
        want[compact] = np.asarray(rapi.decode_step(rparams, rcfg, rc, jnp.asarray(tok),
                                                    jnp.asarray(pos), max_len=MAX_LEN)[0])
    got = {}
    with torch.no_grad():
        for compact in (True, False):
            _, c = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                               max_len=MAX_LEN, compact_local=compact)
            got[compact] = api.decode_step(params, cfg, c, torch.from_numpy(tok).long(),
                                           torch.from_numpy(pos).long(),
                                           max_len=MAX_LEN)[0].numpy()
    for res in (want, got):
        assert _rel(res[True][0], res[False][0]) < TOL
        assert _rel(res[True][1], res[False][1]) > 1e-2
    for compact in (True, False):
        assert _rel(got[compact], want[compact]) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_compact_cache_decodes_past_the_window(arch):
    """Reduced gemma2-2b splits its 2 KV heads over "model", reduced
    gemma3-1b (1 KV head) its head_dim.  Positions 128-135 land at slots
    0-7 of every local piece; logits and every gathered K/V leaf equal the
    unplaced compact cache's within 1e-5."""
    _, _, cfg, params = _model(arch)
    toks, _, _, feeds, _ = _reference_run(arch, 128)
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    with torch.no_grad():
        got, cache = api.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                                 max_len=MAX_LEN)
        placed = SC.place_slot_state({sec: [{n: t.clone() for n, t in e.items()}
                                            for e in cache[sec]]
                                      for sec in ("blocks", "tail")}, cfg, mesh)
        assert any(isinstance(t, SH.ShardedTensor) for _, t in flatten_with_path(placed))
        sharded = SH.shard_params(params, cfg, mesh)
        tok = got[:, -1].argmax(-1)[:, None].long()
        for _, pos, _ in feeds:
            p = torch.from_numpy(pos).long()
            want, cache = api.decode_step(params, cfg, cache, tok, p, max_len=MAX_LEN)
            lg, placed = api.decode_step(sharded, cfg, placed, tok, p, max_len=MAX_LEN)
            assert _rel(lg.numpy(), want.numpy()) < LAYOUT_TOL
            tok = want[:, -1].argmax(-1)[:, None].long()
    for (path, g), (_, w) in zip(flatten_with_path(placed), flatten_with_path(cache)):
        assert _rel(SC.read_slots(g, "cpu").numpy(), w.numpy()) < LAYOUT_TOL, path
