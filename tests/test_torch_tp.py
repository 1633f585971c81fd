"""Tensor-parallel serving: ``Engine(mesh=)`` against the unsharded engines.

Every family at reduced widths in f32, its weights bridged from the
reference's init: the engine over a (1, 4) and a (2, 2) mesh whose
positions are all the CPU (the params placed by ``shard_params``) gives
the greedy tokens of the port's unsharded contiguous engine and of the
reference's single-device ``Engine`` on the same prompts.  paligemma-3b
serves with ``img_embs``, whisper-base from encoder frames; the
reference's engine reads an image position where the port reads the last
text one (ROADMAP queue 3), so the vlm rows are held to the reference's
``forward`` greedy tokens on the image-prefixed sequence instead.  Also:
``tiny_dense`` (tests/conftest.py) and its ``w8-absmax`` instance; each
position's bytes against the rule table; and a planted fault (the last
piece dropped from every sum: the row-parallel products and the sharded
table's lookups) must fail the token check.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rregistry  # noqa: E402
from repro.core.pipeline import InstanceOptimizer as RInstanceOptimizer  # noqa: E402
from repro.core.pipeline import Recipe as RRecipe  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.serving.engine import Engine as REngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.core.compressed import ShardedTensor, position_bytes  # noqa: E402
from repro_torch.core.pipeline import InstanceOptimizer, Recipe  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch.dryrun import bytes_per_position  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.training.data import ByteTokenizer  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

ROWS = ["fix: pyton", "fix: javascrpt", "translate: bonjour le monde", "fix: rst"]
KW = dict(slots=4, max_len=96, buckets=(32,))
MAX_NEW = 6
SHAPES = ((1, 4), (2, 2))
W8 = dict(name="w8-absmax", wbits=8, quant_method="absmax")

ARCHS = {
    "gemma2-2b": dict(n_layers=2, attn_pattern="LG", d_model=128, n_heads=4, n_kv_heads=2,
                      head_dim=32, d_ff=256, vocab_size=512),
    "granite-20b": dict(n_layers=2, d_model=128, n_heads=16, n_kv_heads=1, head_dim=16,
                        d_ff=256, vocab_size=512),
    "qwen2-moe-a2.7b": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
                            d_ff=256, moe_d_ff=128, vocab_size=512, n_experts=4),
    "zamba2-7b": dict(n_layers=7, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
                      vocab_size=512, ssd_head_dim=32),
    "rwkv6-3b": dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64, d_ff=256,
                     vocab_size=512),
    "paligemma-3b": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
                         d_ff=256, vocab_size=512, n_img_tokens=8),
    "whisper-base": dict(n_enc_layers=2, n_dec_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                         head_dim=32, d_ff=256, vocab_size=516, enc_ctx=32),
}
_MODELS = {}


def _models(arch):
    """(reference cfg, reference params, port cfg, port params, extra
    inputs as numpy) in f32."""
    if arch not in _MODELS:
        rcfg = rregistry.get_config(arch).replace(param_dtype="float32", **ARCHS[arch])
        rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
        cfg = from_reference(rcfg)
        rng = np.random.default_rng(3)
        extra = {}
        if cfg.family == "vlm":
            extra = {"img_embs": rng.standard_normal((cfg.n_img_tokens, cfg.d_model),
                                                     dtype=np.float32)}
        elif cfg.family == "encdec":
            extra = {"enc_inputs": rng.standard_normal((20, cfg.d_model), dtype=np.float32)}
        _MODELS[arch] = (rcfg, rparams, cfg, bridge.from_reference(rparams, device="cpu"), extra)
    return _MODELS[arch]


def _mesh(shape):
    """A CPU mesh over ("data", "model"), or ("pod", "data", "model") for a
    three-axis shape."""
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return make_mesh(shape, axes, device="cpu")


def _ids(eng, rows=ROWS, max_new=MAX_NEW):
    return [r.out_ids for r in eng.generate(rows, max_new=max_new, return_requests=True)]


def _ref_forward_greedy(rparams, rcfg, text, img, max_new, tok):
    """The reference's ``forward`` greedy tokens on the image-prefixed
    sequence, recomputed every step."""
    ids, out = tok.encode(text, bos=True) + [tok.SEP], []
    for _ in range(max_new):
        lg, _ = rapi.forward(rparams, rcfg, {"tokens": jnp.asarray([ids + out]),
                                             "img_embs": jnp.asarray(img)[None]}, remat=False)
        out.append(int(np.asarray(lg[0, -1]).argmax()))
        if out[-1] == tok.EOS:
            break
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_sharded_engine_tokens_equal_unsharded_and_reference(arch):
    rcfg, rparams, cfg, params, extra = _models(arch)
    flat = Engine(params, cfg, device="cpu", kv_layout="contiguous", extra_inputs=extra, **KW)
    want = _ids(flat)
    for shape in SHAPES:
        eng = Engine(params, cfg, mesh=_mesh(shape), extra_inputs=extra, **KW)
        assert not eng._paged and eng.device == torch.device("cpu")
        assert eng._placement_tag.startswith(f"@mesh{shape[0]}x{shape[1]}:")
        assert any(isinstance(t, ShardedTensor) for _, t in flatten_with_path(eng.params))
        assert _ids(eng) == want, (arch, shape)
    tok = ByteTokenizer(max(cfg.vocab_size, 260))
    if cfg.family == "vlm":
        for text, ids in list(zip(ROWS, want))[:2]:
            assert ids[:4] == _ref_forward_greedy(rparams, rcfg, text, extra["img_embs"], 4,
                                                  tok), text
        return
    ref = REngine(rparams, rcfg, backend="reference", kv_layout="contiguous",
                  extra_inputs={k: jnp.asarray(v) for k, v in extra.items()}, **KW)
    rreqs = [ref.submit(t, max_new=MAX_NEW) for t in ROWS]
    ref.drain()
    assert [r.out_ids for r in rreqs] == want, arch


@pytest.fixture(scope="module")
def tiny_f32(tiny_dense):
    rcfg, rparams = tiny_dense
    rcfg = rcfg.replace(param_dtype="float32")
    rparams = jax.tree.map(lambda a: a.astype(jnp.float32), rparams)
    return rcfg, rparams, from_reference(rcfg), bridge.from_reference(rparams, device="cpu")


@pytest.mark.parametrize("which", ["base", "w8"])
def test_tiny_dense_and_its_w8_instance(which, tiny_f32):
    rcfg, rparams, cfg, params = tiny_f32
    if which == "w8":
        rparams, _, _ = RInstanceOptimizer(rparams, rcfg).apply(RRecipe(**W8))
        params, cfg, _ = InstanceOptimizer(params, cfg).apply(Recipe(**W8))
    want = _ids(Engine(params, cfg, device="cpu", kv_layout="contiguous", **KW), max_new=8)
    ref = REngine(rparams, rcfg, backend="reference", kv_layout="contiguous", **KW)
    rreqs = [ref.submit(t, max_new=8) for t in ROWS]
    ref.drain()
    assert [r.out_ids for r in rreqs] == want
    for shape in SHAPES:
        assert _ids(Engine(params, cfg, mesh=_mesh(shape), **KW), max_new=8) == want, shape


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-moe-a2.7b", "whisper-base"])
@pytest.mark.parametrize("which", ["base", "w8"])
def test_position_bytes_follow_the_rule_table(arch, which):
    """Each position holds the rule table's share of every leaf, plus the
    whole of each ``QTensor`` the port keeps whole along "model"."""
    _, _, cfg, params, _ = _models(arch)
    if which == "w8":
        params, cfg, _ = InstanceOptimizer(params, cfg).apply(Recipe(**W8))
    for shape in SHAPES:
        mesh = _mesh(shape)
        placed = SH.shard_params(params, cfg, mesh)
        want = bytes_per_position(params, SH.param_shardings(cfg, params, mesh))
        want += sum(k["extra_bytes_per_position"]
                    for k in SH.replicated_qtensor_leaves(params, cfg, mesh))
        got = [position_bytes(placed, i) for i in range(mesh.size)]
        assert got == [pytest.approx(want, rel=1e-12)] * mesh.size, (arch, which, shape)


def test_planted_fault_fails_the_token_check(monkeypatch):
    """Dropping the last piece from every sum changes the served tokens:
    the check above would catch it."""
    _, _, cfg, params, _ = _models("gemma2-2b")
    want = _ids(Engine(params, cfg, device="cpu", kv_layout="contiguous", **KW))
    real = collectives.all_reduce_sum
    monkeypatch.setattr(collectives, "all_reduce_sum",
                        lambda pieces, **kw: real(pieces[:-1], **kw))
    got = _ids(Engine(params, cfg, mesh=_mesh((1, 4)), **KW))
    assert got != want


def test_meshes_default_to_the_card():
    """``make_mesh`` and ``make_host_mesh`` put every position on the card
    unless the caller asks for the CPU, as every entry point of the port
    does; the production meshes are shape-only, on ``meta``."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    for make in (lambda **kw: make_mesh((2, 2), ("data", "model"), **kw), make_host_mesh):
        if torch.cuda.is_available():
            assert {d.type for d in make().devices.flat} == {"cuda"}
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                make()
        mesh = make(device="cpu")
        assert mesh.shape == {"data": 2, "model": 2}
        assert {str(d) for d in mesh.devices.flat} == {"cpu"}
    pod = make_production_mesh(multi_pod=True)
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert {str(d) for d in pod.devices.flat} == {"meta"}
