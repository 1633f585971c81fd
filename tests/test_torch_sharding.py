"""The port's sharding rules against the reference's rule table.

- ``param_spec_fn`` gives the reference's spec for every leaf of every
  registry architecture at its published widths (the reference's shapes
  from ``jax.eval_shape``, the port's from meta tensors), on the meshes
  (1, 4), (2, 2), (4, 1), (2, 4), (16, 16) and (2, 16, 16), with FSDP off
  and on.  The rule table reads only a mesh's axis names and shape, so
  the reference runs on a duck-typed mesh of any size.
- The same for the codes and scales of a ``w8-absmax`` instance at
  reduced widths (gemma2-2b, qwen2-moe), bridged from the reference's.
- ``cache_shardings``, ``batch_shardings``, ``logits_sharding`` and
  ``opt_state_shardings`` give the reference's specs on the forced
  4-device CPU meshes.
- The ``QTensor`` leaves the port keeps whole along "model" (a row split
  inside a quantization group) at gemma2-2b's and qwen2-moe's published
  widths, each with the bytes per position it holds beyond the
  reference's accounting, which the placed tree shows.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import registry as rregistry  # noqa: E402
from repro.core.pipeline import InstanceOptimizer as RInstanceOptimizer  # noqa: E402
from repro.core.pipeline import Recipe as RRecipe  # noqa: E402
from repro.distributed import sharding as RSH  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.training import optimizer as ROPT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference, registry  # noqa: E402
from repro_torch.core.compressed import QTensor, position_bytes  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.training import optimizer as OPT  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

MESHES = {(1, 4): ("data", "model"), (2, 2): ("data", "model"), (4, 1): ("data", "model"),
          (2, 4): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}
W8 = dict(name="w8-absmax", wbits=8, quant_method="absmax")


def duck_mesh(shape):
    return SimpleNamespace(axis_names=MESHES[shape], devices=np.empty(shape, dtype=object),
                           shape=dict(zip(MESHES[shape], shape)))


def _key(k):
    """A jax path entry as the port's path key."""
    for attr in ("key", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def ref_specs(params, rcfg, mesh, fsdp):
    fn = RSH.param_spec_fn(rcfg, mesh, fsdp=fsdp)
    return [(tuple(_key(k) for k in path), tuple(fn(path, tuple(leaf.shape))))
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]]


def port_specs(params, cfg, mesh, fsdp):
    """[(path, spec)] of every tensor, a container's children under their
    index, as the reference's pytree paths give them."""
    out = []
    for path, sh in flatten_with_path(SH.param_shardings(cfg, params, mesh, fsdp=fsdp),
                                      is_leaf=SH._is_sharding):
        if isinstance(sh, SH.ChildShardings):
            out.extend((path + (i,), tuple(c.spec)) for i, c in enumerate(sh))
        else:
            out.append((path, tuple(sh.spec)))
    return out


_SHAPES = {}


def _full(arch):
    """(reference abstract params, port meta params, port cfg) at full width."""
    if arch not in _SHAPES:
        rcfg = rregistry.get_config(arch)
        rparams = jax.eval_shape(lambda: rapi.init_params(jax.random.PRNGKey(0), rcfg))
        cfg = registry.get_config(arch)
        _SHAPES[arch] = (rcfg, rparams, cfg, roofline.meta_instance(cfg)[0])
    return _SHAPES[arch]


@pytest.mark.parametrize("arch", rregistry.ARCH_IDS)
def test_param_spec_fn_equals_reference_at_full_width(arch):
    rcfg, rparams, cfg, params = _full(arch)
    for shape in MESHES:
        for fsdp in (False, True):
            want = ref_specs(rparams, rcfg, duck_mesh(shape), fsdp)
            got = port_specs(params, cfg, duck_mesh(shape), fsdp)
            assert [p for p, _ in got] == [p for p, _ in want], (arch, shape)
            assert got == want, (arch, shape, fsdp,
                                 [(a, b) for a, b in zip(got, want) if a != b][:5])


REDUCED = {
    "gemma2-2b": dict(n_layers=2, attn_pattern="LG", d_model=256, n_heads=4, n_kv_heads=2,
                      head_dim=64, d_ff=512, vocab_size=512),
    "qwen2-moe-a2.7b": dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
                            d_ff=512, moe_d_ff=384, vocab_size=512, n_experts=4),
}


@pytest.mark.parametrize("arch", sorted(REDUCED))
def test_param_spec_fn_equals_reference_on_w8_codes_and_scales(arch):
    rcfg = rregistry.get_config(arch).replace(param_dtype="float32", **REDUCED[arch])
    rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
    rq, _, _ = RInstanceOptimizer(rparams, rcfg).apply(RRecipe(**W8))
    cfg = from_reference(rcfg)
    params = bridge.from_reference(rq, device="cpu")
    assert any(isinstance(t, QTensor) for _, t in flatten_with_path(params))
    for shape in ((1, 4), (2, 2), (2, 4)):
        for fsdp in (False, True):
            want = ref_specs(rq, rcfg, duck_mesh(shape), fsdp)
            got = port_specs(params, cfg, duck_mesh(shape), fsdp)
            assert got == want, (arch, shape, fsdp)


# ---------------------------------------------------------------------------
# batch, cache, logits and optimizer-state specs on the 4 CPU devices
# ---------------------------------------------------------------------------

FAMILIES = {
    "dense": ("gemma2-2b", REDUCED["gemma2-2b"]),
    "moe": ("qwen2-moe-a2.7b", REDUCED["qwen2-moe-a2.7b"]),
    "hybrid": ("zamba2-7b", dict(n_layers=7, d_model=128, n_heads=4, n_kv_heads=4,
                                 head_dim=32, d_ff=256, vocab_size=512, ssd_head_dim=32)),
    "rwkv": ("rwkv6-3b", dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
                              d_ff=512, vocab_size=512)),
    "vlm": ("paligemma-3b", dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
                                 d_ff=512, vocab_size=512, n_img_tokens=8)),
    "encdec": ("whisper-base", dict(n_enc_layers=2, n_dec_layers=2, d_model=128, n_heads=4,
                                    n_kv_heads=4, head_dim=32, d_ff=512, vocab_size=516,
                                    enc_ctx=32)),
}


def _meshes(quad_devices):
    return [(shape, jax.make_mesh(shape, ("data", "model"), devices=quad_devices))
            for shape in ((1, 4), (2, 2), (4, 1))]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cache_batch_logits_shardings_equal_reference(family, quad_devices):
    arch, kw = FAMILIES[family]
    rcfg = rregistry.get_config(arch).replace(**kw)
    cfg = from_reference(rcfg)
    for B, T in ((4, 16), (1, 32), (2, 8)):
        rcache = jax.eval_shape(lambda: rapi.init_cache(rcfg, B, T, compact_local=False))
        cache = api.init_cache(cfg, B, T, compact_local=False, device="meta")
        batch = {"tokens": (B, T), "labels": (B, T), "img_embs": (B, 8, rcfg.d_model),
                 "pos": (B,)}
        for shape, rmesh in _meshes(quad_devices):
            mesh = duck_mesh(shape)
            want = [tuple(s.spec) for s in jax.tree_util.tree_leaves(
                RSH.cache_shardings(rcfg, rcache, rmesh))]
            got = [tuple(s) for _, s in flatten_with_path(
                SH.cache_shardings(cfg, cache, mesh), is_leaf=SH._is_spec)]
            assert got == want, (family, B, T, shape)
            sds = {k: SimpleNamespace(shape=v) for k, v in batch.items()}
            want_b = {k: tuple(v.spec) for k, v in RSH.batch_shardings(rcfg, sds, rmesh).items()}
            got_b = {k: tuple(v) for k, v in SH.batch_shardings(cfg, sds, mesh).items()}
            assert got_b == want_b, (family, B, T, shape)
            assert tuple(SH.logits_sharding(cfg, mesh, B)) == \
                tuple(RSH.logits_sharding(rcfg, rmesh, B).spec)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_opt_state_shardings_equal_reference(kind, tiny_dense, quad_devices):
    rcfg, rparams = tiny_dense
    cfg = from_reference(rcfg)
    params = bridge.from_reference(rparams, device="cpu")
    ropt = ROPT.adamw() if kind == "adamw" else ROPT.adafactor()
    opt = OPT.adamw() if kind == "adamw" else OPT.adafactor()
    for shape, rmesh in _meshes(quad_devices):
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        for fsdp in (False, True):
            rsh = RSH.opt_state_shardings(RSH.param_shardings(rcfg, rparams, rmesh, fsdp=fsdp),
                                          rmesh, kind)
            want = [tuple(s.spec) for s in jax.tree_util.tree_leaves(
                rsh, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))]
            psh = SH.opt_state_shardings(SH.param_shardings(cfg, params, mesh, fsdp=fsdp),
                                         mesh, kind)
            got = [tuple(s.spec) for _, s in flatten_with_path(psh, is_leaf=SH._is_sharding)]
            assert got == want, (kind, shape, fsdp)
            # the specs line up with the optimizer state's leaves, in order
            rstate = jax.eval_shape(ropt.init, rparams)
            state = opt.init(params)
            assert [tuple(t.shape) for _, t in flatten_with_path(state)] == \
                [tuple(t.shape) for t in jax.tree_util.tree_leaves(rstate)]
            assert len(got) == len(jax.tree_util.tree_leaves(rstate))


# ---------------------------------------------------------------------------
# the QTensor leaves the port keeps whole along "model"
# ---------------------------------------------------------------------------

KEPT_WHOLE = {
    ("gemma2-2b", (1, 4)): [],
    ("gemma2-2b", (2, 2)): [],
    ("gemma2-2b", (16, 16)): ["blocks.0.mlp.wo", "blocks.1.mlp.wo"],        # 9216 / 16 = 576
    ("qwen2-moe-a2.7b", (1, 4)): ["blocks.0.moe.wo"],                        # 1408 / 4 = 352
    ("qwen2-moe-a2.7b", (2, 2)): ["blocks.0.moe.wo"],                        # 1408 / 2 = 704
    ("qwen2-moe-a2.7b", (16, 16)): ["blocks.0.moe.wo", "blocks.0.shared_mlp.wo"],
}


@pytest.mark.parametrize("arch,shape", sorted(KEPT_WHOLE))
def test_replicated_qtensor_leaves_and_their_bytes(arch, shape):
    cfg = registry.get_config(arch)
    params = dryrun.quantize_specs(roofline.meta_instance(cfg)[0], cfg)
    mesh = make_mesh(shape, MESHES[shape], device="meta")
    kept = SH.replicated_qtensor_leaves(params, cfg, mesh)
    assert [k["path"] for k in kept] == KEPT_WHOLE[arch, shape]
    M = shape[-1]
    for k in kept:
        leaf = params
        for part in k["path"].split("."):
            leaf = leaf[int(part)] if part.isdigit() else leaf[part]
        assert (leaf.shape[-2] // M) % leaf.group != 0
        spec = SH.param_spec_fn(cfg, mesh)(tuple(int(p) if p.isdigit() else p
                                                 for p in k["path"].split(".")) + (0,),
                                           tuple(leaf.q.shape))
        split = int(np.prod([SH.axis_size(mesh, a) for a in spec if a is not None]))
        assert k["extra_bytes_per_position"] == leaf.q.numel() / split * (M - 1)
    # the placed tree's position bytes: the reference's accounting plus those
    ref_bytes = dryrun.bytes_per_position(params, SH.param_shardings(cfg, params, mesh))
    placed = SH.shard_params(params, cfg, mesh)
    extra = sum(k["extra_bytes_per_position"] for k in kept)
    for i in (0, mesh.size - 1):
        assert position_bytes(placed, i) == pytest.approx(ref_bytes + extra, rel=1e-12)
