"""The dry run (``launch/dryrun.py``) and the roofline's collective term.

- ``--cell`` for gemma2-2b, qwen2-moe-a2.7b and granite-20b on both
  production meshes (decode and train shapes, FSDP on the large models'
  train cells) reports per-position param bytes equal to the sum over the
  reference's specs of the reference's shapes.
- The collective bytes of ``tiny_dense``'s sharded decode step at (1, 4)
  equal a count by hand, and the bytes the collectives record when the
  step runs; likewise over a mesh engine's sharded cache, at (1, 4)
  (``head_dim`` split) and (1, 2) (KV heads split).
- A single-pod decode cell counts attention over the cache placed as a
  mesh engine places it (both branches, by hand); so do the cells the
  mesh engine once could not place: ``long_500k``'s sequence split (its
  merge's gathers and sums by hand) and the multi-pod mesh's slots over
  "pod" and "data".  Every decode cell of ``--all`` says ``counted``.
- Decode cells build the compact cache (``compact_local=True``):
  gemma2-2b ``decode_32k`` and gemma3-1b ``long_500k`` hold the bytes
  per position that the reference's ``cache_spec(..., compact_local=True)``
  shapes hold under its ``cache_shardings`` rule, on both meshes.
- ``build_cell`` gives each kind of cell its pieces and step builder;
  ``registry.all_cells`` equals the reference's.
- ``--all`` finishes on meta tensors.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import registry as rregistry  # noqa: E402
from repro.distributed import sharding as RSH  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import transformer as rT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import api  # noqa: E402

MESH = {"single": ((16, 16), ("data", "model")), "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_param_bytes(arch, mesh_kind, fsdp):
    shape, axes = MESH[mesh_kind]
    mesh = SimpleNamespace(axis_names=axes, devices=np.empty(shape, dtype=object))
    rcfg = rregistry.get_config(arch)
    sds = jax.eval_shape(lambda: rapi.init_params(jax.random.PRNGKey(0), rcfg))
    fn = RSH.param_spec_fn(rcfg, mesh, fsdp=fsdp)
    total = 0.0
    for path, leaf in jax.tree_util.tree_flatten_with_path(sds)[0]:
        n = float(np.prod(leaf.shape)) * leaf.dtype.itemsize
        for ax in fn(path, tuple(leaf.shape)):
            if ax is not None:
                n /= RSH.axis_size(mesh, ax)
        total += n
    return total


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-moe-a2.7b", "granite-20b"])
@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_cell_param_bytes_equal_the_reference_specs(arch, mesh_kind, capsys):
    for shape in ("decode_32k", "train_4k"):
        assert dryrun.main(["--cell", f"{arch}:{shape}:{mesh_kind}"]) == 0
        line = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("DRYRUN_RESULT ")][-1]
        res = json.loads(line[len("DRYRUN_RESULT "):])
        assert res["status"] == "ok" and res["chips"] == int(np.prod(MESH[mesh_kind][0]))
        fsdp = shape == "train_4k" and rregistry.get_config(arch).param_count() > 5e9
        assert res["fsdp"] == fsdp
        assert res["param_bytes_per_position"] == pytest.approx(
            _ref_param_bytes(arch, mesh_kind, fsdp), rel=1e-12)
        assert res["bytes_per_position"] >= res["param_bytes_per_position"]
        assert set(res["memory"]) == ({"params", "batch", "cache"} if shape == "decode_32k"
                                      else {"params", "batch", "opt_state"})
        assert res["roofline"]["coll_bytes"] > 0 and res["roofline"]["t_collective"] > 0


def test_tiny_dense_decode_step_collective_bytes_by_hand(tiny_dense):
    """tiny_dense in f32 at (1, 4), 2 slots: d 64, 4 heads of 16 (wq 64 ->
    64, column), 2 KV heads (wk/wv replicated: 2 does not divide 4), wo
    64 -> 64 (row), wi/wg 64 -> 128 (column), the MLP's wo 128 -> 64
    (row), the tied 260 x 64 table (rows split).  A step gathers wq's,
    wi's and wg's outputs and the logits, and sums wo's outputs and the
    table's rows."""
    rcfg, rparams = tiny_dense
    rcfg = rcfg.replace(param_dtype="float32")
    cfg = from_reference(rcfg)
    params = bridge.from_reference(jax.tree.map(lambda a: a.astype("float32"), rparams),
                                   device="cpu")
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    S, f32 = 2, 4
    layers = 2
    gather = layers * S * (64 + 128 + 128) * f32 + S * 260 * f32
    reduce = layers * S * (64 + 64) * f32 + S * 64 * f32
    placed = SH.shard_params(params, cfg, mesh)
    cost = roofline.decode_step_cost(placed, cfg, S, 64)
    assert cost.coll_detail == {"all-gather": gather, "all-reduce": reduce}
    assert cost.coll_bytes == gather + reduce == 9760 and cost.chips == 4
    assert cost.t_collective == pytest.approx(9760 / roofline.LINK_BYTES_PER_S)
    unsharded = roofline.decode_step_cost(params, cfg, S, 64)
    assert unsharded.coll_bytes == 0 and unsharded.chips == 1
    assert cost.flops == unsharded.flops and cost.bytes_accessed == unsharded.bytes_accessed
    # what the collectives record when the step runs
    cache = api.init_cache(cfg, S, 64, compact_local=False, device="cpu")
    collectives.reset_result_bytes()
    with torch.no_grad():
        api.decode_step(placed, cfg, cache, torch.ones((S, 1), dtype=torch.long),
                        torch.full((S,), 3), max_len=64)
    assert {k: v for k, v in collectives.result_bytes.items() if v} == cost.coll_detail


@pytest.mark.parametrize("shape,gather,reduce", [
    # head_dim split: the step above, plus in each of the 2 layers the
    # partial scores' f32 sum [2 slots, 4 heads, 64 positions] and the
    # p @ v pieces' gather [2, 4, 16]
    ((1, 4), 2 * 2 * (64 + 128 + 128) * 4 + 2 * 260 * 4 + 2 * 2 * 4 * 16 * 4,
     2 * 2 * (64 + 64) * 4 + 2 * 64 * 4 + 2 * 2 * 4 * 64 * 4),
    # KV heads split: wq 64, wk/wv 32, wi/wg 128 and the logits gathered, less
    # the q/k/v gathers, which the per-head step no longer runs
    ((1, 2), 2 * 2 * (64 + 32 + 32 + 128 + 128) * 4 + 2 * 260 * 4 - 2 * 2 * 128 * 4,
     2 * 2 * (64 + 64) * 4 + 2 * 64 * 4)])
def test_tiny_dense_sharded_cache_collective_bytes_by_hand(tiny_dense, shape, gather, reduce):
    from repro_torch.models import sharded_cache as SC
    rcfg, rparams = tiny_dense
    rcfg = rcfg.replace(param_dtype="float32")
    cfg = from_reference(rcfg)
    params = bridge.from_reference(jax.tree.map(lambda a: a.astype("float32"), rparams),
                                   device="cpu")
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    S = 2
    placed = SH.shard_params(params, cfg, mesh)
    cache = SC.place_slot_state(api.init_cache(cfg, S, 64, compact_local=False, device="cpu"), cfg, mesh)
    assert SC.layout(cache["blocks"][0]["k"])[1] == (-1 if shape == (1, 4) else -2)
    cost = roofline.decode_step_cost(placed, cfg, S, 64, cache)
    assert cost.coll_detail == {"all-gather": gather, "all-reduce": reduce}
    collectives.reset_result_bytes()
    with torch.no_grad():
        api.decode_step(placed, cfg, cache, torch.ones((S, 1), dtype=torch.long),
                        torch.full((S,), 3), max_len=64)
    assert {k: v for k, v in collectives.result_bytes.items() if v} == cost.coll_detail


@pytest.mark.parametrize("arch,branch", [("gemma2-2b", "hd"), ("qwen2-moe-a2.7b", "heads")])
def test_decode_cells_count_the_sharded_cache(arch, branch):
    """A single-pod decode cell's collectives are the params' plus what
    attention over the cache placed as a mesh engine places it changes:
    its 128 slots over 16 "data" positions gather each layer's attention
    output [B, H, hd]; where ``head_dim`` splits (gemma2's 4 KV heads over
    16) the partial scores' f32 sum [B, H, T] and the ``p @ v`` pieces'
    gather are added, and where KV heads split (qwen2-moe's 16) the q/k/v
    column gathers are gone.  The cache is the compact one: T is a local
    layer's window (gemma2's 4096), a global layer's 32768."""
    from repro_torch.configs import registry
    cfg = registry.get_config(arch)
    res = dryrun.run_cell(arch, "decode_32k", "single")
    assert res["status"] == "ok" and res["cache_collectives"] == "counted"
    params, _ = roofline.meta_instance(cfg)
    mesh = make_mesh((16, 16), ("data", "model"), device="meta")
    unsharded = roofline.collective_bytes(SH.shard_params(params, cfg, mesh), cfg, 128)
    B, T, H, K, hd, L = 128, 32768, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, \
        cfg.n_layers
    act = torch.empty((), dtype=cfg.dtype).element_size()
    heads = B * H * hd * act * L
    got = res["roofline"]["coll_detail"]
    if branch == "hd":
        Ts = sum(min(cfg.window_size, T) if k == "L" else T for k in cfg.pattern())
        assert Ts == 13 * 4096 + 13 * 32768
        assert K % 16 and got == {"all-reduce": unsharded["all-reduce"] + B * H * Ts * 4,
                                  "all-gather": unsharded["all-gather"] + 2 * heads}
    else:
        assert K % 16 == 0 and got == {
            "all-reduce": unsharded["all-reduce"],
            "all-gather": unsharded["all-gather"] + heads - B * (H + 2 * K) * hd * act * L}


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_decode_cells_count_the_recurrent_pieces(arch):
    """A single-pod decode cell of a recurrent family runs its scans over
    the state placed as a mesh engine places it.  rwkv6-3b's 40 heads do
    not divide 16, so ``S`` is split over its 128 slots alone: each layer
    gathers its two f32 carries and its time mix's rows [B, d] over
    "data".  zamba2's notes say the same of its ``h``/``conv`` pieces."""
    from repro_torch.configs import registry
    cfg = registry.get_config(arch)
    res = dryrun.run_cell(arch, "decode_32k", "single")
    assert res["status"] == "ok"
    assert res["cache_collectives"] == "counted, recurrent pieces included"
    if arch != "rwkv6-3b":
        return
    params, _ = roofline.meta_instance(cfg)
    mesh = make_mesh((16, 16), ("data", "model"), device="meta")
    unsharded = roofline.collective_bytes(SH.shard_params(params, cfg, mesh), cfg, 128)
    act = torch.empty((), dtype=cfg.dtype).element_size()
    B, d, L = 128, cfg.d_model, cfg.n_layers
    assert cfg.n_heads % 16 and res["roofline"]["coll_detail"] == {
        "all-reduce": unsharded["all-reduce"],
        "all-gather": unsharded["all-gather"] + L * B * d * (2 * 4 + act)}


@pytest.mark.parametrize("arch,shape,mesh_kind", [("gemma3-1b", "long_500k", "single"),
                                                 ("gemma2-2b", "decode_32k", "multi")])
def test_decode_cells_a_mesh_engine_cannot_place_say_so(arch, shape, mesh_kind):
    """The two placements a mesh engine once refused, and whose cells said
    "not counted": a sequence-split cache (one slot; its positions over
    16 "data" pieces, ``head_dim`` over "model") and slots over "pod" and
    "data" (128 slots in 32 pieces of 4).  Both are placed now and their
    collectives counted.  gemma3-1b's sequence split adds, to the
    ``head_dim`` split's terms, each of its 26 layers' merge: the 16
    pieces' maxima gathered [16, 1, H] and the weighted numerators and
    denominators summed [1, H, hd + 1], in f32.  gemma2-2b's pod x data
    slots cost what 32 "data" pieces would: one gather of the rows'
    outputs a layer."""
    from repro_torch.configs import registry
    from repro_torch.models import sharded_cache as SC
    res = dryrun.run_cell(arch, shape, mesh_kind)
    assert res["status"] == "ok" and res["cache_collectives"] == "counted"
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    cell = dryrun.build_cell(arch, shape, mesh)
    cfg = registry.get_config(arch)
    lay = SC.layout(SC.place_slot_state(cell["cache"], cfg, mesh)["blocks"][0]["k"])
    params, _ = roofline.meta_instance(cfg)
    unsharded = roofline.collective_bytes(SH.shard_params(params, cfg, mesh), cfg,
                                          cell["spec"].global_batch)
    got = res["roofline"]["coll_detail"]
    H, hd, L = cfg.n_heads, cfg.resolved_head_dim, cfg.n_layers
    act = torch.empty((), dtype=cfg.dtype).element_size()
    if shape == "long_500k":
        assert lay == SC.KVLayout(16, -1, 16, -3)
        Ts = sum(min(cfg.window_size, 524288) if k == "L" else 524288 for k in cfg.pattern())
        assert got == {
            "all-reduce": unsharded["all-reduce"] + H * Ts * 4 + L * H * (hd + 1) * 4,
            "all-gather": unsharded["all-gather"] + L * (16 * H * 4 + H * hd * act)}
    else:
        assert lay == SC.KVLayout(32, -1, 16, -4)
        B, T = 128, 32768
        Ts = sum(min(cfg.window_size, T) if k == "L" else T for k in cfg.pattern())
        assert got == {"all-reduce": unsharded["all-reduce"] + B * H * Ts * 4,
                       "all-gather": unsharded["all-gather"] + 2 * B * H * hd * act * L}


def _ref_cache_bytes(arch, shape, mesh_kind, monkeypatch):
    """Bytes one position holds of the reference's compact cache spec
    under its ``cache_shardings`` rule, on a duck-typed production mesh
    (the rule reads only the axis names and shape; its ``NamedSharding``
    is replaced by the bare spec)."""
    from jax.sharding import PartitionSpec
    shp, axes = MESH[mesh_kind]
    mesh = SimpleNamespace(axis_names=axes, devices=np.empty(shp, dtype=object))
    rcfg = rregistry.get_config(arch)
    spec = rregistry.SHAPES[shape]
    sds = rT.cache_spec(rcfg, spec.global_batch, spec.seq_len, compact_local=True)
    monkeypatch.setattr(RSH, "NamedSharding", lambda m, p: p)
    specs = jax.tree_util.tree_leaves(RSH.cache_shardings(rcfg, sds, mesh),
                                      is_leaf=lambda x: isinstance(x, PartitionSpec))
    total = 0.0
    for leaf, ps in zip(jax.tree_util.tree_leaves(sds), specs):
        n = float(np.prod(leaf.shape)) * leaf.dtype.itemsize
        for ax in ps:
            if ax is not None:
                n /= RSH.axis_size(mesh, ax)
        total += n
    return total


@pytest.mark.parametrize("arch,shape", [("gemma2-2b", "decode_32k"),
                                        ("gemma3-1b", "long_500k")])
@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_decode_cell_cache_bytes_equal_the_reference_compact_spec(arch, shape, mesh_kind,
                                                                  monkeypatch):
    res = dryrun.run_cell(arch, shape, mesh_kind)
    assert res["status"] == "ok"
    assert res["memory"]["cache"] == pytest.approx(
        _ref_cache_bytes(arch, shape, mesh_kind, monkeypatch), rel=1e-12)


@pytest.mark.parametrize("shape,kind", [("train_4k", "train"), ("prefill_32k", "prefill"),
                                        ("long_500k", "decode")])
def test_build_cell_gives_each_kind_its_pieces(shape, kind):
    from repro_torch.launch.mesh import make_production_mesh
    cell = dryrun.build_cell("gemma3-1b", shape, make_production_mesh())
    assert cell["spec"].kind == kind and callable(cell["step"])
    assert ("opt_state" in cell) == (kind == "train")
    assert ("cache" in cell) == (kind == "decode")
    if kind == "decode":
        Ts = {c["k"].shape[-3] for c in cell["cache"]["blocks"]}
        assert Ts == {512, 524288} and cell["cache"]["blocks"][0]["k"].device.type == "meta"


def test_all_cells_equal_the_reference():
    from repro_torch.configs import registry
    assert sorted(registry.all_cells()) == sorted(rregistry.all_cells())
    assert len(registry.all_cells()) == len(registry.ARCH_IDS) * len(dryrun.SHAPES) == 40


def test_all_cells_finish_on_meta_tensors(tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    assert dryrun.main(["--all", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert len(res) == 2 * len(rregistry.ARCH_IDS) * len(dryrun.SHAPES)
    assert {r["status"] for r in res.values()} == {"ok", "skipped"}
    skipped = {k for k, r in res.items() if r["status"] == "skipped"}
    assert all(k.split(":")[1] == "long_500k" for k in skipped)
    assert "done: 66 ok, 14 skipped, 0 failed / 80" in capsys.readouterr().out
    decode = [r for r in res.values() if r["status"] == "ok" and "cache_collectives" in r]
    assert len(decode) == 26 and all(r["cache_collectives"].startswith("counted")
                                     for r in decode)
