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
- ``--all`` finishes on meta tensors, and every train cell counts its
  whole data-parallel step (``train_collectives: counted``, with the
  backward and the gradients' reductions in its breakdown).
- ``roofline.train_collectives`` of tiny_dense at train_4k's shape on a
  (2, 2) mesh equals a count by hand, by kind and by forward, backward
  and gradients; an FSDP cell (mistral-nemo-12b) counts each FSDP-split
  leaf's per-use gathers and its gradients' reduce-scatter.
- What one device's program holds (``per_device``, which sets every
  cell's ``t_collective`` and ``bound``) and the port's own gathers
  (``port_only``) of tiny_dense's train step, decode step and a prefill
  equal a count by hand; every cell reports the controller's sum beside
  them, and the train cells carry the reference's ``xent_chunk``
  (``tests/test_torch_dryrun_per_device.py`` holds the figure to the
  reference's compiled HLO).
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
    # per device: the sums (XLA keeps the column outputs split over "model"
    # and reads the logits' vocab pieces in place), over a device's share
    # of the rows
    rep = roofline.collective_report(placed, cfg, S)
    assert rep["bytes"] == cost.coll_detail
    assert rep["per_device"] == {"all-reduce": reduce}
    assert rep["port_only"] == {"column_outputs": {"all-gather": layers * S * 320 * f32},
                                "logits": {"all-gather": S * 260 * f32}}
    half = roofline.collective_report(placed, cfg, S, share=0.5)
    assert half["bytes"] == rep["bytes"] and half["per_device"] == {"all-reduce": reduce / 2}
    # a prefill of 2 rows of 32 positions under the activations' sequence
    # split: the sums on its 64 rows, and each row-split section's input
    # and the logits' gathered [64, 64]
    P = 2 * 32
    pre = roofline.collective_report(placed, cfg, P, sp=True)
    assert pre["per_device"] == {
        "all-reduce": layers * P * (64 + 64) * f32 + P * 64 * f32,
        "all-gather": layers * 2 * P * 64 * f32 + P * 64 * f32}


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
    got = res["collective_controller"]
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
    assert cfg.n_heads % 16 and res["collective_controller"] == {
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
    got = res["collective_controller"]
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
    train = [r for r in res.values() if r["shape"] == "train_4k"]
    assert len(train) == 2 * len(rregistry.ARCH_IDS) == 20
    assert all(r["train_collectives"] == "counted" and r["collective_breakdown"]["gradients"]
               and r["collective_breakdown"]["backward"] for r in train)
    assert all(sum(r["roofline"]["coll_detail"].values()) == r["roofline"]["coll_bytes"]
               for r in train)
    # every counted cell's collective term is per device, the controller's
    # sum and the port's own gathers beside it
    ok = [r for r in res.values() if r["status"] == "ok"]
    assert all(r["roofline"]["coll_bytes"] == sum(r["roofline"]["coll_detail"].values())
               <= r["coll_bytes_controller"] == sum(r["collective_controller"].values())
               and isinstance(r["port_only"], dict) for r in ok)
    # the train cells build the reference's step: its streamed cross-entropy
    # for the dense, MoE and vlm families' 32000-plus vocabularies
    chunk = {k: r["xent_chunk"] for k, r in res.items() if r["shape"] == "train_4k"}
    assert chunk["gemma2-2b:train_4k:single"] == chunk["qwen2-moe-a2.7b:train_4k:multi"] == 1024
    assert chunk["paligemma-3b:train_4k:single"] == 960      # of 4096 - 256 image positions
    assert chunk["rwkv6-3b:train_4k:single"] == chunk["whisper-base:train_4k:multi"] == 0


def _meta_placed(cfg, shape, fsdp):
    mesh = make_mesh(shape, ("data", "model"), device="meta")
    params, _ = roofline.meta_instance(cfg)
    return params, SH.place(params, SH.param_shardings(cfg, params, mesh, fsdp=fsdp))


def test_tiny_dense_train_step_collectives_by_hand(tiny_dense):
    """tiny_dense (bf16) at train_4k's shape (256 rows of 4096) on a (2, 2)
    mesh, FSDP off: each "data" position runs 128 rows (R = 524288 tokens).
    Per layer and position: wq (64), wk and wv (32 each: 2 KV heads divide
    2), wi and wg (128) column splits gather their outputs; wo (64 -> 64)
    and the MLP's wo (128 -> 64) sum theirs.  The backward all-reduces the
    column splits' input gradients (5 x 64) and gathers the row splits'
    (64 and 128), and recomputes the checkpointed blocks' forward; the
    vocab-split table's lookup sums its rows, the untied unembed (64 ->
    260, column) gathers its outputs and all-reduces its input gradient;
    the loss is a 4-byte all-reduce; the gradients, one all-reduce per
    tensor piece, add up to every param's bytes."""
    cfg = from_reference(tiny_dense[0])
    _, placed = _meta_placed(cfg, (2, 2), False)
    step = roofline.TrainStep(256, 4096)
    got = roofline.train_collectives(placed, cfg, step)
    R, a, L, n = 128 * 4096, 2, 2, 2
    fwd_g, fwd_r = L * R * (64 + 32 + 32 + 128 + 128) * a, L * R * (64 + 64) * a
    forward = {"all-gather": n * (fwd_g + R * 260 * a),
               "all-reduce": n * (fwd_r + R * 64 * a) + 4}
    backward = {"all-gather": n * (L * R * (64 + 128) * a + fwd_g),
                "all-reduce": n * (L * R * 5 * 64 * a + R * 64 * a + fwd_r)}
    gradients = {"all-reduce": (cfg.param_count() + (2 * L + 1) * 64) * a}   # norms too
    assert got["breakdown"] == {"forward": forward, "backward": backward,
                                "gradients": gradients}
    assert got["calls_breakdown"] == {
        "forward": {"all-gather": n * (L * 5 + 1), "all-reduce": n * (L * 2 + 1) + 1},
        "backward": {"all-gather": n * L * (2 + 5), "all-reduce": n * (L * (5 + 2) + 1)},
        "gradients": {"all-reduce": 7 * 2 + 2 * 1 + 2 + 2 + 1}}
    assert got["split"] == 2
    assert roofline.collective_bytes(placed, cfg, 0, train=step) == got["bytes"]
    # per device: one position's calls; the gradients each model shard (the
    # matrices halved over "model", the norms whole); XLA emits none of the
    # column outputs' gathers, their recomputation, the row inputs'
    # gradient gathers or the logits'; under the activations' sequence
    # split it gathers instead each row-split section's input (again in the
    # recomputation) and its output's gradient, each column split's input
    # for its weight's gradient, and the logits' section likewise, and
    # permutes the embedding's output into that split and its gradient back
    # (each half of a position's rows); and with no norm after the MLP's wo,
    # XLA's recomputation leaves that linear out
    assert got["per_device"] == {
        "all-gather": 11 * L * R * 64 * a + 2 * R * 64 * a,
        "collective-permute": 2 * (R // 2) * 64 * a,
        "all-reduce": (L * R * 128 * a + R * 64 * a + 4 + L * R * 320 * a + L * R * 64 * a
                       + R * 64 * a + (cfg.param_count() // 2 + (2 * L + 1) * 64) * a)}
    assert got["port_only"] == {
        "column_outputs": {"all-gather": 2 * L * R * 384 * a},
        "row_input_gradients": {"all-gather": L * R * (64 + 128) * a},
        "logits": {"all-gather": R * 260 * a},
        "unread_recompute": {"all-reduce": L * R * 64 * a}}
    assert got["widen"] == {k: v for k, v in got["per_device"].items()} | {
        "all-reduce": got["per_device"]["all-reduce"] - 4}


def test_fsdp_train_cell_counts_its_gathers_and_reduce_scatters():
    """mistral-nemo-12b's train cell (FSDP: 12.2 B params) against the same
    step without FSDP: the forward gathers every FSDP-split leaf once per
    "data" position (the untied unembed once per cross-entropy chunk), the
    backward again for the checkpointed blocks and chunks, and the
    gradients reduce-scatter each of them whole."""
    from repro_torch.configs import registry
    r = dryrun.run_cell("mistral-nemo-12b", "train_4k", "single")
    assert r["fsdp"] and r["train_collectives"] == "counted" and r["dp_split"] == 16
    cfg = registry.get_config("mistral-nemo-12b")
    mesh = make_production_mesh()
    params, _ = roofline.meta_instance(cfg)
    flat = SH.place(params, SH.param_shardings(cfg, params, mesh))
    fsdp = SH.place(params, SH.param_shardings(cfg, params, mesh, fsdp=True))
    step = dryrun.train_step_shape(cfg, dryrun.input_specs(cfg, "train_4k"))
    base = roofline.train_collectives(flat, cfg, step)["breakdown"]
    got = r["collective_breakdown"]
    split = {}                       # bytes of the FSDP-split leaves, by subtree
    for p, leaf in _flat_leaves(fsdp):
        if _has_fsdp(leaf):
            split[p[0]] = split.get(p[0], 0) + sum(t.numel() * t.element_size()
                                                   for t in _tensors(leaf))
    assert split and sum(split.values()) > 0.9 * sum(
        t.numel() * t.element_size() for _, leaf in _flat_leaves(params) for t in _tensors(leaf))
    n = 16
    chunks = 4096 // step.xent_chunk            # the untied unembed gathered per chunk,
    assert chunks == 4                           # and again in its recomputation
    assert got["forward"]["all-gather"] - base["forward"]["all-gather"] == n * (
        split["blocks"] + split["embed"] + chunks * split["unembed"])
    assert got["backward"]["all-gather"] - base["backward"]["all-gather"] \
        == n * (split["blocks"] + chunks * split["unembed"])
    assert got["gradients"]["reduce-scatter"] == sum(split.values())
    assert "reduce-scatter" not in base["gradients"]


def _flat_leaves(tree):
    from repro_torch.tree import flatten_with_path
    return flatten_with_path(tree)


def _tensors(leaf):
    from repro_torch.core.compressed import ShardedTensor
    return leaf.tensors() if isinstance(leaf, ShardedTensor) else [leaf]


def _has_fsdp(leaf):
    from repro_torch.core.compressed import ShardedTensor
    while isinstance(leaf, ShardedTensor):
        if leaf.axis == "data" and leaf.dim in (-1, -2):
            return True
        leaf = leaf.pieces[0]
    return False
