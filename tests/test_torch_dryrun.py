"""The dry run (``launch/dryrun.py``) and the roofline's collective term.

- ``--cell`` for gemma2-2b, qwen2-moe-a2.7b and granite-20b on both
  production meshes (decode and train shapes, FSDP on the large models'
  train cells) reports per-position param bytes equal to the sum over the
  reference's specs of the reference's shapes.
- The collective bytes of ``tiny_dense``'s sharded decode step at (1, 4)
  equal a count by hand, and the bytes the collectives record when the
  step runs.
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
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
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
    cache = api.init_cache(cfg, S, 64, device="cpu")
    collectives.reset_result_bytes()
    with torch.no_grad():
        api.decode_step(placed, cfg, cache, torch.ones((S, 1), dtype=torch.long),
                        torch.full((S,), 3), max_len=64)
    assert {k: v for k, v in collectives.result_bytes.items() if v} == cost.coll_detail


def test_all_cells_finish_on_meta_tensors(tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    assert dryrun.main(["--all", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert len(res) == 2 * len(rregistry.ARCH_IDS) * len(dryrun.SHAPES)
    assert {r["status"] for r in res.values()} == {"ok", "skipped"}
    skipped = {k for k, r in res.items() if r["status"] == "skipped"}
    assert all(k.split(":")[1] == "long_500k" for k in skipped)
    assert "done: 66 ok, 14 skipped, 0 failed / 80" in capsys.readouterr().out
