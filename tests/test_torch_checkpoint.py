"""The port's checkpoint format (``repro_torch.training.checkpoint``)
against the reference's ``repro.training.checkpoint``.

- The reference's own contracts on the port (tests/test_serving_olap.py
  ``TestTraining``): a round trip with compressed leaves gives the same
  forward, a corrupted ``arrays.npz`` raises, GC keeps the newest.
- Across packages, both ways: the reference's ``save`` of ``(params,
  adamw state)``, of a ``w8`` instance, of a layer-stacked ``bs16``
  instance and of the reduced qwen2-moe's ``w8`` and SmoothQuant
  instances (expert-stacked ``QTensor`` leaves [R, E, K, N], the second
  with ``in_scale``) is read by the port's ``restore`` and
  ``restore_tree`` bit for bit (the stacked block-sparse leaf without
  ``idx``, rebuilt from ``mask``); the port's ``save`` of the same trees is read back by the
  reference's, and both write manifests with the same ``a{i}`` paths and
  kinds; forwards agree (f32, within 1e-5 relative of the reference's).
- Training that stops at a checkpoint and resumes ends where an
  uninterrupted run does, bit for bit.
- A ``qembed`` entry crosses the packages both ways.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rregistry  # noqa: E402
from repro.configs.base import ModelConfig as RConfig  # noqa: E402
from repro.core.compressed import quantize_embed  # noqa: E402
from repro.core.pipeline import InstanceOptimizer as RInstanceOptimizer  # noqa: E402
from repro.core.pipeline import Recipe as RRecipe  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.training import checkpoint as RCK  # noqa: E402
from repro.training import optimizer as ROPT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.core.compressed import BlockSparseTensor, QEmbed, QTensor  # noqa: E402
from repro_torch.core.pipeline import InstanceOptimizer, Recipe  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.training import checkpoint as CK  # noqa: E402
from repro_torch.training import optimizer as OPT  # noqa: E402
from repro_torch.training import train_loop as TL  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

FWD_RTOL = 1e-5
CONTAINERS = (QTensor, BlockSparseTensor)


def _cfg(dtype="float32"):
    return RConfig(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, d_ff=128, vocab_size=260, max_seq=256,
                   param_dtype=dtype)


@pytest.fixture(scope="module")
def ref_trees():
    """Reference trees to save: bf16 params with AdamW state, and f32 w8
    and stacked bs16 instances."""
    rcfg = _cfg()
    rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
    bf = _cfg("bfloat16")
    bparams = rapi.init_params(jax.random.PRNGKey(1), bf)
    toks = jax.random.randint(jax.random.PRNGKey(2), (4, 32), 4, 260)
    opt = RInstanceOptimizer(rparams, rcfg)
    opt.run_calibration({"tokens": toks})
    w8, _, _ = opt.apply(RRecipe(name="w8", wbits=8, quant_method="absmax"))
    bs16, _, _ = opt.apply(RRecipe(name="bs16", block_bs=16, block_density=0.75))
    # the reduced qwen2-moe: expert-stacked QTensors [R, E, K, N], with
    # SmoothQuant's in_scale [R, E, K] in the second
    mcfg = rregistry.get_reduced("qwen2-moe-a2.7b").replace(param_dtype="float32")
    mopt = RInstanceOptimizer(rapi.init_params(jax.random.PRNGKey(3), mcfg), mcfg)
    mopt.run_calibration({"tokens": jax.random.randint(jax.random.PRNGKey(4), (4, 32), 4,
                                                       mcfg.vocab_size)})
    moe_w8, _, _ = mopt.apply(RRecipe(name="w8", wbits=8, quant_method="absmax"))
    moe_sq, _, _ = mopt.apply(RRecipe(name="sq", wbits=8, quant_method="absmax",
                                      smooth_alpha=0.5))
    return {"cfg": rcfg, "params": rparams, "moe_cfg": mcfg,
            "train": (bparams, ROPT.adamw().init(bparams)), "w8": w8, "bs16": bs16,
            "moe_w8": moe_w8, "moe_sq": moe_sq}


def _bits(a) -> np.ndarray:
    """Any array or tensor as its raw bytes (bf16 included)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy().view(np.uint8).ravel()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).ravel()


def _arrays_of(leaf):
    """The arrays a checkpoint stores for one leaf, by suffix."""
    if hasattr(leaf, "q") and hasattr(leaf, "bits"):
        out = {"q": leaf.q, "scale": leaf.scale}
        if leaf.in_scale is not None:
            out["in_scale"] = leaf.in_scale
        return out
    if hasattr(leaf, "mask"):
        return {"w": leaf.w, "mask": leaf.mask}
    return {"": leaf}


def _ref_leaves(tree):
    from repro.core.compressed import BlockSparseTensor as RB, QTensor as RQ
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, (RQ, RB)))


def _port_leaves(tree):
    return [leaf for _, leaf in flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, CONTAINERS))]


def _assert_same_bits(port_tree, ref_tree):
    pl, rl = _port_leaves(port_tree), _ref_leaves(ref_tree)
    assert len(pl) == len(rl)
    for p, r in zip(pl, rl):
        pa, ra = _arrays_of(p), _arrays_of(r)
        assert set(pa) == set(ra)
        for k in pa:
            assert tuple(pa[k].shape) == tuple(np.shape(ra[k]))
            np.testing.assert_array_equal(_bits(pa[k]), _bits(ra[k]))


def _manifest(d):
    step = CK.latest_step(d)
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the reference's contracts on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_w8(ref_trees):
    cfg = from_reference(ref_trees["cfg"])
    params = bridge.from_reference(jax.device_get(ref_trees["params"]), device="cpu")
    p2, c2, _ = InstanceOptimizer(params, cfg).apply(
        Recipe(name="w8", wbits=8, quant_method="absmax"))
    return p2, c2


def test_checkpoint_roundtrip_with_compressed_leaves(port_w8, tmp_path):
    p2, c2 = port_w8
    CK.save(str(tmp_path), 7, p2)
    restored, step, _ = CK.restore(str(tmp_path), p2, device="cpu")
    assert step == 7
    assert isinstance(restored["blocks"][0]["attn"]["wq"], QTensor)
    toks = {"tokens": torch.ones((1, 8), dtype=torch.int32)}
    l1, _ = api.forward(p2, c2, toks)
    l2, _ = api.forward(restored, c2, toks)
    assert torch.equal(l1, l2)
    tree, step, _ = CK.restore_tree(str(tmp_path), device="cpu")
    l3, _ = api.forward(tree, c2, toks)
    assert torch.equal(l1, l3) and tree["tail"] == []


def test_checkpoint_detects_corruption(tmp_path):
    d = str(tmp_path)
    CK.save(d, 1, {"w": torch.ones(4)})
    npz = os.path.join(d, "step_00000001", "arrays.npz")
    with open(npz, "r+b") as f:
        f.seek(60)
        f.write(b"\xde\xad")
    with pytest.raises(IOError):
        CK.restore(d, {"w": torch.ones(4)}, device="cpu")
    with pytest.raises(IOError):
        CK.restore_tree(d, device="cpu")


def test_checkpoint_gc_keeps_latest(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        CK.save(d, s, {"w": torch.ones(2)}, keep=2)
    assert CK.latest_step(d) == 5
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == \
        ["step_00000004", "step_00000005"]
    assert not any(x.startswith("tmp.") for x in os.listdir(d))


def test_restore_without_checkpoint_raises(tmp_path):
    assert CK.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        CK.restore(str(tmp_path), {"w": torch.ones(2)}, device="cpu")


def test_atomic_write_json(tmp_path):
    path = str(tmp_path / "sub" / "state.json")
    CK.atomic_write_json(path, {"a": [1, 2], "t": float("inf")})
    with open(path) as f:
        assert json.load(f) == {"a": [1, 2], "t": float("inf")}
    assert os.listdir(tmp_path / "sub") == ["state.json"]


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

TREES = ["train", "w8", "bs16", "moe_w8", "moe_sq"]


@pytest.mark.parametrize("which", TREES)
def test_reference_checkpoint_restores_in_port(ref_trees, which, tmp_path):
    tree = ref_trees[which]
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    RCK.save(ref_dir, 3, tree, extra={"note": which})
    target = bridge.from_reference(jax.device_get(tree), device="cpu")
    got, step, extra = CK.restore(ref_dir, target, device="cpu")
    assert step == 3 and extra == {"note": which}
    _assert_same_bits(got, tree)
    loose, _, _ = CK.restore_tree(ref_dir, device="cpu")
    if which == "train":
        loose = tuple(loose)
    _assert_same_bits(loose, tree)
    if which == "bs16":
        leaf = got["blocks"][0]["mlp"]["wi"]
        assert isinstance(leaf, BlockSparseTensor) and leaf.w.dim() == 3
        assert torch.equal(leaf.idx, target["blocks"][0]["mlp"]["wi"].idx)
    if which.startswith("moe"):
        leaf = got["blocks"][0]["moe"]["wo"]
        assert isinstance(leaf, QTensor) and leaf.q.dim() == 4 and leaf.shape == (96, 64)
        assert (leaf.in_scale is not None) == (which == "moe_sq")
    # the port writes the same manifest for the same tree
    CK.save(port_dir, 3, got, extra={"note": which})
    mr, mp = _manifest(ref_dir), _manifest(port_dir)
    assert mp["arrays"] == mr["arrays"]
    assert mp.get("bf16") == mr.get("bf16")
    assert mp.get("structure_only") == mr.get("structure_only")


@pytest.mark.parametrize("which", TREES)
def test_port_checkpoint_restores_in_reference(ref_trees, which, tmp_path):
    tree = ref_trees[which]
    port_tree = bridge.from_reference(jax.device_get(tree), device="cpu")
    if which == "train":
        port_tree = tuple(port_tree)
    d = str(tmp_path)
    CK.save(d, 9, port_tree)
    got, step, _ = RCK.restore(d, tree)
    assert step == 9
    _assert_same_bits(port_tree, got)
    loose, _, _ = RCK.restore_tree(d)
    _assert_same_bits(port_tree, tuple(loose) if which == "train" else loose)


@pytest.mark.parametrize("which", ["w8", "bs16", "moe_w8"])
def test_forwards_agree_across_packages(ref_trees, which, tmp_path):
    rcfg = ref_trees["moe_cfg" if which.startswith("moe") else "cfg"]
    d = str(tmp_path)
    RCK.save(d, 0, ref_trees[which])
    params, _, _ = CK.restore_tree(d, device="cpu")
    toks = np.array(jax.random.randint(jax.random.PRNGKey(5), (2, 16), 4, rcfg.vocab_size))
    got, _ = api.forward(params, from_reference(rcfg), {"tokens": torch.from_numpy(toks)})
    want, _ = rapi.forward(ref_trees[which], rcfg, {"tokens": jnp.asarray(toks)})
    want = torch.from_numpy(np.array(want, np.float32))
    rel = (got - want).abs().max().item() / want.abs().max().item()
    assert rel <= FWD_RTOL


def test_qembed_entry_crosses_both_ways(tmp_path):
    """A reference ``qembed`` entry restores as the port's ``QEmbed`` (codes
    and scales bit for bit, through ``restore_tree`` and ``restore``), and
    the port's entry restores in the reference."""
    d = str(tmp_path / "ref")
    rq = quantize_embed(jax.random.normal(jax.random.PRNGKey(0), (260, 64)))
    RCK.save(d, 0, {"embed": rq, "ln_f": {"w": jnp.ones((64,))}})
    tree, _, _ = CK.restore_tree(d, device="cpu")
    got, _, _ = CK.restore(d, {"embed": tree["embed"], "ln_f": {"w": torch.zeros(1)}},
                           device="cpu")
    for t in (tree["embed"], got["embed"]):
        assert isinstance(t, QEmbed)
        assert torch.equal(t.q, torch.from_numpy(np.array(rq.q)))
        assert torch.equal(t.scale, torch.from_numpy(np.array(rq.scale)))
    d2 = str(tmp_path / "port")
    CK.save(d2, 0, tree)
    back, _, _ = RCK.restore_tree(d2)
    assert type(back["embed"]).__name__ == "QEmbed"
    assert np.array_equal(np.asarray(back["embed"].q), np.asarray(rq.q))
    assert np.array_equal(np.asarray(back["embed"].scale), np.asarray(rq.scale))


# ---------------------------------------------------------------------------
# restart
# ---------------------------------------------------------------------------

def test_resume_equals_uninterrupted(tmp_path):
    cfg = from_reference(_cfg("bfloat16"))
    opt = lambda: OPT.adamw(lr=3e-3, warmup=2, total_steps=6)
    tc = dict(batch=4, seq_len=32, log_every=1)
    quiet = lambda *_: None
    whole = TL.train(cfg, TL.TrainConfig(steps=6, **tc), opt(), log=quiet, device="cpu")
    d = str(tmp_path)
    TL.train(cfg, TL.TrainConfig(steps=3, ckpt_dir=d, ckpt_every=3, **tc), opt(),
             log=quiet, device="cpu")
    assert CK.latest_step(d) == 3
    logs = []
    resumed = TL.train(cfg, TL.TrainConfig(steps=6, ckpt_dir=d, ckpt_every=3, **tc),
                       opt(), log=logs.append, device="cpu")
    assert logs[0] == "[train] resumed from step 3"
    assert [s for s, _ in resumed["losses"]] == [3, 4, 5]
    assert resumed["losses"] == whole["losses"][3:]
    a = _port_leaves((whole["params"], whole["opt_state"]))
    b = _port_leaves((resumed["params"], resumed["opt_state"]))
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert CK.latest_step(d) == 6
