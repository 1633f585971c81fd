"""The train step's split of the positions over "data" for the vlm and
encdec families (``distributed/data_parallel.py``).

A batch whose rows do not divide the dp axes (3 rows of 32 text
positions) and whose text positions divide "data" runs every row's block
of text positions on its "data" position.  A row's other inputs go
whole to every piece: reduced paligemma-3b's piece runs its rows' 8
image positions ahead of its block (their K/V its own, ahead of the
gathered text K/V); reduced whisper-base's runs the encoder over its
rows' 20 frames and its decoder's causal self-attention over the
gathered K/V, its learned positions and mask offset by its first
position.  In f32 on the CPU at (2, 2) and (2, 2, 1), FSDP off and on:

- the step equals the port's unsplit step (the tree placed without FSDP,
  its batch run whole under the mesh step): loss and every gradient
  within 1e-6;
- the collectives one executed step records equal
  ``roofline.train_collectives`` byte for byte and call for call;
- the step equals the reference's jitted ``make_train_step`` on the same
  numpy params and batch under ``test_sharded_step_equals_reference``'s
  tolerances (split by the model axis at (2, 2), by FSDP at (2, 2, 1)).

The rwkv and hybrid families still run such a batch whole.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import test_torch_sharded_training as TST  # noqa: E402
import test_torch_split_fallbacks as TSF  # noqa: E402

from repro.training import optimizer as ROPT  # noqa: E402
from repro.training import train_loop as RTL  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.compressed import ShardedTensor  # noqa: E402
from repro_torch.distributed import data_parallel as DP  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves  # noqa: E402

NAMES = ("paligemma-3b", "whisper-base")
ROWS, SEQ, FRAMES = 3, 32, 20


def _batch(cfg, seed=5):
    """(port batch, reference batch): 3 rows of 32 text tokens, a vlm's
    image embeddings or an encdec's frames drawn from the same seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (ROWS, SEQ + 1)).astype(np.int32)
    arrays = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        arrays["img_embs"] = rng.standard_normal((ROWS, cfg.n_img_tokens, cfg.d_model),
                                                 dtype=np.float32)
    else:
        arrays["enc_inputs"] = rng.standard_normal((ROWS, FRAMES, cfg.d_model),
                                                   dtype=np.float32)
    return ({k: torch.from_numpy(v) for k, v in arrays.items()},
            {k: jnp.asarray(v) for k, v in arrays.items()})


def _step_shape(cfg):
    return roofline.TrainStep(ROWS, SEQ, enc_len=FRAMES if cfg.family == "encdec" else 0)


def _cases():
    """(name, shape, fsdp) whose placed tree has a split leaf: at (2, 2, 1)
    the model axis has one position, so only FSDP splits a leaf."""
    return [(name, shape, fsdp) for name in NAMES for shape in TSF.SHAPES
            for fsdp in (False, True) if fsdp or shape == (2, 2)]


@pytest.mark.parametrize("name,shape,fsdp", _cases(),
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_split_step_equals_the_unsplit_step_and_its_count(name, shape, fsdp, tiny_dense,
                                                          monkeypatch):
    cfg, params = TSF._cfg(name, tiny_dense)
    batch, _ = _batch(cfg)
    with monkeypatch.context() as m:
        m.setattr(train_loop, "plan_split", lambda *a, **k: DP.Split())
        want_loss, want_g, _, _, _ = TSF._step(cfg, TSF._placed(cfg, params, shape, False),
                                               batch, 1)
    placed = TSF._placed(cfg, params, shape, fsdp)
    count = roofline.train_collectives(placed, cfg, _step_shape(cfg))
    assert count["split_by"] == "positions"
    loss, grads, (got_b, got_c), _, _ = TSF._step(cfg, placed, batch, 1)
    assert got_b == {k: v for k, v in count["bytes"].items() if v}
    assert got_c == {k: v for k, v in count["calls"].items() if v}
    assert abs(loss - want_loss) <= TSF.GRAD_TOL
    assert len(grads) == len(want_g)
    assert max((a - b).abs().max().item() for a, b in zip(grads, want_g)) <= TSF.GRAD_TOL
    assert count["breakdown"]["backward"]["reduce-scatter"] > 0


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("name", NAMES)
def test_split_step_equals_reference(name, fsdp, tiny_dense):
    rcfg, rparams, cfg, params = TST._family(name, tiny_dense)
    batch, jb = _batch(cfg)
    ro = TST._opt(ROPT, "adamw")
    rp, rs, rm = jax.jit(RTL.make_train_step(rcfg, ro))(rparams, ro.init(rparams), jb, TST.STEP)
    want = bridge.from_reference(jax.device_get((rp, rs)), device="cpu")
    placed = TSF._placed(cfg, params, (2, 2, 1) if fsdp else (2, 2), fsdp)
    assert roofline.train_collectives(placed, cfg, _step_shape(cfg))["split_by"] == "positions"
    _, _, _, (p2, s2), m = TSF._step(cfg, placed, batch, 1)
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=TST.LOSS_RTOL)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=TST.LOSS_RTOL)
    ref_m = dict(flatten_with_path(want[1]["m"]))
    undetermined = total = 0
    for (path, a), b in zip(flatten_with_path([p2, s2]), leaves(want)):
        a = SH.gather(a) if isinstance(a, ShardedTensor) else a
        assert a.shape == b.shape, path
        err = (a - b).abs()
        if path[0] == 0:
            noise = ref_m[path[1:]].abs() < (1 - 0.9) * TST.GRAD_FLOOR     # m = 0.1 g
            assert err[~noise].max().item() <= TST.PARAM_ATOL, path
            if noise.any():
                assert err[noise].max().item() <= 2 * TST.LR_T, path
            undetermined += int((noise & (err > TST.PARAM_ATOL)).sum())
            total += a.numel()
        else:
            assert err.max().item() <= TST.PARAM_ATOL, path
    assert undetermined <= total / 1000



def test_a_vlm_split_without_its_image_is_refused(tiny_dense):
    """A vlm's piece holds its rows' image ahead of its block of text
    positions; a batch without ``img_embs`` is refused, not misplaced."""
    cfg, params = TSF._cfg("paligemma-3b", tiny_dense)
    batch, _ = _batch(cfg)
    del batch["img_embs"]
    with pytest.raises(ValueError, match="img_embs"):
        TSF._step(cfg, TSF._placed(cfg, params, (2, 2), False), batch, 1)
