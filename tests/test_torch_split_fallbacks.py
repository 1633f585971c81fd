"""The train step's two split fallbacks on a placed tree
(``distributed/data_parallel.py`` ``Split``, ``plan_split``).

- **Positions over "data".**  A batch whose rows do not divide the dp
  axes (3 rows of 32 positions) and whose positions divide "data"
  (``batch_shardings``' fallback): each "data" position runs every row's
  block of positions, its attention over the others' K/V gathered
  through counted collectives, RoPE, the causal mask and the window
  offset by its first position, its loss on its labels weighted by its
  share; a "pod" position runs its block again.  Dense (reduced
  gemma2-2b, its local and global layers and softcaps; and with a
  16-position window under 32 positions, so the window cuts the gathered
  K/V) and MoE (reduced qwen2-moe-a2.7b, the exchange of gates and
  choices over the blocks in the microbatch's token order, each row's
  blocks interleaved; and with a capacity factor of 0.5, so that the
  order decides which entries drop).
- **Microbatches whose rows do not split over the dp positions.**  As XLA
  places the reference's ``[M, B/M]`` reshape: each microbatch in
  ``n / gcd(n, M)`` blocks, the other positions running it again.

For both, in f32 on the CPU at (2, 2) and (2, 2, 1), FSDP off and on:

- the step equals the port's unsplit step (the tree placed without
  FSDP, its batch run whole under the mesh step: the model axis' pieces
  round as the split step's, whose FSDP gathers restore the same
  pieces): loss and every gradient within 1e-6 (measured at most 6.7e-7
  on gradients up to 2.2; against the params unplaced the model axis'
  pieces alone part by up to 3.7e-6, which the reference test below
  holds to its tolerances);
- the collectives one executed step records equal
  ``roofline.train_collectives`` byte for byte and call for call;
- the step equals the reference's jitted ``make_train_step`` on the same
  numpy params and batch under ``test_sharded_step_equals_reference``'s
  tolerances (loss and grad norm within 1e-5 relative; params within
  2e-6 but where AdamW's first step has no direction, |g| < 1e-6).

``train_collectives`` counts ``whisper-base:train_4k:multi`` at the
reference's 16 runtime microbatches (16 rows a microbatch over 32 dp
positions: 2 blocks of 8 rows, 16 replicas each) on meta tensors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import test_torch_sharded_training as TST  # noqa: E402
from test_torch_tp import _mesh  # noqa: E402

from repro.training import optimizer as ROPT  # noqa: E402
from repro.training import train_loop as RTL  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.compressed import ShardedTensor  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed import data_parallel as DP  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.training import optimizer as OPT  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402
from repro_torch.training.train_loop import make_train_step  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves, tree_map  # noqa: E402

GRAD_TOL = 1e-6
SHAPES = ((2, 2), (2, 2, 1))
NAMES = ("gemma2-2b", "qwen2-moe-a2.7b")
# (rows, positions, microbatches) of each case at each shape
CASES = {"positions": {(2, 2): (3, 32, 1), (2, 2, 1): (3, 32, 1)},
         "microbatches": {(2, 2): (2, 32, 2), (2, 2, 1): (4, 32, 2)}}


def _batch(cfg, rows, seq, seed=5):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (rows, seq + 1))
    toks = toks.astype(np.int32)
    return ({"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])},
            {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])})


def _counts():
    return ({k: v for k, v in C.result_bytes.items() if v},
            {k: v for k, v in C.calls.items() if v})


def _step(cfg, tree, batch, mb):
    """One AdamW step: (loss, gradients gathered whole, counts after the
    gradients' reduction, updated tree, metrics)."""
    got = []

    def hook(g, r):
        got.append((g, _counts()))
        return g, r
    o = TST._opt(OPT, "adamw")
    step = make_train_step(cfg, o, microbatches=mb, grad_compressor=hook)
    C.reset_result_bytes()
    p2, s2, _, m = step(tree, o.init(tree), batch, TST.STEP)
    grads, counts = got[0]
    whole = [SH.gather(g) if isinstance(g, ShardedTensor) else g for g in leaves(grads)]
    return float(m["loss"]), whole, counts, (p2, s2), m


def _placed(cfg, params, shape, fsdp):
    mesh = _mesh(shape)
    return SH.place(tree_map(torch.clone, params), SH.param_shardings(cfg, params, mesh,
                                                                      fsdp=fsdp))


VARIANTS = {"gemma2-2b-window16": ("gemma2-2b", dict(window_size=16)),
            "qwen2-moe-a2.7b-drops": ("qwen2-moe-a2.7b", dict(capacity_factor=0.5))}


def _cfg(name, tiny_dense):
    """A family's reduced config and params; a variant's config changed as
    VARIANTS says (a window under the positions, a capacity that drops
    entries)."""
    name, kw = VARIANTS.get(name, (name, {}))
    _, _, cfg, params = TST._family(name, tiny_dense)
    return cfg.replace(**kw), params


def _split_cases():
    """Every (name, case, shape, fsdp) whose placed tree has a split leaf
    (a tree without one carries no mesh and trains whole): at (2, 2, 1)
    the model axis has one position, so reduced gemma2-2b is split only
    by FSDP; qwen2-moe's experts go over "data" either way."""
    return [(name, case, shape, fsdp) for name in NAMES + tuple(VARIANTS)
            for case in sorted(CASES) for shape in SHAPES for fsdp in (False, True)
            if fsdp or shape == (2, 2) or name.startswith("qwen")]


@pytest.mark.parametrize("name,case,shape,fsdp", _split_cases(),
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_split_step_equals_the_unsplit_step_and_its_count(name, case, shape, fsdp, tiny_dense,
                                                          monkeypatch):
    cfg, params = _cfg(name, tiny_dense)
    rows, seq, mb = CASES[case][shape]
    batch, _ = _batch(cfg, rows, seq)
    with monkeypatch.context() as m:           # the batch whole, the weights cut as the
        m.setattr(train_loop, "plan_split", lambda *a, **k: DP.Split())    # split step's
        want_loss, want_g, _, _, _ = _step(cfg, _placed(cfg, params, shape, False), batch, mb)
    placed = _placed(cfg, params, shape, fsdp)
    step = roofline.TrainStep(rows, seq, mb)
    count = roofline.train_collectives(placed, cfg, step)
    assert count["split_by"] == ("positions" if case == "positions" else "rows")
    loss, grads, (got_b, got_c), _, _ = _step(cfg, placed, batch, mb)
    assert got_b == {k: v for k, v in count["bytes"].items() if v}
    assert got_c == {k: v for k, v in count["calls"].items() if v}
    assert abs(loss - want_loss) <= GRAD_TOL
    assert len(grads) == len(want_g)
    assert max((a - b).abs().max().item() for a, b in zip(grads, want_g)) <= GRAD_TOL
    if case == "positions":        # each K/V gather is reduce-scattered in the backward
        assert count["breakdown"]["backward"]["reduce-scatter"] > 0


def _reference_step(name, tiny_dense, rows, seq, mb):
    rcfg, rparams, cfg, _ = TST._family(name, tiny_dense)
    ro = TST._opt(ROPT, "adamw")
    _, jb = _batch(cfg, rows, seq)
    rp, rs, rm = jax.jit(RTL.make_train_step(rcfg, ro, microbatches=mb))(
        rparams, ro.init(rparams), jb, TST.STEP)
    return ({k: float(v) for k, v in rm.items()},
            bridge.from_reference(jax.device_get((rp, rs)), device="cpu"))


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", NAMES)
def test_split_step_equals_reference(name, case, fsdp, tiny_dense):
    shape = (2, 2, 1)
    cfg, params = _cfg(name, tiny_dense)
    rows, seq, mb = CASES[case][shape]
    want_m, want = _reference_step(name, tiny_dense, rows, seq, mb)
    batch, _ = _batch(cfg, rows, seq)
    _, _, _, (p2, s2), m = _step(cfg, _placed(cfg, params, shape, fsdp), batch, mb)
    assert float(m["loss"]) == pytest.approx(want_m["loss"], rel=TST.LOSS_RTOL)
    assert float(m["grad_norm"]) == pytest.approx(want_m["grad_norm"], rel=TST.LOSS_RTOL)
    got = flatten_with_path([p2, s2])
    ref_m = dict(flatten_with_path(want[1]["m"]))
    undetermined = total = 0
    for (path, a), b in zip(got, leaves(want)):
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


def test_the_split_plan():
    mesh = _mesh((2, 2, 1))                      # 4 dp positions
    assert DP.plan_split(mesh, 8, 32, 2) == DP.Split("rows", 4, 4)
    assert DP.plan_split(mesh, 4, 32, 2) == DP.Split("rows", 4, 2)      # 2 rows over 4
    assert DP.plan_split(mesh, 4, 32, 4) == DP.Split("rows", 4, 1)      # 1 row over 4
    assert DP.plan_split(mesh, 1, 32, 1) == DP.Split("positions", 4, 2)
    for family in ("vlm", "encdec"):
        assert DP.plan_split(mesh, 1, 32, 1, family) == DP.Split("positions", 4, 2)
    assert DP.plan_split(mesh, 1, 32, 1, "rwkv") == DP.Split()          # runs it whole
    assert DP.plan_split(mesh, 1, 32, 1, "hybrid") == DP.Split()
    assert DP.plan_split(mesh, 3, 33, 1) == DP.Split()                   # 33 positions: whole
    with pytest.raises(ValueError, match="does not divide into 3 microbatches"):
        DP.plan_split(mesh, 4, 32, 3)


def test_whisper_multi_pod_train_cell_counts_its_runtime_microbatches():
    """The reference's runtime build of ``whisper-base:train_4k:multi`` runs
    16 microbatches of 16 rows over 32 dp positions."""
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    cfg = registry.get_config("whisper-base")
    mesh = make_production_mesh(multi_pod=True)
    params, _ = roofline.meta_instance(cfg)
    placed = SH.place(params, SH.param_shardings(cfg, params, mesh))
    step = dryrun.train_step_shape(cfg, dryrun.input_specs(cfg, "train_4k"))
    step.microbatches = 16
    one = roofline.train_collectives(placed, cfg, roofline.TrainStep(256, 4096, 1,
                                                                     enc_len=step.enc_len))
    got = roofline.train_collectives(placed, cfg, step)
    assert got["split"] == 32 and got["split_by"] == "rows"
    assert DP.plan_split(mesh, 256, 4096, 16, cfg.family).blocks == 2
    # each position runs 8 rows of each of the 16 microbatches, as it runs 8
    # rows of the batch split whole: 16 times its forward, less the loss's
    fwd, fwd1 = got["breakdown"]["forward"]["all-reduce"], one["breakdown"]["forward"]["all-reduce"]
    assert fwd - 16 * 4 == pytest.approx(16 * (fwd1 - 4), rel=1e-12)
    # the gradients, reduced once a step, in f32 over several microbatches
    assert got["breakdown"]["gradients"]["all-reduce"] == pytest.approx(
        2 * one["breakdown"]["gradients"]["all-reduce"], rel=1e-12)
