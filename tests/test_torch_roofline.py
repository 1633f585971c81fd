"""The port's roofline model (``repro_torch.launch.roofline``).

``active_param_count`` and ``model_flops`` equal the reference's for
every config of both registries; ``decode_step_cost`` counts exactly the
bytes of a built instance and its slot state on reduced configs, and
reproduces ``PERF.md``'s decode-step byte floors at the published widths
from shapes alone.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(4)

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.compressed import param_bytes  # noqa: E402
from repro_torch.core.pipeline import InstanceOptimizer, Recipe  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.models import api  # noqa: E402

W8 = Recipe(name="w8-absmax", wbits=8, quant_method="absmax")
BS = Recipe(name="bs16@75", block_bs=16, block_density=0.75)
QEMBED = Recipe(name="w8-absmax-qembed", wbits=8, quant_method="absmax", quant_embed=True)

# PERF.md §4 (bf16) and §5 (int8) decode-step byte floors, ms at 3.35 TB/s:
# 8 slots at the first decode position (one K/V position written a slot),
# max_len 1024 (whisper-base 512)
FLOORS_MS = {"gemma2-2b": (1.561, 0.976), "qwen2-moe-a2.7b": (8.363, 4.314),
             "zamba2-7b": (4.079, 2.408), "rwkv6-3b": (1.838, 1.001),
             "paligemma-3b": (1.498, 0.925), "whisper-base": (0.0749, 0.0600),
             "granite-20b": (11.949, 6.161)}
BS_FLOOR_MS = 1.26                  # gemma2-2b bs16@75


def _ref_registry():
    from repro.configs import registry as ref
    return ref


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_active_params_and_model_flops_equal_the_reference(arch):
    from repro.configs.base import SHAPES
    from repro.launch import hlo_analysis as H
    ref = _ref_registry()
    for mine, theirs in ((registry.get_config(arch), ref.get_config(arch)),
                         (registry.get_reduced(arch), ref.get_reduced(arch))):
        assert mine.active_param_count() == theirs.active_param_count()
        assert mine.param_count() == theirs.param_count()
        for spec in SHAPES.values():
            port_spec = R.ShapeSpec(**dataclasses.asdict(spec))
            assert R.model_flops(mine, port_spec) == H.model_flops(theirs, spec)


@pytest.fixture(scope="module")
def reduced_gemma2():
    cfg = registry.get_reduced("gemma2-2b")
    base = api.init_params(torch.Generator().manual_seed(0), cfg)
    instances = {"base": (base, cfg)}
    for recipe in (W8, BS, QEMBED):
        out, out_cfg, _ = InstanceOptimizer(base, cfg).apply(recipe)
        instances[recipe.name] = (out, out_cfg)
    return instances


def _state_nbytes(state):
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(state))


@pytest.mark.parametrize("version", ["base", "w8-absmax", "bs16@75", "w8-absmax-qembed"])
def test_bytes_equal_instance_plus_slot_state(reduced_gemma2, version):
    """Every slot at the end of its context: the step reads every weight
    (gemma2's table is tied) and touches every cached position."""
    params, cfg = reduced_gemma2[version]
    slots, max_len = 4, 64                  # max_len within the local window
    state = api.init_cache(cfg, slots, max_len, compact_local=False, device="cpu")
    cost = R.decode_step_cost(params, cfg, slots, max_len, state)
    assert cost.bytes_accessed == param_bytes(params) + _state_nbytes(state)
    assert cost.detail["weight_bytes"] == param_bytes(params)
    assert cost.flops == 2 * cfg.active_param_count() * slots
    assert cost.coll_bytes == 0 and cost.t_collective == 0
    # the paged pools (with their trash block) give the same step
    nblk = max_len // 16
    paged = api.init_paged_cache(cfg, slots, slots * nblk + 1, 16, device="cpu")
    assert R.decode_step_cost(params, cfg, slots, max_len, paged).bytes_accessed \
        == cost.bytes_accessed
    # and the shapes alone
    if version != "bs16@75":
        recipe = {"base": None, "w8-absmax": W8, "w8-absmax-qembed": QEMBED}[version]
        shapes = R.decode_step_cost_shapes(registry.get_reduced("gemma2-2b"), slots, max_len,
                                           recipe=recipe)
        assert shapes.bytes_accessed == cost.bytes_accessed
    else:
        shapes = R.decode_step_cost_shapes(registry.get_reduced("gemma2-2b"), slots, max_len,
                                           recipe=BS)
        assert shapes.bytes_accessed == cost.bytes_accessed
        assert param_bytes(params) == cost.detail["weight_bytes"]


def test_positions_and_windows(reduced_gemma2):
    """K/V at the positions each slot touches, local layers within their
    window; one position a slot is only this step's write."""
    params, cfg = reduced_gemma2["base"]
    slots, max_len = 2, 128                 # window 64: LGLG
    per_pos = 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2       # k and v, bf16
    weights = param_bytes(params)
    first = R.decode_step_cost(params, cfg, slots, max_len, positions=1)
    assert first.detail["state_read"] == 0
    assert first.detail["state_written"] == slots * 4 * per_pos
    late = R.decode_step_cost(params, cfg, slots, max_len, positions=[100, 10])
    touched = 2 * (100 + 10) + 2 * (64 + 10)          # global layers, local layers
    assert late.bytes_accessed == weights + touched * per_pos
    assert late.detail["state_written"] == slots * 4 * per_pos


def test_compact_state_reads_its_own_slots(reduced_gemma2):
    """Over the compact cache (local layers at 64 circular slots) a step
    touches the same positions, each of the same bytes, as over the
    absolute one."""
    params, cfg = reduced_gemma2["base"]
    slots, max_len = 2, 128
    compact = api.init_cache(cfg, slots, max_len, device="meta")
    assert {c["k"].shape[-3] for c in compact["blocks"]} == {64, 128}
    for positions in (1, [100, 10], 128):
        got = R.decode_step_cost(params, cfg, slots, max_len, compact, positions=positions)
        want = R.decode_step_cost(params, cfg, slots, max_len, positions=positions)
        assert got.detail == want.detail and got.bytes_accessed == want.bytes_accessed


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b", "whisper-base"])
def test_recurrent_cross_and_untied_tables(arch):
    """A recurrent state is read and written whole, an encoder's K/V read
    whole; an untied input table is read at the slots' rows, an encoder
    not at all."""
    cfg = registry.get_reduced(arch)
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    slots, max_len = 3, 32
    state = api.init_cache(cfg, slots, max_len, compact_local=False, device="cpu")
    cost = R.decode_step_cost(params, cfg, slots, max_len, state, positions=1)
    skip = {"embed": params["embed"]}
    if arch == "whisper-base":
        skip.update({k: params[k] for k in ("enc_blocks", "ln_enc", "pos_enc", "pos_dec")})
    read_rows = slots * params["embed"][0].numel() * 2 * (2 if arch == "whisper-base" else 1)
    assert not cfg.tie_embeddings
    assert cost.detail["weight_bytes"] == param_bytes(params) - param_bytes(skip) + read_rows
    recurrent = cross = kv_pos = 0
    from repro_torch.tree import flatten_with_path
    for path, t in flatten_with_path(state):
        n = t.numel() * t.element_size()
        if path[-1] in ("k", "v") and "cross" not in path:
            kv_pos += n // (t.shape[-4] * t.shape[-3])
        elif "cross" in path or not t.is_floating_point():
            cross += n
        else:
            recurrent += n
    assert cost.detail["state_read"] == recurrent + cross
    assert cost.detail["state_written"] == recurrent + slots * kv_pos


@pytest.mark.parametrize("arch", sorted(FLOORS_MS))
def test_full_width_floors_from_shapes(arch):
    cfg = registry.get_config(arch)
    max_len = 512 if arch == "whisper-base" else 1024
    for recipe, want in zip((None, W8), FLOORS_MS[arch]):
        got = R.decode_step_cost_shapes(cfg, 8, max_len, recipe=recipe, positions=1)
        assert got.bound == "memory"
        assert got.t_bound * 1e3 == pytest.approx(want, rel=0.02), (arch, recipe)
    if arch == "gemma2-2b":
        got = R.decode_step_cost_shapes(cfg, 8, max_len, recipe=BS, positions=1)
        assert got.t_memory * 1e3 == pytest.approx(BS_FLOOR_MS, rel=0.02)


def test_bound_and_roofline_terms():
    ms, by = R.bound(3.35e9, 1e11)
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = R.bound(1.0, 989e9)
    assert ms == pytest.approx(1.0) and by == "operations"
    r = R.Roofline(flops=989e9, bytes_accessed=3.35e9 * 2, coll_bytes=0, chips=1)
    assert r.bound == "memory" and r.t_bound == pytest.approx(2e-3)
    assert r.to_dict()["t_compute"] == pytest.approx(1e-3)


@pytest.mark.parametrize("S,t_real,q_offset,window,causal",
                         [(7, 7, 0, 0, True), (5, 12, 7, 0, True), (9, 9, 0, 4, True),
                          (6, 20, 10, 3, True), (4, 6, 0, 0, False), (8, 5, 0, 0, True)])
def test_flash_keys_counts_the_mask(S, t_real, q_offset, window, causal):
    """K3's FLOP count: the key positions its mask keeps."""
    T = max(t_real, q_offset + S)
    q = np.arange(S)[:, None] + q_offset
    k = np.arange(T)[None, :]
    keep = np.broadcast_to(k < t_real, (S, T)).copy()
    if causal:
        keep &= k <= q
    if window:
        keep &= k > q - window
    assert ops.flash_keys(S, t_real, q_offset, window, causal) == keep.sum()
