"""Host-side plans of the port's kernel designs: which design of K1, K2,
K3 and K4 runs for a dtype and shape, K2's and K4's grid and split plans,
the column-group schedule of K4's ``mma`` design, and K1's split plan.  The
kernels themselves run only on the card, where ``chip_smoke.py`` holds
them to their plain versions."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro_torch.kernels import ops, ref  # noqa: E402

# gemma2-2b's linears (K, N) and the tiles (rows, columns) of K4's designs
SHAPES = [(2304, 2048), (2304, 1024), (2048, 2304), (2304, 9216), (9216, 2304)]
TILES = {"fma_small": (8, None), "fma_large": (64, None), "decode": (16, None),
         "mma": (128, 128)}
# K2's tiles (rows, columns, K step) per design, as quant_matmul.cu sets them
# (`decode` takes 256 columns a block where N >= 4096)
QM_TILES = {"decode": (16, 128, 64), "decode_wide": (16, 256, 64), "mma": (128, 128, 64),
            "fma_small": (8, 64, 128), "fma_large": (64, 64, 32)}
LAYER_SHAPES = [(2304, 2048), (2304, 1024), (2304, 1024), (2048, 2304),
                (2304, 9216), (2304, 9216), (9216, 2304)]


def _idx(rng, K, N, bs, density):
    nbi, nbo = K // bs, N // bs
    keep = max(1, int(round(density * nbi)))
    order = np.argsort(rng.random((nbo, nbi)), axis=1)[:, :keep]
    return torch.from_numpy(np.sort(order, axis=1).astype(np.int32))


@pytest.mark.parametrize("M", [1, 8, 16, 17, 65, 129, 512])
def test_block_sparse_variant_by_dtype_and_rows(M):
    assert ops.block_sparse_variant(torch.float32, M) == "fma"
    want = "decode" if M <= ops.DECODE_M else "mma"
    assert ops.block_sparse_variant(torch.bfloat16, M) == want
    for dtype in (torch.float32, torch.bfloat16):
        assert f"block_sparse_matmul.{ops.block_sparse_variant(dtype, M)}" in ops.variant_count


def test_flash_variant_by_dtype():
    assert ops.flash_variant(torch.float32) == "fma"
    assert ops.flash_variant(torch.bfloat16) == "mma"
    assert {f"flash_attention.{ops.flash_variant(d)}" for d in (torch.float32, torch.bfloat16)} \
        == {k for k in ops.variant_count if k.startswith("flash_attention.")}


@pytest.mark.parametrize("design", sorted(TILES))
@pytest.mark.parametrize("bs", ops.BLOCK_SIZES)
@pytest.mark.parametrize("M", [8, 37, 512])
def test_block_sparse_plan_covers_every_tile_and_block(design, bs, M):
    """The grid covers y, the splits cover the walk exactly once, and a
    small grid is split towards two blocks per SM."""
    bm, bn = TILES[design]
    bn = bn or bs
    for K, N in SHAPES:
        keep = max(1, round(0.75 * K // bs))
        (cols, rows, splits), per = ops.block_sparse_plan(M, N, K, bs, keep, bm, bn)
        steps = min(K // bs, (bn // bs) * keep)
        assert cols * bn >= N > (cols - 1) * bn and rows * bm >= M > (rows - 1) * bm
        assert splits * per >= steps > (splits - 1) * per and 1 <= splits <= steps
        assert cols * rows * splits >= min(2 * 132, cols * rows * steps) // 2


def test_block_sparse_plan_decode_shape():
    """gemma2-2b's q projection at bs 16, density 0.75: in decode 128
    output columns of 108 kept tiles each, split in three; at M = 512, 72
    tiles of 128 x 128 over 144 input blocks, split in four."""
    (cols, rows, splits), per = ops.block_sparse_plan(8, 2048, 2304, 16, 108, 16, 16)
    assert (cols, rows, splits, per) == (128, 1, 3, 36)
    (cols, rows, splits), per = ops.block_sparse_plan(512, 2304, 2304, 16, 108, 128, 128)
    assert (cols, rows, splits, per) == (18, 4, 4, 36)


@pytest.mark.parametrize("bs,cols", [(16, 8), (32, 4), (64, 2), (128, 1)])
@pytest.mark.parametrize("density", [0.25, 0.75, 1.0])
def test_group_schedule_kept_pairs_equal_block_mask(bs, cols, density):
    """The group schedule's set bits are exactly idx's kept (block, column)
    pairs, also where the last group is cut short by N."""
    rng = np.random.default_rng(bs + int(100 * density))
    K, N = 512, 48 * bs                      # 48 columns: a partial last group at bs 16
    idx = _idx(rng, K, N, bs, density)
    sched = ops.group_schedule(idx, K // bs, cols)
    assert sched.shape == (math.ceil(N // bs / cols), K // bs) and sched.dtype == torch.int32
    bits = (sched[:, None, :] >> torch.arange(cols)[None, :, None]) & 1   # [g, c, i]
    kept = bits.reshape(-1, K // bs)[:N // bs].T.bool()                   # [K/bs, N/bs]
    assert torch.equal(kept, ref.block_mask_from_idx(idx, K // bs))
    assert int(bits.reshape(-1, K // bs)[N // bs:].sum()) == 0


def test_wrappers_refuse_what_no_design_takes():
    x = torch.zeros((4, 64), dtype=torch.float16)
    w = torch.zeros((64, 32), dtype=torch.bfloat16)
    idx = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="bf16 or f32"):
        ops.block_sparse_matmul(x, w, idx, bs=16)
    with pytest.raises(ValueError, match="does not match"):
        ops.block_sparse_matmul(torch.zeros((4, 48)), w, idx, bs=16)
    with pytest.raises(ValueError, match="idx"):
        ops.block_sparse_matmul(x.float(), w, idx.float(), bs=16)
    q = torch.zeros((1, 4, 2, 32))
    with pytest.raises(ValueError, match="one dtype"):
        ops.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="out of range"):
        ops.flash_attention(q, q, q, t_real=5)


def test_wrappers_leave_variant_counts_alone_on_cpu():
    ops.reset_launch_counts()
    x = torch.zeros((2, 128), dtype=torch.bfloat16)
    ops.block_sparse_matmul(x, torch.zeros((128, 32), dtype=torch.bfloat16),
                            torch.zeros((2, 1), dtype=torch.int32), bs=16)
    q = torch.zeros((1, 4, 2, 32), dtype=torch.bfloat16)
    ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    for rows in (2, 40):
        ops.quant_matmul(torch.zeros((rows, 128)).bfloat16(),
                         torch.zeros((128, 32), dtype=torch.int8), torch.ones((1, 32)),
                         group=128)
    pool = torch.zeros((3, 16, 2, 32), dtype=torch.bfloat16)
    ops.paged_attention(torch.zeros((2, 1, 4, 32), dtype=torch.bfloat16), pool, pool,
                        torch.tensor([[0], [1]]), torch.tensor([3, 16]), window=8)
    assert set(ops.variant_count.values()) == {0}
    assert set(ops.launch_count.values()) == {0}
    ops.variant_count["flash_attention.mma"] = 3
    ops.reset_launch_counts()
    assert set(ops.variant_count.values()) == {0}


@pytest.mark.parametrize("M", [1, 8, 16, 17, 296, 512])
def test_quant_matmul_variant_by_dtype_shape_and_group(M):
    """f32 and the shapes the bf16 designs do not take run ``fma``; bf16
    runs ``decode`` up to DECODE_M rows and ``mma`` above."""
    bf16 = torch.bfloat16
    want = "decode" if M <= ops.DECODE_M else "mma"
    assert ops.quant_matmul_variant(bf16, M, 2304, 128) == want
    assert ops.quant_matmul_variant(bf16, M, 9216, 64) == want
    assert ops.quant_matmul_variant(torch.float32, M, 2304, 128) == "fma"
    assert ops.quant_matmul_variant(bf16, M, 260, 128) == "fma"        # ragged N
    assert ops.quant_matmul_variant(bf16, M, 2304, 80) == "fma"        # group 80
    assert ops.quant_matmul_variant(bf16, M, 2304, 32) == "fma"        # group < stage
    assert ops.quant_matmul_variant(bf16, M, 2304, 128, aligned=False) == "fma"
    names = {ops.quant_matmul_variant(d, M, n, g)
             for d in (bf16, torch.float32) for n in (260, 2304) for g in (80, 128)}
    assert {f"quant_matmul.{v}" for v in names} <= set(ops.variant_count)
    # each design counted for dense linears and for K2 over experts
    assert {f"quant_matmul.{e}{v}" for e in ("", "expert_") for v in ("decode", "mma", "fma")} \
        == {k for k in ops.variant_count if k.startswith("quant_matmul.")}


@pytest.mark.parametrize("design", sorted(QM_TILES))
@pytest.mark.parametrize("M", [1, 8, 16, 17, 296, 512])
def test_quant_matmul_plan_covers_every_tile_and_k_step(design, M):
    """K2's grid covers every output tile of y once, and its splits cover
    every K step of each tile exactly once, at gemma2-2b's shapes; the K
    walk is split only where the tiles are fewer than two per SM."""
    bm, bn, bk = QM_TILES[design]
    for K, N in LAYER_SHAPES:
        (cols, rows, splits), k_per_split = ops.quant_matmul_plan(M, N, K, bm, bn, bk)
        assert cols * bn >= N > (cols - 1) * bn and rows * bm >= M > (rows - 1) * bm
        assert k_per_split % bk == 0
        steps = np.zeros(math.ceil(K / bk), np.int64)
        for z in range(splits):
            k0 = z * k_per_split
            assert k0 < K                              # no split without work
            steps[k0 // bk:min(K, k0 + k_per_split) // bk] += 1
        assert (steps == 1).all()
        if cols * rows >= 2 * 132:
            assert splits == 1
        else:
            assert cols * rows * splits >= min(2 * 132, cols * rows * len(steps)) // 2


def test_quant_matmul_plan_decode_shape():
    """gemma2-2b's wk at M = 8: 8 column blocks of 128, 36 stages of 64
    code rows split in 18; wi at M = 8: 36 column blocks of 256 split in 8;
    wi at M = 512: 288 tiles, no split."""
    assert ops.quant_matmul_plan(8, 1024, 2304, 16, 128, 64) == ((8, 1, 18), 128)
    assert ops.quant_matmul_plan(8, 9216, 2304, 16, 256, 64) == ((36, 1, 8), 320)
    assert ops.quant_matmul_plan(512, 9216, 2304, 128, 128, 64) == ((72, 4, 1), 2304)


@pytest.mark.parametrize("window", [0, 64, 4096])
@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("S,Kh", [(8, 4), (1, 1), (64, 8)])
def test_paged_attention_plan_covers_the_span_once(window, bs, S, Kh):
    """Split z covers relative positions [z per, (z + 1) per) of the live
    range, which is at most the span long: every position of the span
    falls in exactly one split, a split is whole pool blocks of at most
    PA_MAX_PER positions, and the main path's shape fills the card."""
    T = 1024
    splits, per = ops.paged_attention_plan(S, Kh, T, window, bs)
    span = min(T, window) if window else T
    assert per % bs == 0 and bs <= per <= ops.PA_MAX_PER
    hits = np.zeros(splits * per, np.int64)
    for z in range(splits):
        hits[z * per:(z + 1) * per] += 1
    assert (hits[:span] == 1).all() and splits * per - span < per
    if (S, Kh) == (8, 4) and window != 64:
        assert S * Kh * splits >= 132


def test_paged_attention_plan_main_path():
    """At the main path's shape (8 slots, 4 KV heads, T = 1024, bs 32) a
    split is one pool block: 32 splits, 1024 blocks."""
    assert ops.paged_attention_plan(8, 4, 1024, 0, 32) == (32, 32)
    assert ops.paged_attention_plan(8, 4, 1024, 4096, 32) == (32, 32)
    assert ops.paged_attention_plan(8, 4, 1024, 64, 32) == (2, 32)


def test_head_dim_112_accepted_and_planned():
    """zamba2's head dim is in both attention wrappers' lists, and K1's
    plan at its decode shapes (8 slots, 32 KV heads or 16 after kv50, G 1,
    blocks of 32) covers 1024 positions in whole blocks."""
    assert 112 in ops.PA_HEAD_DIMS and 112 in ops.HEAD_DIMS
    for Kh in (32, 16):
        for T in (128, 1024):
            splits, per = ops.paged_attention_plan(8, Kh, T, 0, 32)
            assert per % 32 == 0 and splits * per >= T > (splits - 1) * per
    assert ops.paged_attention_plan(8, 32, 1024, 0, 32) == (5, 224)
    assert ops.paged_attention_plan(8, 16, 1024, 0, 32) == (8, 128)


@pytest.mark.parametrize("G", [1, 2, 7, 8, 9, 11, 16, 24, 48, 64, 65, 72, 96])
def test_paged_attention_variant_by_dtype_and_g(G):
    """``split`` up to 8 query rows per KV head in either dtype; above,
    ``mma`` for bf16 up to 64 rows, else ``chunked``: the split kernels
    over chunks of the largest divisor of G up to 8."""
    bf16, f32 = torch.bfloat16, torch.float32
    if G <= ops.PA_SPLIT_MAX_G:
        assert ops.paged_attention_variant(bf16, G) == "split"
        assert ops.paged_attention_variant(f32, G) == "split"
    else:
        assert ops.paged_attention_variant(bf16, G) == ("mma" if G <= ops.PA_MMA_MAX_G
                                                        else "chunked")
        assert ops.paged_attention_variant(f32, G) == "chunked"
    c = ops.paged_attention_chunk(G)
    assert G % c == 0 and 1 <= c <= ops.PA_SPLIT_MAX_G
    assert all(G % d for d in range(c + 1, ops.PA_SPLIT_MAX_G + 1))
    assert {f"paged_attention.{ops.paged_attention_variant(d, G)}" for d in (bf16, f32)} \
        <= {k for k in ops.variant_count if k.startswith("paged_attention.")}


def test_paged_attention_designs_are_counted():
    assert {k for k in ops.variant_count if k.startswith("paged_attention.")} == {
        "paged_attention.split", "paged_attention.mma", "paged_attention.chunked"}
    assert (ops.paged_attention_chunk(48), ops.paged_attention_chunk(9),
            ops.paged_attention_chunk(11)) == (8, 3, 1)


@pytest.mark.parametrize("T", [128, 1024])
@pytest.mark.parametrize("G", [9, 16, 24, 48, 64])
def test_paged_attention_plan_at_one_kv_head(T, G):
    """granite's decode (8 slots, one KV head, blocks of 32): ``mma``'s plan
    takes at least 2 G positions a split (whole blocks, at most
    PA_MAX_PER), so a split's f32 partial [G, D] is no larger than its
    bf16 V rows, and still covers the span once; the ``split`` plan at one
    KV head is one block a split."""
    splits, per = ops.paged_attention_plan(8, 1, T, 0, 32, 2 * G)
    assert per % 32 == 0 and min(ops.PA_MAX_PER, 2 * G) <= per <= ops.PA_MAX_PER
    assert splits * per >= T > (splits - 1) * per
    assert ops.paged_attention_plan(8, 1, T, 0, 32) == (T // 32, 32)


def test_paged_attention_plan_granite():
    """At granite's shape (8 slots, Kh 1, G 48, T 1024, bs 32) ``mma`` takes
    11 splits of 96 positions; a window of 64 takes one split of 96."""
    assert ops.paged_attention_plan(8, 1, 1024, 0, 32, 96) == (11, 96)
    assert ops.paged_attention_plan(8, 1, 1024, 64, 32, 96) == (1, 96)
    assert ops.paged_attention_plan(8, 1, 128, 0, 32, 96) == (2, 96)
    # min_per 0 is the plan of `split`, unchanged
    assert ops.paged_attention_plan(8, 4, 1024, 0, 32, 0) == (32, 32)
