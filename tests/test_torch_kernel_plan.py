"""Host-side plans of the port's K3 and K4 designs: which design runs for
a dtype and shape, K4's grid and split plan, and the column-group
schedule of its ``mma`` design.  The kernels themselves run only on the
card, where ``chip_smoke.py`` holds them to their plain versions."""
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
    assert set(ops.variant_count.values()) == {0}
    ops.variant_count["flash_attention.mma"] = 3
    ops.reset_launch_counts()
    assert set(ops.variant_count.values()) == {0}
