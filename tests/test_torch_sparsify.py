"""Port sparsification vs the reference's ``core/sparsify.py``.

Weights, activation norms and Hessians are made with numpy from a seed
and go through both.  Selection runs in numpy float32 on both sides, so
Wanda masks, block scores, block masks, gather indices and zero-filled
weights must be equal.  SparseGPT propagates its error in float64 torch
against the reference's float64 numpy: masks must agree on at least
99.9% of entries and the pruned weights to 1e-5 of their largest
magnitude.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.core import compressed as RC  # noqa: E402
from repro.core import sparsify as RS  # noqa: E402
from repro.core.pipeline import _stack_q  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import compressed as C  # noqa: E402
from repro_torch.core import sparsify as S  # noqa: E402
from repro_torch.core.compressed import (BlockSparseTensor, idx_from_mask,  # noqa: E402
                                         param_bytes)
from repro_torch.kernels import ops  # noqa: E402


def _w(rng, K, N):
    return rng.normal(size=(K, N)).astype(np.float32)


def _norm(rng, K):
    return (np.abs(rng.normal(size=K)) + 0.1).astype(np.float32)


def _hessian(rng, K, rows=256):
    x = rng.normal(size=(rows, K)) * (np.abs(rng.normal(size=K)) + 0.2)
    return x.T @ x


@pytest.mark.parametrize("kw", [dict(sparsity=0.5), dict(sparsity=0.3),
                                dict(n=2, m=4), dict(n=1, m=4)])
def test_wanda_mask_equals_reference(kw):
    rng = np.random.default_rng(len(kw) * 10 + kw.get("n", 0))
    w, an = _w(rng, 128, 96), _norm(rng, 128)
    want = RS.wanda_mask(w, an, **kw)
    got = S.wanda_mask(torch.from_numpy(w), torch.from_numpy(an), **kw)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [dict(sparsity=0.5), dict(n=2, m=4)])
def test_sparsegpt_prune_matches_reference(kw):
    rng = np.random.default_rng(7)
    w, H = _w(rng, 192, 64), _hessian(rng, 192)
    H[5] = H[:, 5] = 0.0                                # a dead input channel
    rw, rmask = RS.sparsegpt_prune(w, H, **kw)
    gw, gmask = S.sparsegpt_prune(torch.from_numpy(w), torch.from_numpy(H), **kw)
    assert gw.dtype == torch.float32 and gmask.dtype == torch.bool
    assert np.mean(gmask.numpy() == rmask) >= 0.999
    assert np.abs(gw.numpy() - rw).max() <= 1e-5 * np.abs(rw).max()
    assert not gw[5].any()


@pytest.mark.parametrize("K,N,bs,dens", [(256, 256, 64, 0.5), (512, 128, 128, 0.75),
                                         (128, 256, 32, 0.25), (256, 128, 16, 0.75),
                                         (96, 64, 16, 0.5)])
def test_block_mask_idx_and_zero_filled_weight_equal_reference(K, N, bs, dens):
    rng = np.random.default_rng(K + N + bs)
    w, an = _w(rng, K, N), _norm(rng, K)
    np.testing.assert_array_equal(S.block_scores(torch.from_numpy(w),
                                                 torch.from_numpy(an), bs),
                                  RS.block_scores(w, an, bs))
    want_mask = RS.block_sparse_mask(w, bs=bs, density=dens, act_norm=an)
    mask = S.block_sparse_mask(torch.from_numpy(w), bs=bs, density=dens,
                               act_norm=torch.from_numpy(an))
    np.testing.assert_array_equal(mask, want_mask)
    want = RS.apply_block_mask(w, want_mask, bs)
    got = S.apply_block_mask(torch.from_numpy(w), mask, bs)
    assert got.w.dtype == torch.bfloat16 and got.bs == bs
    assert np.array_equal(got.w.float().numpy(), np.asarray(want.w, np.float32))
    assert np.array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert np.array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert got.nbytes == want.nbytes and got.density() == pytest.approx(want.density())
    assert S.density(mask) == RS.density(want_mask)


def test_block_mask_ties_keep_lower_rows():
    """Equal block scores: every column keeps exactly ``keep`` blocks,
    the lowest rows first, as the reference's stable tie rule does."""
    w = np.ones((64, 32), np.float32)
    want = RS.block_sparse_mask(w, bs=16, density=0.5)
    got = S.block_sparse_mask(torch.from_numpy(w), bs=16, density=0.5)
    np.testing.assert_array_equal(got, want)
    assert (got.sum(0) == 2).all() and got[:2].all()


def test_bridge_rebuilds_stacked_indices_per_layer():
    """The reference stacks block-sparse layers without ``idx``; the
    bridge rebuilds each layer's indices from its mask."""
    rng = np.random.default_rng(3)
    layers = []
    for _ in range(3):
        w = _w(rng, 128, 64)
        layers.append(RS.apply_block_mask(
            w, RS.block_sparse_mask(w, bs=16, density=0.5, act_norm=_norm(rng, 128)), 16))
    stacked = _stack_q(layers)
    assert stacked.idx is None
    got = bridge.from_reference({"w": stacked}, device="cpu")["w"]
    assert isinstance(got, BlockSparseTensor) and got.idx.shape == (3, 4, 4)
    for r, ref in enumerate(layers):
        one = got.layer(r)
        assert np.array_equal(one.idx.numpy(), np.asarray(ref.idx))
        assert np.array_equal(one.w.float().numpy(), np.asarray(ref.w, np.float32))
    assert param_bytes({"w": got}) == RC.param_bytes({"w": stacked})


def test_idx_from_mask_rejects_uneven_columns():
    mask = torch.tensor([[1.0, 1.0], [1.0, 0.0]])
    assert idx_from_mask(torch.ones(2, 3)).tolist() == [[0, 1]] * 3
    with pytest.raises(ValueError, match="per column"):
        idx_from_mask(mask)


@pytest.mark.parametrize("bad,match", [(lambda i: i + 4, r"\[0, 4\)"),
                                       (lambda i: i - 4, r"\[0, 4\)"),
                                       (lambda i: i[:, :0], "does not fit"),
                                       (lambda i: i[:2], "does not fit"),
                                       (lambda i: i.astype(np.float32), "does not fit")])
def test_bridge_rejects_gather_indices_out_of_range(bad, match):
    """Indices from outside are checked once, where the port's container
    is built: the CUDA kernel would read past the weight on any entry
    outside [0, d_in/bs)."""
    rng = np.random.default_rng(4)
    w = _w(rng, 64, 64)
    rb = RS.apply_block_mask(w, RS.block_sparse_mask(w, bs=16, density=0.5), 16)
    idx = np.asarray(rb.idx)
    ok = bridge.from_reference(
        {"w": types.SimpleNamespace(w=rb.w, mask=rb.mask, bs=16, idx=idx)}, device="cpu")
    assert np.array_equal(ok["w"].idx.numpy(), idx)
    leaf = types.SimpleNamespace(w=rb.w, mask=rb.mask, bs=16, idx=bad(idx))
    with pytest.raises(ValueError, match=match):
        bridge.from_reference({"w": leaf}, device="cpu")


def test_block_sparse_matmul_dispatch_equals_reference_einsum():
    """``matmul`` on a BlockSparseTensor: the plain path (the reference's
    einsum over the zero-filled weight) and, under ``"cuda"`` on CPU
    tensors, the kernel wrapper's plain version agree with the reference."""
    rng = np.random.default_rng(9)
    w = _w(rng, 128, 96)
    rb = RS.apply_block_mask(w, RS.block_sparse_mask(w, bs=32, density=0.5), 32)
    pb = bridge.from_reference({"w": rb}, device="cpu")["w"]
    for dt in ("float32", "bfloat16"):
        xj = jnp.asarray(rng.normal(size=(3, 5, 128)), jnp.float32).astype(dt)
        want = np.asarray(RC.matmul(xj, rb), np.float32)
        x = bridge.to_tensor(xj, "cpu")
        plain = C.matmul(x, pb)
        ops.reset_launch_counts()
        with C.kernel_backend("cuda"):
            kern = C.matmul(x, pb)
        assert ops.launch_count["block_sparse_matmul"] == 0      # CPU: plain version
        tol = 1e-5 if dt == "float32" else 2e-2
        for got in (plain, kern):
            assert got.dtype == x.dtype and got.shape == (3, 5, 96)
            assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


def test_is_weight_leaf_equals_reference():
    """Compressed containers and anything with a shape are weight leaves;
    None, numbers and strings are not."""
    w = _w(np.random.default_rng(3), 64, 32)
    mask = np.ones((4, 2), np.float32)
    port = [torch.from_numpy(w), C.QTensor(torch.zeros((64, 32), dtype=torch.int8),
                                           torch.ones((1, 32)), 8, 64, (64, 32)),
            C.BlockSparseTensor(torch.from_numpy(w), torch.from_numpy(mask), 16), None, 3, "wq"]
    ref = [jnp.asarray(w), RC.QTensor(jnp.zeros((64, 32), jnp.int8), jnp.ones((1, 32)), 8, 64,
                                      (64, 32)),
           RC.BlockSparseTensor(jnp.asarray(w), jnp.asarray(mask), 16), None, 3, "wq"]
    assert [C.is_weight_leaf(x) for x in port] == [RC.is_weight_leaf(x) for x in ref] == \
        [True, True, True, False, False, False]
