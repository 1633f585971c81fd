"""Port kernels' plain versions vs the reference kernels and oracles.

Inputs are made with numpy from a seed and go through the JAX kernel
(``interpret=True``, as tests/test_kernels.py runs it) or its oracle,
and through the port's wrapper on CPU tensors, which computes the
kernel's plain version.
Tolerances are the bounds of tests/test_kernels.py: 2e-2 of the largest
magnitude for the bf16 matmuls and flash attention, 1e-5 for f32 paged
attention, and 1e-5 for the f32 block-sparse matmul and flash attention
(the same products summed in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.core import quantize as RQ  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.core import sparsify as RS  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_kernel  # noqa: E402
from repro.models.layers import flash_attention_jnp  # noqa: E402
from repro.models.transformer import _masked_decode  # noqa: E402
from repro_torch.bridge import to_tensor  # noqa: E402
from repro_torch.core import compressed as C  # noqa: E402
from repro_torch.core import quantize as Q  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.backend import resolve_backend  # noqa: E402


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


def _np(t):
    return t.float().numpy()


def _qt(w, **kw):
    """(reference QTensor, port QTensor) for the same numpy weight."""
    rq = RQ.absmax_quantize(w, **kw)
    pq = Q.absmax_quantize(torch.from_numpy(w),
                           **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                              for k, v in kw.items()})
    return rq, pq


@pytest.mark.parametrize("M,K,N,g", [
    (8, 128, 128, 128), (64, 256, 128, 64), (1, 512, 256, 128),
    (130, 256, 384, 32), (16, 1024, 128, 128),
])
def test_quant_matmul_plain_matches_reference_kernel(M, K, N, g):
    rng = np.random.default_rng(M * 7 + K)
    w = rng.normal(size=(K, N)).astype(np.float32)
    rq, pq = _qt(w, bits=8, group=g)
    xj = jnp.asarray(rng.normal(size=(M, K)), jnp.float32).astype(jnp.bfloat16)
    x = to_tensor(xj, "cpu")
    got = ops.quant_matmul(x, pq.q, pq.scale, group=pq.group)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    want_kernel = rops.quant_matmul(xj, rq.q, rq.scale, group=rq.group, interpret=True)
    want_ref = rref.quant_matmul(xj, rq.q, rq.scale, group=rq.group)
    assert _rel(_np(got), want_kernel) < 2e-2
    assert _rel(_np(got), want_ref) < 2e-2


@pytest.mark.parametrize("xdtype", ["bfloat16", "float32"])
def test_quant_matmul_in_scale_and_dtypes(xdtype):
    """SmoothQuant ``in_scale`` applied once, as the reference kernel path
    and ``ref.quant_matmul`` do (not as ``_q_matmul_jnp``, which applies
    it twice); the output keeps x's dtype."""
    rng = np.random.default_rng(11)
    w = rng.normal(size=(256, 128)).astype(np.float32)
    amax = (np.abs(rng.normal(size=256)) + 0.5).astype(np.float32)
    rq, pq = _qt(w, bits=8, group=128, amax_x=amax, smooth_alpha=0.5)
    assert pq.in_scale is not None
    np.testing.assert_allclose(_np(pq.in_scale), np.asarray(rq.in_scale), rtol=1e-5)
    xj = jnp.asarray(rng.normal(size=(2, 8, 256))).astype(getattr(jnp, xdtype))
    x = to_tensor(xj, "cpu")
    got = ops.quant_matmul(x, pq.q, pq.scale, group=pq.group, in_scale=pq.in_scale)
    assert got.dtype == getattr(torch, xdtype) and got.shape == (2, 8, 128)
    want = rref.quant_matmul(xj, rq.q, rq.scale, group=rq.group, in_scale=rq.in_scale)
    assert _rel(_np(got), want) < 2e-2
    # against the true product x @ w
    assert _rel(_np(got), np.asarray(xj, np.float32) @ w) < 2e-2


def test_quant_matmul_wrapper_checks():
    q = torch.zeros((256, 64), dtype=torch.int8)
    s = torch.ones((2, 64))
    x = torch.zeros((4, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bits"):
        ops.quant_matmul(x, q, s, group=128, bits=4)
    with pytest.raises(ValueError, match="divisible"):
        ops.quant_matmul(x, q, torch.ones((3, 64)), group=100)
    with pytest.raises(ValueError, match="int8"):
        ops.quant_matmul(x, q.float(), s, group=128)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("K,N,g", [(256, 128, 128), (384, 96, 128), (96, 64, 40)])
def test_absmax_codes_and_scales_bit_equal(bits, K, N, g):
    w = np.random.default_rng(K + N + bits).normal(size=(K, N)).astype(np.float32)
    rq, pq = _qt(w, bits=bits, group=g)
    assert pq.group == rq.group and pq.shape == tuple(rq.shape)
    assert np.array_equal(pq.q.numpy(), np.asarray(rq.q))
    assert np.array_equal(pq.scale.numpy(), np.asarray(rq.scale))
    assert np.array_equal(pq.unpack().numpy(), np.asarray(rq.unpack()))
    assert np.array_equal(pq.dequantize().float().numpy(),
                          np.asarray(rq.dequantize(), np.float32))


@pytest.mark.parametrize("win,cap", [(0, 0.0), (24, 0.0), (0, 30.0), (24, 30.0)])
def test_paged_attention_plain_matches_reference_oracle(win, cap):
    """Scrambled block tables over a pool with a spare block, held against
    the oracle tests/test_kernels.py holds the Pallas kernel to (the
    model's contiguous ``_masked_decode``); f32 throughout.  The Pallas
    kernel itself no longer traces under the installed JAX
    (``pl.store`` is gone), so its interpret mode cannot be the oracle."""
    rng = np.random.default_rng(win + int(cap))
    S, T, H, Kh, D, bs = 3, 64, 4, 2, 32, 16
    nblk = T // bs
    q = rng.normal(size=(S, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(S, T, Kh, D)).astype(np.float32)
    v = rng.normal(size=(S, T, Kh, D)).astype(np.float32)
    lengths = np.array([17, 40, 64], np.int32)
    tables = rng.permutation(S * nblk).astype(np.int32).reshape(S, nblk)
    kp = np.zeros((S * nblk + 1, bs, Kh, D), np.float32)
    vp = np.zeros_like(kp)
    for s in range(S):
        for j in range(nblk):
            kp[tables[s, j]] = k[s, j * bs:(j + 1) * bs]
            vp[tables[s, j]] = v[s, j * bs:(j + 1) * bs]
    got = ops.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                              torch.from_numpy(vp), torch.from_numpy(tables),
                              torch.from_numpy(lengths), softcap=cap, window=win)
    kpos = np.arange(T)
    valid = kpos[None, :] < lengths[:, None]
    if win:
        valid &= kpos[None, :] >= (lengths[:, None] - win)
    want = _masked_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(valid), cap)
    assert got.shape == (S, 1, H, D)
    assert _rel(got.numpy(), want) < 1e-5


def test_matmul_dispatches_int8_to_kernel_wrapper(monkeypatch):
    """Under ``kernel_backend("cuda")`` an int8 QTensor goes to
    ``ops.quant_matmul``; on CPU tensors the wrapper computes the plain
    version, so the result equals the reference backend's exactly."""
    rng = np.random.default_rng(3)
    qt = Q.absmax_quantize(torch.from_numpy(rng.normal(size=(128, 64)).astype(np.float32)),
                           group=64)
    x = torch.from_numpy(rng.normal(size=(4, 128)).astype(np.float32)).bfloat16()
    base = C.matmul(x, qt)
    calls = []
    orig = ops.quant_matmul

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(ops, "quant_matmul", spy)
    with C.kernel_backend("cuda"):
        assert C.current_backend("cpu") == "cuda"
        out = C.matmul(x, qt)
    assert calls and torch.equal(out, base)
    assert C.current_backend("cpu") == "reference"
    assert resolve_backend("auto", "cuda") == "cuda"
    assert resolve_backend("auto", "cpu") == "reference"
    with pytest.raises(ValueError):
        resolve_backend("pallas", "cpu")


def test_wrappers_leave_launch_counts_alone_on_cpu():
    ops.reset_launch_counts()
    x = torch.zeros((2, 128), dtype=torch.bfloat16)
    ops.quant_matmul(x, torch.zeros((128, 16), dtype=torch.int8),
                     torch.ones((1, 16)), group=128)
    ops.block_sparse_matmul(x, torch.zeros((128, 32), dtype=torch.bfloat16),
                            torch.zeros((2, 1), dtype=torch.int32), bs=16)
    q = torch.zeros((1, 4, 2, 32))
    ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    assert ops.launch_count == {"quant_matmul": 0, "paged_attention": 0,
                                "block_sparse_matmul": 0, "flash_attention": 0}


def test_reference_double_in_scale_fault_not_reproduced():
    """The reference's jnp path ``_q_matmul_jnp`` scales x by ``in_scale``
    and contracts with ``dequantize()``, which already folds ``in_scale``
    into the weight: SmoothQuant is applied twice.  The port applies it
    once, like the reference's kernel path and ``ref.quant_matmul``."""
    from repro.core.compressed import _q_matmul_jnp
    rng = np.random.default_rng(0)
    w = rng.normal(size=(256, 128)).astype(np.float32)
    amax = (np.abs(rng.normal(size=256)) + 0.5).astype(np.float32)
    rq, pq = _qt(w, bits=8, group=128, amax_x=amax, smooth_alpha=0.5)
    x = rng.normal(size=(16, 256)).astype(np.float32)
    true = x @ w

    def err(y):
        y = np.asarray(y, np.float32)
        return float(np.linalg.norm(y - true) / np.linalg.norm(true))

    ref_jnp = err(_q_matmul_jnp(jnp.asarray(x), rq))
    port = err(C.matmul(torch.from_numpy(x), pq).numpy())
    print(f"relative error vs x @ w: reference jnp path {ref_jnp:.3f}, port {port:.3f}")
    assert ref_jnp > 0.1 and port < 2e-2


def test_int4_matmul_matches_reference():
    """int4 weights stay on the plain formula (no kernel), as in the
    reference's dispatch; without ``in_scale`` the two formulas agree."""
    from repro.core import compressed as RC
    rng = np.random.default_rng(5)
    w = rng.normal(size=(256, 96)).astype(np.float32)
    rq, pq = _qt(w, bits=4, group=64)
    xj = jnp.asarray(rng.normal(size=(3, 5, 256)), jnp.float32).astype(jnp.bfloat16)
    want = RC.matmul(xj, rq)
    with C.kernel_backend("cuda"):
        got = C.matmul(to_tensor(xj, "cpu"), pq)
    assert got.shape == (3, 5, 96) and got.dtype == torch.bfloat16
    assert _rel(_np(got), want) < 2e-2


@pytest.mark.parametrize("field", [
    {"drop_units": 1}, {"kv_keep_frac": 0.5}, {"ffn_keep_frac": 0.5},
    {"experts_keep": 2}, {"quant_embed": True},
])
def test_once_unported_recipe_fields_apply(field):
    """Every recipe field that once raised applies: the structural ones on
    a dense model (stage 1, ``core/prune.py``), ``experts_keep`` as a
    no-op there, as in the reference, and ``quant_embed`` as an int8
    ``QEmbed`` table of V d + 4 V bytes."""
    from repro_torch.configs import gemma2_2b
    from repro_torch.core.pipeline import InstanceOptimizer, Recipe
    from repro_torch.models import api
    cfg = gemma2_2b.reduced()
    gen = torch.Generator()
    gen.manual_seed(0)
    opt = InstanceOptimizer(api.init_params(gen, cfg), cfg)
    recipe = Recipe(wbits=8, quant_method="absmax", **field)
    params2, cfg2, report = opt.apply(recipe)
    if "quant_embed" in field:
        from repro_torch.core.compressed import QEmbed
        V, d = cfg.vocab_size, cfg.d_model
        assert isinstance(params2["embed"], QEmbed) and cfg2 == cfg
        assert params2["embed"].nbytes == V * d + 4 * V
        return
    want = {"drop_units": dict(n_layers=2, attn_pattern="LG"),
            "kv_keep_frac": dict(n_kv_heads=1, n_heads=2, head_dim=cfg.resolved_head_dim),
            "ffn_keep_frac": dict(d_ff=64), "experts_keep": {}}[next(iter(field))]
    assert cfg2 == cfg.replace(**want) and report.cfg_after == cfg2


@pytest.mark.parametrize("K,N,bs,dens", [
    (256, 256, 64, 0.5), (512, 128, 128, 0.75), (128, 256, 32, 0.25), (256, 128, 16, 0.75),
])
@pytest.mark.parametrize("xdtype", ["bfloat16", "float32"])
def test_block_sparse_plain_matches_reference_kernel(K, N, bs, dens, xdtype):
    """The reference's kernel-test cases plus bs = 16; the weight is the
    reference's zero-filled ``BlockSparseTensor`` with its gather indices."""
    rng = np.random.default_rng(K + N + bs)
    w = rng.normal(size=(K, N)).astype(np.float32)
    bst = RS.apply_block_mask(w, RS.block_sparse_mask(w, bs=bs, density=dens), bs)
    xj = jnp.asarray(rng.normal(size=(16, K)), jnp.float32).astype(xdtype)
    want = rops.block_sparse_matmul(xj, bst.w, bst.idx, bs=bs, interpret=True)
    got = ops.block_sparse_matmul(to_tensor(xj, "cpu"), to_tensor(bst.w, "cpu"),
                                  to_tensor(bst.idx, "cpu"), bs=bs)
    assert got.dtype == getattr(torch, xdtype) and got.shape == (16, N)
    tol = 2e-2 if xdtype == "bfloat16" else 1e-5
    assert _rel(_np(got), want) < tol
    assert _rel(_np(got), rref.block_sparse_matmul(xj, bst.w, bst.mask, bs=bs)) < tol


def test_block_sparse_plain_reads_only_listed_blocks():
    """Blocks outside ``idx`` count as zero even where ``w`` is not."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32)).bfloat16()
    idx = torch.tensor([[1, 3], [0, 2]], dtype=torch.int32)
    x = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    got = ops.block_sparse_matmul(x, w, idx, bs=16)
    wz = w.float().clone()
    wz[0:16, 0:16] = wz[32:48, 0:16] = 0
    wz[16:32, 16:32] = wz[48:64, 16:32] = 0
    assert torch.allclose(got, x @ wz, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="bs"):
        ops.block_sparse_matmul(x, w, idx, bs=8)
    with pytest.raises(ValueError, match="bf16"):
        ops.block_sparse_matmul(x, w.float(), idx, bs=16)
    with pytest.raises(ValueError, match="idx"):
        ops.block_sparse_matmul(x, w, idx[:1], bs=16)


FLASH_CASES = [   # B, S, T, H, Kh, D, window, softcap (tests/test_kernels.py)
    (2, 64, 64, 4, 2, 64, 0, 0.0), (1, 128, 128, 8, 1, 32, 32, 0.0),
    (2, 64, 64, 4, 4, 64, 0, 30.0), (1, 64, 192, 2, 2, 32, 0, 0.0),
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_plain_matches_reference_kernel(case, dtype):
    B, S, T, H, Kh, D, win, cap = case
    rng = np.random.default_rng(S + T + H)
    q, k, v = (jnp.asarray(rng.normal(size=shape), jnp.float32).astype(dtype)
               for shape in ((B, S, H, D), (B, T, Kh, D), (B, T, Kh, D)))
    kw = dict(causal=True, window=win, softcap=cap, q_offset=T - S)
    want = rops.flash_attention(q, k, v, interpret=True, **kw)
    got = ops.flash_attention(*(to_tensor(a, "cpu") for a in (q, k, v)), **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, H, D)
    assert _rel(_np(got), want) < (2e-2 if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_plain_matches_reference_kernel_padded_kv(dtype):
    """A padded KV length with ``t_real`` and a query offset, against the
    Pallas kernel (heads flattened into its batch axis)."""
    rng = np.random.default_rng(4)
    B, S, T, H, Kh, D, t_real = 1, 64, 256, 4, 2, 32, 200
    q, k, v = (jnp.asarray(rng.normal(size=shape), jnp.float32).astype(dtype)
               for shape in ((B, S, H, D), (B, T, Kh, D), (B, T, Kh, D)))
    want = flash_attention_kernel(
        q.transpose(0, 2, 1, 3).reshape(B * H, S, D),
        k.transpose(0, 2, 1, 3).reshape(B * Kh, T, D),
        v.transpose(0, 2, 1, 3).reshape(B * Kh, T, D), group=H // Kh, causal=True,
        softcap=50.0, t_real=t_real, q_offset=t_real - S, bq=32, bkv=64, interpret=True)
    want = np.asarray(want, np.float32).reshape(B, H, S, D).transpose(0, 2, 1, 3)
    got = ops.flash_attention(*(to_tensor(a, "cpu") for a in (q, k, v)), causal=True,
                              softcap=50.0, t_real=t_real, q_offset=t_real - S)
    assert _rel(_np(got), want) < (2e-2 if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("S,T,win,cap,bq,bkv", [
    (256, 256, 0, 0.0, 64, 128), (256, 256, 96, 50.0, 128, 64), (128, 384, 0, 30.0, 32, 128),
    (512, 512, 64, 50.0, 64, 64), (128, 384, 48, 0.0, 32, 64),
])
def test_flash_plain_matches_flash_attention_jnp(S, T, win, cap, bq, bkv):
    """f32 against the reference's blocked jnp twin.  The plain version
    runs on the case's own tiles, so its recurrence across tiles (the
    rescaling of earlier sums, the causal skip of key tiles past the
    query tile, the window's skip of whole key tiles behind it: the last
    two cases) meets the reference, and on its default single tile."""
    rng = np.random.default_rng(S + win)
    q = rng.normal(size=(2, S, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, T, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, T, 2, 16)).astype(np.float32)
    want = flash_attention_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                               window=win, cap=cap, q_offset=T - S, bq=bq, bkv=bkv)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(causal=True, window=win, softcap=cap, q_offset=T - S)
    tiled = ref.flash_attention(qt, kt, vt, bq=bq, bkv=bkv, **kw)
    got = ops.flash_attention(qt, kt, vt, **kw)
    assert _rel(tiled.numpy(), want) < 1e-5
    assert _rel(got.numpy(), want) < 1e-5


def test_flash_row_without_live_key_is_zero():
    """A query row whose window holds no real key gives 0, not NaN."""
    q = torch.randn((1, 8, 2, 32))
    k = torch.randn((1, 8, 1, 32))
    got = ops.flash_attention(q, k, k, causal=True, window=2, t_real=3)
    assert torch.isfinite(got).all()
    assert torch.equal(got[:, 4:], torch.zeros_like(got[:, 4:]))
    assert got[:, :4].abs().sum() > 0


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("win", [0, 24, 4096])
@pytest.mark.parametrize("per", [0, 32])
def test_paged_attention_split_model_matches_plain_and_oracle(dtype, tol, win, per):
    """K1's split-and-merge arithmetic (``ref.paged_attention_split``: per-
    split scores and (max, sum of exp), the slot's (m, l) formed in split
    order, probabilities rounded to V's dtype, partials added in split
    order) equals the plain version and the model's contiguous
    ``_masked_decode`` on the same numpy inputs: lengths at and around
    the split boundaries, a window, a prefix block aliased across slots
    and the trash block past each length.  ``per`` 0 takes the wrapper's
    plan (one pool block per split at this size)."""
    rng = np.random.default_rng(win + per)
    S, Kh, G, D, bs, nblk = 6, 2, 2, 32, 16, 8
    T = nblk * bs
    lengths = np.array([1, 15, 16, 17, 100, 128], np.int32)
    q = rng.normal(size=(S, 1, Kh * G, D)).astype(np.float32)
    k = rng.normal(size=(S, T, Kh, D)).astype(np.float32)
    v = rng.normal(size=(S, T, Kh, D)).astype(np.float32)
    k[:, :bs], v[:, :bs] = k[0, :bs], v[0, :bs]           # one prefix block for all
    trash = S * nblk
    tables = rng.permutation(S * nblk).astype(np.int32).reshape(S, nblk)
    tables[:, 0] = tables[0, 0]
    kp = rng.normal(size=(trash + 1, bs, Kh, D)).astype(np.float32)   # junk everywhere else
    vp = rng.normal(size=(trash + 1, bs, Kh, D)).astype(np.float32)
    for s in range(S):
        for j in range(nblk):
            if j * bs >= lengths[s]:
                tables[s, j] = trash
            else:
                kp[tables[s, j]] = k[s, j * bs:(j + 1) * bs]
                vp[tables[s, j]] = v[s, j * bs:(j + 1) * bs]
    tdt = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(tdt) for a in (q, kp, vp)]
    qr = args[0][:, 0].reshape(S, Kh, G, D)
    splits, p = ops.paged_attention_plan(S, Kh, T, win, bs)
    if per:
        p = per
        splits = -(-min(T, win or T) // per)
    tb, ln = torch.from_numpy(tables), torch.from_numpy(lengths)
    got = ref.paged_attention_split(qr, args[1], args[2], tb, ln, splits=splits, per=p,
                                    softcap=30.0, window=win)
    plain = ref.paged_attention(qr, args[1], args[2], tb, ln, softcap=30.0, window=win)
    assert got.dtype == tdt and bool(torch.isfinite(got.float()).all())
    assert _rel(_np(got), _np(plain)) < tol
    kpos = np.arange(T)
    valid = kpos[None, :] < lengths[:, None]
    if win:
        valid &= kpos[None, :] >= (lengths[:, None] - win)
    jdt = getattr(jnp, dtype)
    want = _masked_decode(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                          jnp.asarray(valid), 30.0)
    assert _rel(_np(got).reshape(S, 1, Kh * G, D), np.asarray(want, np.float32)) < tol


# ---------------------------------------------------------------------------
# zamba2's head dim 112 (14 bf16 or 28 f32 16-byte pieces a row)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_paged_attention_plain_at_head_dim_112(dtype, tol):
    """zamba2's decode attention at a shared site: G 1 (Kh = H), D 112,
    blocks of 32, ragged lengths over a scrambled table, against the
    model's contiguous ``_masked_decode``."""
    rng = np.random.default_rng(112)
    S, T, Kh, D, bs = 3, 128, 4, 112, 32
    assert D in ops.PA_HEAD_DIMS
    nblk = T // bs
    q = rng.normal(size=(S, 1, Kh, D)).astype(np.float32)
    k = rng.normal(size=(S, T, Kh, D)).astype(np.float32)
    v = rng.normal(size=(S, T, Kh, D)).astype(np.float32)
    lengths = np.array([1, 77, 128], np.int32)
    tables = rng.permutation(S * nblk).astype(np.int32).reshape(S, nblk)
    kp = np.zeros((S * nblk + 1, bs, Kh, D), np.float32)
    vp = np.zeros_like(kp)
    for s in range(S):
        for j in range(nblk):
            kp[tables[s, j]] = k[s, j * bs:(j + 1) * bs]
            vp[tables[s, j]] = v[s, j * bs:(j + 1) * bs]
    tdt = getattr(torch, dtype)
    got = ops.paged_attention(*(torch.from_numpy(a).to(tdt) for a in (q, kp, vp)),
                              torch.from_numpy(tables), torch.from_numpy(lengths))
    valid = np.arange(T)[None, :] < lengths[:, None]
    want = _masked_decode(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
                          jnp.asarray(valid), 0.0)
    assert got.dtype == tdt and got.shape == (S, 1, Kh, D)
    assert _rel(_np(got), want) < tol


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_plain_at_head_dim_112(dtype):
    """zamba2's long-prefill attention: H = Kh, D 112, causal, with a
    padded KV length (``t_real``), against the reference's ``ref.attention``."""
    assert 112 in ops.HEAD_DIMS
    rng = np.random.default_rng(7)
    B, S, T, H, D, t_real = 1, 96, 160, 2, 112, 130
    q, k, v = (jnp.asarray(rng.normal(size=shape), jnp.float32).astype(dtype)
               for shape in ((B, S, H, D), (B, T, H, D), (B, T, H, D)))
    kw = dict(causal=True, t_real=t_real, q_offset=t_real - S)
    want = rref.attention(*(a[0].transpose(1, 0, 2) for a in (q, k, v)), **kw)
    want = np.asarray(want, np.float32).transpose(1, 0, 2)[None]
    got = ops.flash_attention(*(to_tensor(a, "cpu") for a in (q, k, v)), **kw)
    assert got.shape == (B, S, H, D)
    assert _rel(_np(got), want) < (2e-2 if dtype == "bfloat16" else 1e-5)
