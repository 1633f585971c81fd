"""Public wrappers of the hand-written CUDA kernels.

Shape plumbing lives here: flattening leading dims, the ``(Kh, G)`` head
split, int32 tables, lengths and block indices, the reduction splits of
the two matmuls.  Each wrapper checks device, dtype, shape and
contiguity and raises :class:`KernelInputError` on what its kernel does
not take.  For tensors on the CPU it computes the kernel's plain version
(``kernels/ref.py``); for CUDA tensors it launches the kernel on the
current stream, adds one to ``launch_count[name]`` and raises
:class:`KernelError` if the build or the launch fails.  It never falls
back from a CUDA tensor to the plain version.

Each kernel has several designs, chosen by a documented rule on dtype
and shape (:func:`quant_matmul_variant`, :func:`paged_attention_variant`,
:func:`flash_variant`, :func:`block_sparse_variant`): f32 runs the FMA
kernels, whose exact f32 products the 1e-5 checks need, and bf16 the
tensor-core kernels, but for K1 with at most 8 query rows per KV head,
where ``split`` runs on the FMA pipes in both dtypes.  Each launch also adds one
to ``variant_count["<name>.<variant>"]``, so a run shows which design ran.
K2 over experts (:func:`quant_matmul_experts`, an MoE expert stack in one
launch) counts under ``quant_matmul`` and its designs as
``quant_matmul.expert_<variant>``.
"""
from __future__ import annotations

import ctypes
import math
import struct
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kernels.build import KernelError


class KernelInputError(KernelError, ValueError):
    """A wrapper refused inputs its kernel does not take."""


# launches per kernel wrapper since the last reset_launch_counts()
launch_count: Dict[str, int] = {name: 0 for name in
                                ("quant_matmul", "paged_attention",
                                 "block_sparse_matmul", "flash_attention")}
# FLOPs and bytes of those launches, from their shapes (a ctypes launch is
# invisible to PyTorch's dispatcher, so its cost is counted here); same reset
launch_flops: Dict[str, float] = dict.fromkeys(launch_count, 0.0)
launch_bytes: Dict[str, float] = dict.fromkeys(launch_count, 0.0)

_SMS = 132                 # H100 SXM streaming multiprocessors
_SIGS: Dict[str, list] = {
    "quant_matmul_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
    + [ctypes.c_void_p],
    "paged_attention_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14
    + [ctypes.c_void_p],
    "paged_attention_max_g": [],
    "paged_attention_mma_max_g": [],
    "paged_attention_workspace": [ctypes.c_int] * 6,
    "block_sparse_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
    "flash_attention_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
    + [ctypes.c_void_p],
    **{f"quant_matmul_tile_{d}": [ctypes.c_int] * 2 for d in "mnk"},
    "block_sparse_tile_m": [ctypes.c_int] * 2,
    "block_sparse_tile_n": [ctypes.c_int] * 3,
}


# C entry points that return something else than an int
_RESTYPES = {"paged_attention_workspace": ctypes.c_longlong}

# launches per design of each kernel, same reset
variant_count: Dict[str, int] = {name: 0 for name in
                                 ("quant_matmul.decode", "quant_matmul.mma",
                                  "quant_matmul.fma", "quant_matmul.expert_decode",
                                  "quant_matmul.expert_mma", "quant_matmul.expert_fma",
                                  "paged_attention.split", "paged_attention.mma",
                                  "paged_attention.chunked",
                                  "flash_attention.mma", "flash_attention.fma",
                                  "block_sparse_matmul.decode", "block_sparse_matmul.mma",
                                  "block_sparse_matmul.fma")}


def reset_launch_counts() -> None:
    for counts in (launch_count, variant_count, launch_flops, launch_bytes):
        for name in counts:
            counts[name] = 0


def _cost(name: str, flops: float, nbytes: float) -> None:
    """Add one launch's FLOPs and bytes (each input read once, each output
    written once) to ``launch_flops`` and ``launch_bytes``."""
    launch_flops[name] += flops
    launch_bytes[name] += nbytes


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


_FNS: Dict[str, object] = {}


def _fn(kernel: str, symbol: str):
    """The C entry point ``symbol`` of kernel ``kernel`` (built and bound
    at first use)."""
    fn = _FNS.get(symbol)
    if fn is None:
        fn = getattr(build.load(kernel), symbol)
        fn.argtypes = _SIGS[symbol]
        fn.restype = _RESTYPES.get(symbol, ctypes.c_int)
        _FNS[symbol] = fn
    return fn


def _check(err: int, name: str) -> None:
    if err != 0:
        raise KernelError(f"{name} launch failed with CUDA error {err}")


def _f32_bits(v: float) -> int:
    return struct.unpack("<i", struct.pack("<f", float(v)))[0]


def _same_device(name: str, *tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise KernelInputError(f"{name}: tensors on {dev} and {t.device}")
    return dev


def _require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise KernelInputError(f"{name}: {what}")


def grad_refused(*tensors) -> bool:
    """Whether a kernel launch on ``tensors`` would drop a gradient: grad
    mode is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def _no_grad_inputs(name: str, *tensors) -> None:
    _require(not grad_refused(*tensors), name,
             "inputs require grad and the kernel has no backward pass; run it "
             "under torch.no_grad() or take the plain path")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _split(blocks: int, steps: int) -> tuple:
    """(splits, steps per split): cut a reduction of ``steps`` steps so
    that ``blocks`` output tiles become about two blocks per SM."""
    splits = min(steps, max(1, math.ceil(2 * _SMS / blocks)))
    per = math.ceil(steps / splits)
    return math.ceil(steps / per), per


# ---------------------------------------------------------------------------
# K2: int8 group-quantized matmul
# ---------------------------------------------------------------------------

DECODE_M = 16              # rows of x up to which K2 and K4 run their skinny designs
QM_STAGE_K = 64            # code rows per stage of K2's bf16 designs (one scale row)
# K2's designs as the library numbers them (the FMA design: skinny, square tile)
_QM_DESIGNS = {"decode": 0, "mma": 1, "fma_small": 2, "fma_large": 3}


def quant_matmul_variant(dtype: torch.dtype, M: int, N: int, group: int,
                         aligned: bool = True) -> str:
    """K2's design for x of ``dtype`` with ``M`` rows against an [K, N]
    weight in groups of ``group`` rows: ``fma`` for f32 (exact f32
    products) and for what the bf16 designs do not take (N not a multiple
    of 16, q or scale not 16-byte ``aligned``, a group that is not a
    multiple of the QM_STAGE_K-row stage); else ``decode`` for M <=
    DECODE_M (the weight stream on tensor cores) and ``mma`` above (128 x
    128 tiles on tensor cores)."""
    if dtype == torch.float32 or N % 16 or group % QM_STAGE_K or not aligned:
        return "fma"
    return "decode" if M <= DECODE_M else "mma"


def _qm_design(variant: str, M: int) -> int:
    if variant == "fma":
        return _QM_DESIGNS["fma_small" if M <= DECODE_M else "fma_large"]
    return _QM_DESIGNS[variant]


def quant_matmul_plan(M: int, N: int, K: int, bm: int, bn: int, bk: int,
                      experts: int = 1):
    """(grid, K rows per split) of K2 for a ``bm`` x ``bn`` output tile
    stepping ``bk`` rows of K, over ``experts`` matrices: the K steps are
    split only where the output tiles of all the experts give fewer than
    about two blocks per SM.  The grid's z is expert * splits + split."""
    cols, rows = math.ceil(N / bn), math.ceil(M / bm)
    splits, per = _split(experts * cols * rows, math.ceil(K / bk))
    return (cols, rows, experts * splits), per * bk


_TILES: Dict[tuple, tuple] = {}


def _tiles(design: int, N: int) -> tuple:
    """(BM, BN, BK) of K2's design for a weight of N columns, from the
    library."""
    if (design, N) not in _TILES:
        _TILES[design, N] = tuple(_fn("quant_matmul", f"quant_matmul_tile_{d}")(design, N)
                                  for d in "mnk")
    return _TILES[design, N]


def quant_matmul(x, q, scale, *, group: int, in_scale=None, bits: int = 8):
    """x [..., K] @ bf16(q [K, N] int8 * scale [K/g, N]) -> [..., N] in
    x's dtype; ``in_scale`` [K] multiplies x (in f32) first."""
    name = "quant_matmul"
    _require(bits == 8, name, f"only int8 codes are supported, got bits={bits}")
    _require(q.dim() == 2 and q.dtype == torch.int8, name, "q must be [K, N] int8")
    return _quant_matmul(x, q, scale, group, in_scale, "")


def _quant_matmul(x, q, scale, group: int, in_scale, tag: str):
    """The body of both K2 wrappers, q [K, N] (a dense linear, x [..., K])
    or [E, K, N] (an expert stack, x [E, C, K]) int8 codes, ``scale`` and
    ``in_scale`` with the same leading axis: the checks, the plain version
    for CPU tensors, else one launch counted as ``quant_matmul.<tag><design>``."""
    name = "quant_matmul"
    experts = q.dim() == 3
    *lead, K, N = q.shape
    E = lead[0] if experts else 1
    _require(K % group == 0, name, f"K={K} is not divisible by group={group}")
    _require(tuple(scale.shape) == (*lead, K // group, N) and scale.dtype == torch.float32,
             name, f"scale must be f32 {[*lead, K // group, N]}, got {tuple(scale.shape)}")
    if experts:
        _require(x.dim() == 3 and x.shape[0] == E and x.shape[2] == K, name,
                 f"x {tuple(x.shape)} does not match [E={E}, C, K={K}]")
    else:
        _require(x.shape[-1] == K, name, f"x [..., {x.shape[-1]}] does not match K={K}")
    _require(x.dtype in (torch.bfloat16, torch.float32), name,
             f"x must be bf16 or f32, got {x.dtype}")
    _require(in_scale is None or (tuple(in_scale.shape) == (*lead, K)
                                  and in_scale.dtype == torch.float32),
             name, f"in_scale must be f32 {[*lead, K]}")
    dev = _same_device(name, x, q, scale, in_scale)
    if dev.type == "cpu":
        return ref.quant_matmul(x, q, scale, group=group, in_scale=in_scale)
    _no_grad_inputs(name, x, q, scale, in_scale)
    _require(q.is_contiguous() and scale.is_contiguous(), name,
             "q and scale must be contiguous")
    if in_scale is not None:
        x = (x.float() * (in_scale[:, None, :] if experts else in_scale)).to(x.dtype)
    x3 = x.reshape(E, -1, K).contiguous()
    if x3.data_ptr() % 16:            # the bf16 designs copy x in 16-byte pieces
        x3 = x3.clone()
    # every expert's q and scale start 16-byte aligned where N % 16 == 0,
    # which the bf16 designs need anyway (and so do x's rows, K % 64 == 0)
    aligned = q.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0
    variant = quant_matmul_variant(x.dtype, x3.shape[1], N, group, aligned)
    y = _launch_quant_matmul(x3, q.view(E, K, N), scale.view(E, K // group, N), group,
                             variant, tag)
    return y if experts else y[0].reshape(*x.shape[:-1], N)


def _launch_quant_matmul(x3, q, scale, group: int, variant: str, tag: str = ""):
    """Launch K2's ``variant`` on CUDA x3 [E, M, K] against q [E, K, N]
    and scale [E, K/g, N] (contiguous, 16-byte aligned rows), one launch
    for every expert (E = 1 for a dense linear), and count it as
    ``quant_matmul.<tag><variant>``.  The wrappers pick the variant by its
    rule; ``chip_smoke.py`` also times the FMA design on bf16 through
    here."""
    name = "quant_matmul"
    (E, M, K), N = x3.shape, q.shape[-1]
    y = torch.empty((E, M, N), dtype=x3.dtype, device=x3.device)
    if M == 0 or E == 0:
        return y
    design = _qm_design(variant, M)
    bm, bn, bk = _tiles(design, N)
    _require(variant == "fma" or group % bk == 0, name,
             f"group={group} is not a multiple of the {bk}-row stage of {variant}")
    (_, _, z), k_per_split = quant_matmul_plan(M, N, K, bm, bn, bk, E)
    splits = z // E
    partial = (torch.empty((E * splits, M, N), dtype=torch.float32, device=x3.device)
               if splits > 1 else None)
    vec = int(N % 16 == 0 and q.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0)
    err = _fn(name, "quant_matmul_launch")(
        x3.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
        None if partial is None else partial.data_ptr(), E, M, N, K, group,
        int(x3.dtype == torch.bfloat16), design, splits, k_per_split, vec, _stream())
    _check(err, name)
    launch_count[name] += 1
    variant_count[f"{name}.{tag}{variant}"] += 1
    _cost(name, 2.0 * E * M * N * K, _nbytes(x3, q, scale, y))
    return y


def quant_matmul_experts(x, q, scale, *, group: int, in_scale=None):
    """K2 over experts: x [E, C, K] @ bf16(q [E, K, N] int8 * scale
    [E, K/g, N]) -> [E, C, N] in x's dtype, every expert in one launch
    (the vmapped TPU kernel); ``in_scale`` [E, K] multiplies each
    expert's rows of x (in f32) first.  The design follows
    :func:`quant_matmul_variant` with M = C."""
    _require(q.dim() == 3 and q.dtype == torch.int8, "quant_matmul",
             "q must be [E, K, N] int8")
    return _quant_matmul(x, q, scale, group, in_scale, "expert_")


# ---------------------------------------------------------------------------
# K1: paged-KV decode attention
# ---------------------------------------------------------------------------

PA_HEAD_DIMS = (16, 32, 64, 112, 128, 256)
PA_MAX_PER = 256           # positions per split (paged_attention.cu's MAX_PER refuses more)
PA_BLOCKS_PER_SM = 8       # blocks per SM K1's split plan aims for
PA_SPLIT_MAX_G = 8         # query rows per KV head of the `split` design (its MAX_G)
PA_MMA_MAX_G = 64          # ... of the `mma` design (wide::MAX_G)
# K1's designs as the library numbers them
_PA_DESIGNS = {"split": 0, "mma": 1, "chunked": 2}


def paged_attention_variant(dtype: torch.dtype, G: int) -> str:
    """K1's design for ``G`` query rows per KV head in ``dtype``: ``split``
    for G <= PA_SPLIT_MAX_G in either dtype (the rows in registers, FMA
    pipes); ``mma`` for bf16 up to PA_MMA_MAX_G (the rows as tensor-core
    tiles); else ``chunked``, the split kernels over chunks of at most
    PA_SPLIT_MAX_G rows (:func:`paged_attention_chunk`), which keeps f32's
    exact products."""
    if G <= PA_SPLIT_MAX_G:
        return "split"
    return "mma" if dtype == torch.bfloat16 and G <= PA_MMA_MAX_G else "chunked"


def paged_attention_chunk(G: int) -> int:
    """Query rows per block of K1's ``chunked`` design: the largest divisor
    of G that the split kernels take (at most PA_SPLIT_MAX_G)."""
    return max(d for d in range(1, PA_SPLIT_MAX_G + 1) if G % d == 0)


def paged_attention_plan(S: int, Kh: int, T: int, window: int, bs: int, min_per: int = 0):
    """(splits, positions per split) of K1 for S slots, Kh KV heads and
    tables of T positions in pool blocks of ``bs``.  Planned from the span
    (T, or the window if smaller), never from the lengths, which live on
    the card: split z covers positions [lo + z per, lo + (z + 1) per) of a
    slot's live range [lo, len), lo = max(0, len - window), so ``splits``
    * ``per`` covers the span.  A split is a whole number of pool blocks,
    at most PA_MAX_PER positions, and S * Kh * splits aims at
    PA_BLOCKS_PER_SM blocks per SM when the span is long enough; a split
    takes at least ``min_per`` positions where PA_MAX_PER allows (the
    ``mma`` design asks for 2 G, so that a split's f32 partial is no
    larger than its bf16 V rows)."""
    span = min(T, window) if window else T
    want = math.ceil(PA_BLOCKS_PER_SM * _SMS / (S * Kh))
    blocks = max(1, math.ceil(math.ceil(span / bs) / want), math.ceil(min_per / bs))
    per = bs * min(blocks, PA_MAX_PER // bs)
    return math.ceil(span / per), per


def paged_attention(q, k_pool, v_pool, tables, lengths, *,
                    softcap: float = 0.0, window: int = 0):
    """Paged-KV decode attention.

    q [S, 1, H, D] (one decode token per slot), k/v pools
    [num_blocks, block_size, Kh, D], tables [S, T // block_size] block
    ids per slot, lengths [S] valid KV lengths (1 <= lengths <= T) ->
    [S, 1, H, D].

    On the card: D in PA_HEAD_DIMS, a block size of at most PA_MAX_PER,
    pools contiguous and 16-byte aligned, any G = H / Kh; the design
    follows :func:`paged_attention_variant`.
    """
    name = "paged_attention"
    S, one, H, D = q.shape
    _require(one == 1, name, f"q must be [S, 1, H, D], got {tuple(q.shape)}")
    _require(k_pool.dim() == 4 and k_pool.shape == v_pool.shape, name,
             "pools must be [num_blocks, block_size, Kh, D] and alike")
    nb, bs, Kh, Dp = k_pool.shape
    _require(Dp == D and H % Kh == 0, name, f"q {tuple(q.shape)} vs pool {tuple(k_pool.shape)}")
    _require(q.dtype in (torch.bfloat16, torch.float32)
             and k_pool.dtype == q.dtype and v_pool.dtype == q.dtype, name,
             "q and pools must share one dtype, bf16 or f32")
    _require(tables.dim() == 2 and tables.shape[0] == S and lengths.shape == (S,),
             name, "tables must be [S, nblk] and lengths [S]")
    G = H // Kh
    dev = _same_device(name, q, k_pool, v_pool, tables, lengths)
    # heads split as (Kh, G), the ordering the model's decode attention uses
    qr = q[:, 0].reshape(S, Kh, G, D)
    if dev.type == "cpu":
        out = ref.paged_attention(qr, k_pool, v_pool, tables, lengths,
                                  softcap=softcap, window=window)
        return out.reshape(S, 1, H, D)
    out = _launch_paged_attention(qr, k_pool, v_pool, tables, lengths, softcap, window,
                                  paged_attention_variant(q.dtype, G))
    return out.reshape(S, 1, H, D)


def _paged_attention_fn():
    """K1's launch entry point.  At first use it also checks that the
    library's row limits are PA_SPLIT_MAX_G and PA_MMA_MAX_G, which the
    wrapper then holds G to."""
    name = "paged_attention"
    if "paged_attention_launch" not in _FNS:
        limits = (_fn(name, "paged_attention_max_g")(), _fn(name, "paged_attention_mma_max_g")())
        if limits != (PA_SPLIT_MAX_G, PA_MMA_MAX_G):
            raise KernelError(f"{name}: the library's row limits {limits} are not "
                              f"{(PA_SPLIT_MAX_G, PA_MMA_MAX_G)}")
    return _fn(name, "paged_attention_launch")


def _launch_paged_attention(qr, k_pool, v_pool, tables, lengths, softcap: float,
                            window: int, variant: str):
    """Launch K1's ``variant`` on CUDA qr [S, Kh, G, D] and count it as
    ``paged_attention.<variant>``.  The wrapper picks the variant by its
    rule; ``chip_smoke.py`` also runs ``mma`` at G <= 8 through here, to
    hold it against ``split`` where the rule could pick either."""
    name = "paged_attention"
    S, Kh, G, D = qr.shape
    bs = k_pool.shape[1]
    _no_grad_inputs(name, qr, k_pool, v_pool)
    fn = _paged_attention_fn()
    _require(D in PA_HEAD_DIMS, name, f"head dim {D} is not one of {PA_HEAD_DIMS}")
    _require(bs <= PA_MAX_PER, name, f"block size {bs} is above {PA_MAX_PER}")
    _require(k_pool.is_contiguous() and v_pool.is_contiguous()
             and k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0, name,
             "pools must be contiguous and 16-byte aligned")
    limit = {"split": PA_SPLIT_MAX_G, "mma": PA_MMA_MAX_G}.get(variant, G)
    _require(G <= limit, name, f"G={G} is above the {limit} rows of the {variant} design")
    _require(variant != "mma" or qr.dtype == torch.bfloat16, name, "mma takes bf16 only")
    qr = qr.contiguous()
    if qr.data_ptr() % 16:
        qr = qr.clone()
    tbl = tables.to(torch.int32).contiguous()
    ln = lengths.to(torch.int32).contiguous()
    nblk = tbl.shape[1]
    chunks = G // paged_attention_chunk(G) if variant == "chunked" else 1
    splits, per = paged_attention_plan(S, Kh, nblk * bs, window, bs,
                                       2 * G if variant == "mma" else 0)
    work = torch.empty(_fn(name, "paged_attention_workspace")(S, Kh * chunks, G // chunks, D,
                                                              splits, per),
                       dtype=torch.uint8, device=qr.device)
    out = torch.empty_like(qr)
    err = fn(qr.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tbl.data_ptr(),
             ln.data_ptr(), work.data_ptr(), out.data_ptr(), S, Kh, G, D, bs, nblk,
             _f32_bits(1.0 / math.sqrt(D)), _f32_bits(softcap), int(window), splits, per,
             int(qr.dtype == torch.bfloat16), _PA_DESIGNS[variant], chunks, _stream())
    _check(err, name)
    launch_count[name] += 1
    variant_count[f"{name}.{variant}"] += 1
    # K/V over the span the plan covers: the lengths live on the card, and
    # reading them here would sync the step
    span = min(nblk * bs, splits * per)
    kv = 2 * S * span * Kh * D * k_pool.element_size()
    _cost(name, 4.0 * S * Kh * G * span * D, kv + _nbytes(qr, tbl, ln, out))
    return out


# ---------------------------------------------------------------------------
# K4: block-sparse matmul
# ---------------------------------------------------------------------------

BLOCK_SIZES = (16, 32, 64, 128)


def block_sparse_variant(dtype: torch.dtype, M: int) -> str:
    """K4's design for x of ``dtype`` with ``M`` rows: ``fma`` for f32
    (exact f32 products), ``decode`` for bf16 with M <= DECODE_M (the
    weight stream on tensor cores), ``mma`` for taller bf16 x (column
    groups on tensor cores)."""
    if dtype == torch.float32:
        return "fma"
    return "decode" if M <= DECODE_M else "mma"


def block_sparse_plan(M: int, N: int, K: int, bs: int, keep: int, bm: int, bn: int):
    """(grid, input blocks per split) of K4 for a ``bm`` x ``bn`` output
    tile.  A tile of one block column walks its ``keep`` kept tiles; a
    column group walks the input blocks any of its ``bn // bs`` columns
    keeps, at most ``K // bs``.  The walk is split so that the grid
    reaches about two blocks per SM."""
    steps = min(K // bs, (bn // bs) * keep)
    cols, rows = math.ceil(N / bn), math.ceil(M / bm)
    splits, per = _split(cols * rows, steps)
    return (cols, rows, splits), per


def group_schedule(idx, n_in_blocks: int, cols: int):
    """What K4's ``mma`` design builds in shared memory for each group of
    ``cols`` adjacent output block columns: int32 [groups, n_in_blocks],
    bit c of [g, i] set where column g * cols + c keeps input block i.
    Its set bits are the kept (block, column) pairs of ``idx``."""
    mask = ref.block_mask_from_idx(idx, n_in_blocks).T.to(torch.int32)   # [N/bs, K/bs]
    pad = -mask.shape[0] % cols
    mask = torch.cat([mask, mask.new_zeros((pad, n_in_blocks))]).reshape(-1, cols,
                                                                          n_in_blocks)
    weights = (1 << torch.arange(cols, dtype=torch.int32, device=mask.device))[:, None]
    return (mask * weights).sum(1, dtype=torch.int32)


_BS_TILES: Dict[tuple, tuple] = {}


def _bs_tiles(bf16: int, small: int, bs: int) -> tuple:
    """(rows, columns) of the output tile of K4's design, from the library."""
    key = (bf16, small, bs)
    if key not in _BS_TILES:
        _BS_TILES[key] = (_fn("block_sparse", "block_sparse_tile_m")(bf16, small),
                          _fn("block_sparse", "block_sparse_tile_n")(bf16, small, bs))
    return _BS_TILES[key]


def block_sparse_matmul(x, w, idx, *, bs: int):
    """x [..., K] @ w [K, N] (bf16, zero-filled) reading only the bs x bs
    blocks listed in ``idx`` [N/bs, keep] (entries in [0, K/bs)) ->
    [..., N] in x's dtype, summed in f32."""
    name = "block_sparse_matmul"
    _require(bs in BLOCK_SIZES, name, f"bs must be one of {BLOCK_SIZES}, got {bs}")
    _require(w.dim() == 2 and w.dtype == torch.bfloat16, name, "w must be [K, N] bf16")
    K, N = w.shape
    _require(K % bs == 0 and N % bs == 0, name, f"bs={bs} must divide K={K} and N={N}")
    _require(idx.dim() == 2 and idx.shape[0] == N // bs and 1 <= idx.shape[1] <= K // bs
             and not idx.is_floating_point(), name,
             f"idx must be integer [{N // bs}, keep <= {K // bs}], got {tuple(idx.shape)}")
    _require(x.shape[-1] == K, name, f"x [..., {x.shape[-1]}] does not match K={K}")
    _require(x.dtype in (torch.bfloat16, torch.float32), name,
             f"x must be bf16 or f32, got {x.dtype}")
    dev = _same_device(name, x, w, idx)
    if dev.type == "cpu":
        return ref.block_sparse_matmul(x, w, idx, bs=bs)
    _no_grad_inputs(name, x, w)
    _require(w.is_contiguous() and w.data_ptr() % 16 == 0, name,
             "w must be contiguous and 16-byte aligned")
    keep = idx.shape[1]
    x2 = x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16:            # the bf16 designs copy x in 16-byte pieces
        x2 = x2.clone()
    ix = idx.to(torch.int32).contiguous()
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0:
        return y.reshape(*x.shape[:-1], N)
    variant = block_sparse_variant(x.dtype, M)
    bf16, small = int(x.dtype == torch.bfloat16), int(M <= DECODE_M)
    fn = _fn("block_sparse", "block_sparse_launch")
    (_, _, splits), per = block_sparse_plan(M, N, K, bs, keep, *_bs_tiles(bf16, small, bs))
    partial = (torch.empty((splits, M, N), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    err = fn(x2.data_ptr(), w.data_ptr(), ix.data_ptr(), y.data_ptr(),
             None if partial is None else partial.data_ptr(), M, N, K, bs, keep,
             bf16, small, splits, per, _stream())
    _check(err, name)
    launch_count[name] += 1
    variant_count[f"{name}.{variant}"] += 1
    kept = ix.numel() * bs * bs                 # weight elements in kept tiles
    _cost(name, 2.0 * M * kept, kept * w.element_size() + _nbytes(x2, ix, y))
    return y.reshape(*x.shape[:-1], N)


# ---------------------------------------------------------------------------
# K3: flash attention
# ---------------------------------------------------------------------------

HEAD_DIMS = (32, 64, 112, 128, 256)


def flash_variant(dtype: torch.dtype) -> str:
    """K3's design: ``mma`` (tensor cores) for bf16, ``fma`` (exact f32
    products) for f32."""
    return "fma" if dtype == torch.float32 else "mma"


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0, t_real: int = 0):
    """q [B, S, H, D], k/v [B, T, Kh, D] -> [B, S, H, D] (GQA: query head
    h reads KV head h // (H/Kh)).  ``q_offset`` is the position of query
    row 0; keys at or past ``t_real`` (default T) are masked."""
    name = "flash_attention"
    _require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape, name,
             "q must be [B, S, H, D] and k, v alike [B, T, Kh, D]")
    B, S, H, D = q.shape
    _, T, Kh, Dk = k.shape
    _require(k.shape[0] == B and Dk == D and H % Kh == 0, name,
             f"q {tuple(q.shape)} vs k/v {tuple(k.shape)}")
    _require(q.dtype in (torch.bfloat16, torch.float32)
             and k.dtype == q.dtype and v.dtype == q.dtype, name,
             "q, k and v must share one dtype, bf16 or f32")
    t_real = int(t_real) or T
    _require(1 <= t_real <= T and q_offset >= 0 and window >= 0, name,
             f"t_real={t_real}, q_offset={q_offset}, window={window} out of range")
    dev = _same_device(name, q, k, v)
    if dev.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, t_real=t_real, q_offset=q_offset)
    _no_grad_inputs(name, q, k, v)
    _require(D in HEAD_DIMS, name, f"head dim {D} is not one of {HEAD_DIMS}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)), name,
             "q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _fn(name, "flash_attention_launch")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T, H, Kh, D,
             t_real, int(q_offset), int(window), int(causal),
             _f32_bits(1.0 / math.sqrt(D)), _f32_bits(softcap),
             int(q.dtype == torch.bfloat16), _stream())
    _check(err, name)
    launch_count[name] += 1
    variant_count[f"{name}.{flash_variant(q.dtype)}"] += 1
    keys = flash_keys(S, t_real, q_offset, window, causal)
    _cost(name, 4.0 * B * H * keys * D, _nbytes(q, k, v, out))
    return out


def flash_keys(S: int, t_real: int, q_offset: int, window: int, causal: bool) -> int:
    """Key positions K3's S query rows attend in all (row i at position
    q_offset + i sees keys up to it when causal, the last ``window`` of
    them when windowed, none at or past ``t_real``)."""
    total = 0
    for i in range(S):
        hi = min(t_real, q_offset + i + 1) if causal else t_real
        lo = max(0, q_offset + i + 1 - window) if window else 0
        total += max(0, hi - lo)
    return total
