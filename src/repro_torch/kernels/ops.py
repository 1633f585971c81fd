"""Public wrappers of the hand-written CUDA kernels.

Shape plumbing lives here: flattening leading dims, the ``(Kh, G)`` head
split, int32 tables and lengths, the K split of the int8 matmul.  Each
wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take.  For tensors on the CPU it computes the
kernel's plain version (``kernels/ref.py``); for CUDA tensors it
launches the kernel on the current stream, adds one to
``launch_count[name]`` and raises if the launch fails.  It never
falls back from a CUDA tensor to the plain version.
"""
from __future__ import annotations

import ctypes
import math
import struct
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

# launches per kernel since the last reset_launch_counts()
launch_count: Dict[str, int] = {name: 0 for name in build.KERNELS}

_SMS = 132                 # H100 SXM streaming multiprocessors
_SIGS: Dict[str, list] = {
    "quant_matmul_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
    "paged_attention_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
    + [ctypes.c_void_p],
    "paged_attention_max_g": [],
    **{f"quant_matmul_tile_{d}": [ctypes.c_int] for d in "mnk"},
}


def reset_launch_counts() -> None:
    for name in launch_count:
        launch_count[name] = 0


_FNS: Dict[str, object] = {}


def _fn(kernel: str, symbol: str):
    """The C entry point ``symbol`` of kernel ``kernel`` (built and bound
    at first use)."""
    fn = _FNS.get(symbol)
    if fn is None:
        fn = getattr(build.load(kernel), symbol)
        fn.argtypes = _SIGS[symbol]
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _f32_bits(v: float) -> int:
    return struct.unpack("<i", struct.pack("<f", float(v)))[0]


def _same_device(name: str, *tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    return dev


def _require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# K2: int8 group-quantized matmul
# ---------------------------------------------------------------------------

_TILES: Dict[int, tuple] = {}


def _tiles(small: int) -> tuple:
    """(BM, BN, BK) of the int8 kernel's skinny (decode) or square tile."""
    if small not in _TILES:
        _TILES[small] = tuple(_fn("quant_matmul", f"quant_matmul_tile_{d}")(small)
                              for d in "mnk")
    return _TILES[small]


def quant_matmul(x, q, scale, *, group: int, in_scale=None, bits: int = 8):
    """x [..., K] @ bf16(q [K, N] int8 * scale [K/g, N]) -> [..., N] in
    x's dtype; ``in_scale`` [K] multiplies x (in f32) first."""
    name = "quant_matmul"
    _require(bits == 8, name, f"only int8 codes are supported, got bits={bits}")
    _require(q.dim() == 2 and q.dtype == torch.int8, name, "q must be [K, N] int8")
    K, N = q.shape
    _require(K % group == 0, name, f"K={K} is not divisible by group={group}")
    _require(scale.shape == (K // group, N) and scale.dtype == torch.float32,
             name, f"scale must be f32 [{K // group}, {N}], got {tuple(scale.shape)}")
    _require(x.shape[-1] == K, name, f"x [..., {x.shape[-1]}] does not match K={K}")
    _require(x.dtype in (torch.bfloat16, torch.float32), name,
             f"x must be bf16 or f32, got {x.dtype}")
    _require(in_scale is None or (in_scale.shape == (K,)
                                  and in_scale.dtype == torch.float32),
             name, "in_scale must be f32 [K]")
    dev = _same_device(name, x, q, scale, in_scale)
    if dev.type == "cpu":
        return ref.quant_matmul(x, q, scale, group=group, in_scale=in_scale)
    _require(q.is_contiguous() and scale.is_contiguous(), name,
             "q and scale must be contiguous")
    if in_scale is not None:
        x = (x.float() * in_scale).to(x.dtype)
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0:
        return y.reshape(*x.shape[:-1], N)
    small = int(M <= 16)
    fn = _fn(name, "quant_matmul_launch")
    bm, bn, bk = _tiles(small)
    blocks = math.ceil(M / bm) * math.ceil(N / bn)
    ksteps = math.ceil(K / bk)
    splits = min(ksteps, max(1, math.ceil(2 * _SMS / blocks)))
    k_per_split = math.ceil(ksteps / splits) * bk
    splits = math.ceil(K / k_per_split)
    partial = (torch.empty((splits, M, N), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    vec = int(N % 16 == 0 and q.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0)
    err = fn(x2.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
             None if partial is None else partial.data_ptr(), M, N, K, group,
             int(x.dtype == torch.bfloat16), small, splits, k_per_split, vec,
             _stream())
    _check(err, name)
    launch_count[name] += 1
    return y.reshape(*x.shape[:-1], N)


# ---------------------------------------------------------------------------
# K1: paged-KV decode attention
# ---------------------------------------------------------------------------

def paged_attention(q, k_pool, v_pool, tables, lengths, *,
                    softcap: float = 0.0, window: int = 0):
    """Paged-KV decode attention.

    q [S, 1, H, D] (one decode token per slot), k/v pools
    [num_blocks, block_size, Kh, D], tables [S, T // block_size] block
    ids per slot, lengths [S] valid KV lengths (>= 1) -> [S, 1, H, D].
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
    fn = _fn(name, "paged_attention_launch")
    _require(G <= _fn(name, "paged_attention_max_g")(), name, f"G={G} is too large")
    _require(k_pool.is_contiguous() and v_pool.is_contiguous(), name,
             "pools must be contiguous")
    qr = qr.contiguous()
    tbl = tables.to(torch.int32).contiguous()
    ln = lengths.to(torch.int32).contiguous()
    nblk = tbl.shape[1]
    T = nblk * bs
    span = min(T, window) if window else T
    out = torch.empty_like(qr)
    err = fn(qr.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tbl.data_ptr(),
             ln.data_ptr(), out.data_ptr(), S, Kh, G, D, bs, nblk,
             _f32_bits(1.0 / math.sqrt(D)), _f32_bits(softcap), int(window), span,
             int(q.dtype == torch.bfloat16), _stream())
    _check(err, name)
    launch_count[name] += 1
    return out.reshape(S, 1, H, D)
