"""Weight quantization: absmax round-to-nearest and GPTQ, plus SmoothQuant.

Functions take and return tensors on any device (the full-width model is
quantized where it lives, on the card).  ``torch.round`` rounds half to
even like ``np.rint``, so absmax codes and scales equal the reference's
bit for bit.

GPTQ [Frantar et al.]: quantize weight rows (input dims) one at a time in
Cholesky order of the inverse input Hessian H = X^T X, pushing the
rounding error onto the rows not yet quantized; it runs in float64, as
the reference's numpy does.  SmoothQuant [Xiao et al.]: the per-channel
scale s_j = amax_x(j)^alpha / amax_w(j)^(1-alpha) migrates activation
outliers into the weights before quantization; the inverse scale rides
in ``QTensor.in_scale``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.compressed import QTensor, pack_int4

PERCDAMP = 0.01      # GPTQ / SparseGPT: damping added to diag(H), times its mean
BLOCKSIZE = 128      # GPTQ / SparseGPT: input rows per error-propagation block


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1          # 127 for int8, 7 for int4


def _round_clip(w: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    q = torch.round(w / torch.clamp(scale, min=1e-12))
    return torch.clamp(q, -_qmax(bits) - 1, _qmax(bits))


def group_scales(w: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """absmax scale per (input group, output channel): [d_in/g, d_out]."""
    d_in, d_out = w.shape
    wg = w.reshape(d_in // group, group, d_out)
    return wg.abs().amax(1) / _qmax(bits) + 1e-12


def choose_group(d_in: int, group: int) -> int:
    """Largest divisor of d_in that is <= requested group size."""
    g = min(group, d_in)
    while d_in % g:
        g -= 1
    return g


def smooth_scales(amax_x: torch.Tensor, w: torch.Tensor,
                  alpha: float = 0.5) -> torch.Tensor:
    """SmoothQuant per-input-channel migration scale s (apply w*s, x/s)."""
    amax_w = w.abs().amax(1) + 1e-9
    ax = torch.clamp(amax_x, min=1e-9)
    s = ax ** alpha / amax_w ** (1.0 - alpha)
    s = s / torch.exp(torch.mean(torch.log(s)))
    return torch.clamp(s, 1e-3, 1e3)


def absmax_quantize(w: torch.Tensor, *, bits: int = 8, group: int = 128,
                    amax_x: Optional[torch.Tensor] = None,
                    smooth_alpha: float = 0.0) -> QTensor:
    """Round-to-nearest group-wise quantization (the non-calibrated path)."""
    w = w.float()
    in_scale = None
    if smooth_alpha and amax_x is not None:
        s = smooth_scales(amax_x.to(w.device, torch.float32), w, smooth_alpha)
        w = w * s[:, None]
        in_scale = 1.0 / s
    g = choose_group(w.shape[0], group)
    scale = group_scales(w, bits, g)
    codes = _round_clip(w.reshape(w.shape[0] // g, g, -1),
                        scale[:, None, :], bits).reshape(w.shape).to(torch.int8)
    q = pack_int4(codes) if bits == 4 else codes
    return QTensor(q, scale, bits, g, tuple(w.shape), in_scale)


def gptq_quantize(w: torch.Tensor, H: torch.Tensor, *, bits: int = 8,
                  group: int = 128, amax_x: Optional[torch.Tensor] = None,
                  smooth_alpha: float = 0.0,
                  mask: Optional[torch.Tensor] = None) -> QTensor:
    """GPTQ quantization of ``w [d_in, d_out]`` with input Hessian ``H``.

    ``mask`` (optional, [d_in, d_out] bool, True = keep): a sparsity
    pattern to respect; masked-out entries are forced to code 0 and their
    error is propagated like any rounding error (the SparseGPT +
    quantization composition the paper uses).
    """
    dev = w.device
    w = w.detach().to(torch.float64).clone()
    H = H.to(dev, torch.float64).clone()
    d_in, d_out = w.shape
    in_scale = None
    if smooth_alpha and amax_x is not None:
        s = smooth_scales(amax_x.to(dev, torch.float32), w.float(), smooth_alpha)
        sd = s.double()
        w = w * sd[:, None]
        H = H / sd[:, None] / sd[None, :]       # H of the scaled inputs x/s
        in_scale = 1.0 / s
    g = choose_group(d_in, group)

    dead = torch.nonzero(torch.diagonal(H) <= 0)[:, 0]
    H[dead, dead] = 1.0
    w[dead] = 0.0
    H.diagonal().add_(PERCDAMP * torch.diagonal(H).mean())
    U = torch.linalg.cholesky(torch.linalg.inv(H)).T     # upper Cholesky of H^-1

    codes = torch.zeros_like(w)
    scales = torch.zeros((d_in // g, d_out), dtype=torch.float64, device=dev)
    keep = None if mask is None else mask.to(dev).bool()
    for bs in range(0, d_in, BLOCKSIZE):
        be = min(bs + BLOCKSIZE, d_in)
        Werr = torch.zeros((be - bs, d_out), dtype=torch.float64, device=dev)
        for j in range(bs, be):
            if j % g == 0:
                # group scale from the current (error-compensated) rows
                scales[j // g] = w[j:j + g].abs().amax(0) / _qmax(bits) + 1e-12
            sc = scales[j // g]
            q = _round_clip(w[j], sc, bits)
            if keep is not None:
                q = torch.where(keep[j], q, torch.zeros((), dtype=q.dtype, device=dev))
            codes[j] = q
            err = (w[j] - q * sc) / U[j, j]
            w[j + 1:be] -= torch.outer(U[j, j + 1:be], err)
            Werr[j - bs] = err
        if be < d_in:
            w[be:] -= U[bs:be, be:].T @ Werr
    c8 = codes.to(torch.int8)
    return QTensor(pack_int4(c8) if bits == 4 else c8, scales.to(torch.float32), bits,
                   g, (d_in, d_out), in_scale)


def quant_error(w: torch.Tensor, qt: QTensor,
                H: Optional[torch.Tensor] = None) -> float:
    """||W - W_hat||_F, or sqrt(tr(E^T H E)), the proxy GPTQ minimizes."""
    e = w.float() - qt.dequantize().float()
    if H is None:
        return float(torch.linalg.norm(e).item())
    e = e.double()
    return float(torch.sqrt(torch.clamp(
        torch.einsum("io,ij,jo->", e, H.to(e.device, torch.float64), e), min=0.0)).item())
