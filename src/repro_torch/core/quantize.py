"""Weight quantization: absmax round-to-nearest, plus SmoothQuant scales.

Functions take and return tensors on any device (the full-width model is
quantized where it lives, on the card).  ``torch.round`` rounds half to
even like ``np.rint``, so codes and scales equal the reference's bit for
bit.  GPTQ waits for the calibration slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.compressed import QTensor, pack_int4


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
