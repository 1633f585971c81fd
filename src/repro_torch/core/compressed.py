"""Compressed-parameter containers and the universal matmul dispatch.

The instance-optimization pipeline rewrites selected weight matrices of
a model's param tree into :class:`QTensor` (group-wise quantized,
optionally with SmoothQuant input scales).  Every linear layer in
``repro_torch.models`` calls :func:`matmul`, which dispatches on the
container type, so compression is transparent to the model code.

The plain formula here is the portable path and the oracle; the int8
CUDA kernel (``kernels/ops.py``) takes over when the scoped
:func:`kernel_backend` resolves to ``"cuda"`` for the input's device.
``QEmbed``, ``BlockSparseTensor``, ``expert_matmul`` and the
calibration record/route hooks are not ported yet.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.backend import normalize_backend, resolve_backend

_BACKEND: contextvars.ContextVar = contextvars.ContextVar(
    "kernel_backend", default=None)


@contextlib.contextmanager
def kernel_backend(backend):
    """Scope a KernelBackend over a block of compute (engines wrap every
    tick in this, so the dispatch below picks the engine's backend and
    no global state survives the ``with`` block)."""
    token = _BACKEND.set(normalize_backend(backend))
    try:
        yield
    finally:
        _BACKEND.reset(token)


def current_backend(device="cuda") -> str:
    """The backend in effect for tensors on ``device``: ``"reference"``
    or ``"cuda"``."""
    b = _BACKEND.get()
    return resolve_backend(b if b is not None else "auto", device)


class QTensor:
    """Group-wise quantized weight matrix ``[d_in, d_out]``.

    q         int8 codes ``[d_in, d_out]`` (int4: packed two-per-byte along
              d_in -> ``[d_in // 2, d_out]`` uint8)
    scale     f32 per-(group, out-channel) scales ``[d_in // group, d_out]``
    in_scale  optional f32 ``[d_in]`` SmoothQuant per-channel input scale
              (x is multiplied by it before the quantized matmul; the
              inverse was folded into the stored codes at quantization)
    bits      4 or 8

    Tensors may carry a leading layer axis when stacked; methods are only
    invoked on per-layer slices (:meth:`layer`).
    """

    def __init__(self, q, scale, bits: int, group: int, shape, in_scale=None):
        self.q = q
        self.scale = scale
        self.in_scale = in_scale
        self.bits = int(bits)
        self.group = int(group)
        self.shape = tuple(shape)

    @property
    def dtype(self):
        return torch.bfloat16

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nbytes(self) -> int:
        """Stored bytes, computed from the actual tensors (stacked-safe)."""
        b = self.q.numel() * self.q.element_size()
        b += self.scale.numel() * self.scale.element_size()
        if self.in_scale is not None:
            b += self.in_scale.numel() * self.in_scale.element_size()
        return int(b)

    def layer(self, r: int) -> "QTensor":
        """The ``r``-th matrix of a layer-stacked QTensor."""
        return QTensor(self.q[r], self.scale[r], self.bits, self.group,
                       self.shape[-2:],
                       None if self.in_scale is None else self.in_scale[r])

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device), self.bits,
                       self.group, self.shape,
                       None if self.in_scale is None else self.in_scale.to(device))

    def unpack(self) -> torch.Tensor:
        """int8 logical codes [d_in, d_out] (unpacks int4)."""
        if self.bits == 8:
            return self.q
        u = self.q
        lo = (u & 0xF).to(torch.int8)
        hi = (u >> 4).to(torch.int8)
        lo = torch.where(lo >= 8, lo - 16, lo)
        hi = torch.where(hi >= 8, hi - 16, hi)
        return torch.stack([lo, hi], dim=1).reshape(self.shape[-2], self.shape[-1])

    def dequantize(self) -> torch.Tensor:
        """Dense bf16 reconstruction of the weight (folds in_scale back)."""
        g = self.group
        d_in, d_out = self.shape[-2], self.shape[-1]
        w = self.unpack().float().reshape(d_in // g, g, d_out) * self.scale[:, None, :]
        w = w.reshape(d_in, d_out)
        if self.in_scale is not None:
            w = w * self.in_scale[:, None]
        return w.to(torch.bfloat16)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7], even first dim -> packed uint8 pairs."""
    lo = (codes[0::2].to(torch.int16) & 0xF).to(torch.uint8)
    hi = (codes[1::2].to(torch.int16) & 0xF).to(torch.uint8)
    return lo | (hi << 4)


def param_bytes(tree) -> int:
    """Total stored bytes of a (possibly compressed) param tree."""
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_bytes(v) for v in tree)
    if isinstance(tree, QTensor):
        return tree.nbytes
    return int(tree.numel() * tree.element_size())


def _q_matmul_plain(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """``(x * in_scale) @ bf16(codes * scale)``: the kernel's semantics.
    (The reference's jnp path folds ``in_scale`` into the weight *and*
    scales x by it; the port applies it once.)"""
    return kref.quant_matmul(x, w.unpack(), w.scale, group=w.group,
                             in_scale=w.in_scale)


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """Universal ``x @ w`` over raw / quantized weights."""
    if isinstance(w, QTensor):
        if w.bits == 8 and current_backend(x.device) == "cuda":
            return kops.quant_matmul(x, w.q, w.scale, group=w.group,
                                     in_scale=w.in_scale)
        return _q_matmul_plain(x, w)
    return torch.matmul(x, w.to(x.dtype))
