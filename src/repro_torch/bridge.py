"""Turn the reference's param tree into the port's.

``from_reference(tree, cfg, device)`` walks the reference's pytree of
dicts and lists.  Its leaves are arrays (anything ``np.asarray`` accepts),
quantized weights (any object with ``q/scale/bits/group/shape/in_scale``
attributes), block-sparse weights (``w/mask/bs/idx``) or int8 embedding tables
(``q/scale`` without ``bits``: a ``QEmbed``), so the bridge
needs no JAX.  A block-sparse leaf whose ``idx`` is None (the reference
drops it when it stacks layers) gets its indices rebuilt from ``mask``,
per layer.  bf16 arrays arrive
as ``ml_dtypes.bfloat16`` numpy arrays, which ``torch.from_numpy``
rejects; they cross through a ``uint16`` view of their bits.  The
stacked layer axis of ``blocks`` is kept as is, and so is an MoE block's
expert axis: the f32 router [R, d, E], bf16 expert stacks [R, E, d, f]
and expert-stacked quantized weights (``q`` [R, E, K, N], ``scale``
[R, E, K/g, N], ``in_scale`` [R, E, K]) cross as any other leaf, as do
the hybrid's Mamba groups ([G, K, ...] leaves, quantized ones too) and
its ``mamba_tail``, ``None`` when the config has no tail layer, and
rwkv's one layer stack (``blocks`` [32, ...] at full width: its f32
``tm.w0`` and ``tm.u`` stay f32, its quantized ``q`` [32, K, N] as they
are), a vlm's tree as a dense one's, and encdec's unrolled lists
(``enc_blocks`` and ``dec_blocks``, one dict a layer, quantized leaves
[K, N] without a layer axis), its ``pos_enc``/``pos_dec`` tables and its
untied ``unembed``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.compressed import BlockSparseTensor, QEmbed, QTensor, check_idx
from repro_torch.kernels.backend import resolve_device


def to_tensor(a, device="cuda") -> torch.Tensor:
    """One array leaf as a torch tensor on ``device`` (bf16 kept bf16)."""
    a = np.array(a, order="C")          # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def from_reference(tree, cfg=None, device="cuda"):
    """The port's param tree for the reference's ``tree`` on ``device``."""
    if isinstance(tree, dict):
        return {k: from_reference(v, cfg, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_reference(v, cfg, device) for v in tree]
    if tree is None:
        return None
    if hasattr(tree, "q") and hasattr(tree, "scale") and hasattr(tree, "bits"):
        return QTensor(to_tensor(tree.q, device), to_tensor(tree.scale, device),
                       tree.bits, tree.group, tree.shape,
                       None if tree.in_scale is None
                       else to_tensor(tree.in_scale, device))
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return QEmbed(to_tensor(tree.q, device), to_tensor(tree.scale, device))
    if hasattr(tree, "mask") and hasattr(tree, "bs"):
        w = to_tensor(tree.w, device)
        return BlockSparseTensor(w, to_tensor(tree.mask, device), tree.bs,
                                 None if tree.idx is None else
                                 check_idx(to_tensor(tree.idx, device), w.shape, tree.bs))
    return to_tensor(tree, device)


__all__ = ["from_reference", "to_tensor"]
