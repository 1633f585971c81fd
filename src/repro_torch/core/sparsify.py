"""Sparsification: Wanda and SparseGPT one-shot pruning, and block sparsity.

Layout convention: weights are ``[d_in, d_out]``, the reduction (input)
dimension is axis 0, so N:M patterns group along axis 0 and per-output
pruning ranks down columns.

``block_sparse_mask`` prunes whole ``bs x bs`` blocks that the
block-sparse CUDA kernel skips; N:M and unstructured masks only shrink
the stored model (they compose with int8/int4 codes).

Selection (Wanda scores, block scores, the ranking and the tie rule)
runs on the host in numpy in float32, as the reference does, so masks
are bit-equal to the reference's for the same weights and norms.
SparseGPT's error propagation runs in float64 torch on the weight's
device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.compressed import BlockSparseTensor
from repro_torch.core.quantize import BLOCKSIZE, PERCDAMP


def _host(a) -> np.ndarray:
    """float32 numpy copy of a tensor (or array) on any device."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def wanda_mask(w, act_norm, *, sparsity: float = 0.0, n: int = 0,
               m: int = 0) -> torch.Tensor:
    """Wanda importance |W| * ||x||: bool keep-mask [d_in, d_out] on w's
    device.  ``n, m``: N:M structured (keep n of every m along the input
    dim); otherwise unstructured at ``sparsity`` per output column."""
    wn = _host(w)
    score = np.abs(wn) * _host(act_norm)[:, None]
    d_in, d_out = wn.shape
    if m:
        assert d_in % m == 0, (d_in, m)
        sg = score.reshape(d_in // m, m, d_out)
        rank = np.argsort(np.argsort(sg, axis=1), axis=1)
        keep = (rank >= m - n).reshape(d_in, d_out)
    else:
        k = int(round(sparsity * d_in))
        if k <= 0:
            keep = np.ones_like(wn, bool)
        else:
            kth = np.partition(score, k - 1, axis=0)[k - 1]
            keep = score > kth[None, :]
    return torch.from_numpy(keep).to(w.device)


def sparsegpt_prune(w, H, *, sparsity: float = 0.0, n: int = 0,
                    m: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """SparseGPT one-shot pruning with error propagation.

    Returns (pruned f32 weight, bool keep-mask), both on w's device.
    Importance within each column block is  w^2 / diag(cholesky(H^-1))^2;
    the pruned entries' error is pushed onto not-yet-processed input dims
    exactly like GPTQ.
    """
    dev = w.device
    w = w.detach().to(torch.float64).clone()
    H = H.to(dev, torch.float64).clone()
    d_in, d_out = w.shape
    dead = torch.nonzero(torch.diagonal(H) <= 0)[:, 0]
    H[dead, dead] = 1.0
    w[dead] = 0.0
    H.diagonal().add_(PERCDAMP * torch.diagonal(H).mean())
    U = torch.linalg.cholesky(torch.linalg.inv(H)).T

    mask = torch.ones((d_in, d_out), dtype=torch.bool, device=dev)
    blocksize = max(BLOCKSIZE - BLOCKSIZE % m, m) if m else BLOCKSIZE
    for bs in range(0, d_in, blocksize):
        be = min(bs + blocksize, d_in)
        diag = torch.diagonal(U)[bs:be]
        score = w[bs:be] ** 2 / diag[:, None] ** 2
        if m:
            nb = (be - bs) // m
            sg = score[: nb * m].reshape(nb, m, d_out)
            rank = torch.argsort(torch.argsort(sg, dim=1), dim=1)
            mask[bs:bs + nb * m] = (rank >= m - n).reshape(nb * m, d_out)
        else:
            k = int(round(sparsity * (be - bs)))
            if k > 0:
                kth = torch.kthvalue(score, k, dim=0).values
                mask[bs:be] = score > kth[None, :]
        Werr = torch.zeros((be - bs, d_out), dtype=torch.float64, device=dev)
        for j in range(bs, be):
            wj = torch.where(mask[j], w[j], torch.zeros((), dtype=w.dtype, device=dev))
            err = (w[j] - wj) / U[j, j]
            w[j] = wj
            w[j + 1:be] -= torch.outer(U[j, j + 1:be], err)
            Werr[j - bs] = err
        if be < d_in:
            w[be:] -= U[bs:be, be:].T @ Werr
    return w.to(torch.float32), mask


def block_scores(w, act_norm, bs: int) -> np.ndarray:
    """Importance of each bs x bs block: sum |W| * ||x|| within the block
    (host float32) -> [d_in/bs, d_out/bs]."""
    wn = _host(w)
    d_in, d_out = wn.shape
    s = np.abs(wn)
    if act_norm is not None:
        s = s * _host(act_norm)[:, None]
    nb_i, nb_o = d_in // bs, d_out // bs
    return s[: nb_i * bs, : nb_o * bs].reshape(nb_i, bs, nb_o, bs).sum((1, 3))


def block_sparse_mask(w, *, bs: int, density: float,
                      act_norm=None) -> np.ndarray:
    """Keep-mask over blocks [d_in/bs, d_out/bs] at the target density,
    chosen per block column so every output tile keeps the same number of
    input blocks (the kernel's uniform gather length)."""
    sc = block_scores(w, act_norm, bs)
    nb_i, nb_o = sc.shape
    keep = max(1, int(round(density * nb_i)))
    kth = np.partition(-sc, keep - 1, axis=0)[keep - 1]
    mask = (-sc) <= kth[None, :]
    # exactly `keep` per column: ties go to the lower block row
    for c in np.nonzero(mask.sum(0) != keep)[0]:
        order = np.argsort(-sc[:, c], kind="stable")
        mask[:, c] = False
        mask[order[:keep], c] = True
    return mask


def expand_block_mask(mask, bs: int, device) -> torch.Tensor:
    """Block mask [nb_i, nb_o] -> bool element mask [nb_i*bs, nb_o*bs]."""
    m = torch.as_tensor(np.asarray(mask), device=device).bool()
    return m.repeat_interleave(bs, 0).repeat_interleave(bs, 1)


def apply_block_mask(w, mask: np.ndarray, bs: int) -> BlockSparseTensor:
    """Zero the pruned blocks and wrap as a BlockSparseTensor on w's
    device (bf16 weight, with the kernel's gather indices)."""
    keep = int(mask[:, 0].sum())
    assert (mask.sum(0) == keep).all(), "non-uniform block column density"
    wz = w.float() * expand_block_mask(mask, bs, w.device)
    return BlockSparseTensor(wz.to(torch.bfloat16),
                             torch.as_tensor(mask.astype(np.float32), device=w.device),
                             bs)


def density(mask) -> float:
    if isinstance(mask, torch.Tensor):
        return float(mask.float().mean().item())
    return float(np.mean(mask))
